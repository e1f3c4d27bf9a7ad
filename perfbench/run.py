#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration and a traffic mix; the seed makes the inputs (the
scenes' keys, the actions, the samples the comparison takes). Set-up
builds and warms up the program; the window then drives it for `--seconds`
seconds. With `--trace 0` the result holds the cell's end-to-end metrics;
with `--trace 1` a bounded slice of calls follows the window under
torch.profiler, and the result holds its per-layer metrics, the device's
busy seconds and a breakdown. Every run compares what the timed path produced with the
plain reference (`perfbench/check.py`).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and `breakdown` when traced),
and last `checks`, each compared number with its limit; the last lines of
standard error give the same numbers. Earlier lines: the cell and seed;
the card's name and power limit, the set-up's stages, the window's counts,
re-runs of rejection, the dm_env stand-in. Exits 2 without a result where
no CUDA card (or too few) is found, 3 where a JAX module was loaded.
"""

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (0 where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The checkout's root, not this directory, leads the import path. The
# program's one build cache, spriteworld_torch/build/, is inside it.
sys.path[0] = str(ROOT)
# Python's compiled bytecode, cached at a fixed path inside the checkout.
# Where the environment forbids writing it (PYTHONDONTWRITEBYTECODE) and
# the installed torch ships none, every run compiled torch's sources
# again: some 7 s of CPU, most of set-up.
sys.pycache_prefix = str(ROOT / "perfbench" / "out" / "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def _card() -> str:
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    clock = time.perf_counter
    stages = {"to_main_s": clock() - T_START}
    t = clock()
    import torch

    stages["import_torch_s"] = clock() - t
    t = clock()
    import spriteworld_torch  # noqa: F401  (a checkout without it stops here)
    from perfbench import harness

    stages["import_port_s"] = clock() - t

    layout = harness.Layout(ROOT)
    cell = layout.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    t = clock()
    torch.zeros(1, device="cuda")  # the CUDA context
    stages["cuda_context_s"] = clock() - t
    print(json.dumps({"workload": args.workload,
                      "seed": args.seed, "seconds": args.seconds,
                      "trace": args.trace}), flush=True)
    try:
        result, info, rows = harness.run(
            layout, args.workload, args.seed, args.seconds,
            bool(args.trace), "cuda", T_START, stages)
    except harness.ForbiddenModules as e:
        print(f"JAX modules loaded once the window closed: {e}",
              file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    # Read once the window has closed: nvidia-smi takes a varying part of
    # a second, which set-up would count.
    info["card"] = _card()
    print(json.dumps(info), flush=True)
    for name, value, limit in rows:
        print(f"{name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
