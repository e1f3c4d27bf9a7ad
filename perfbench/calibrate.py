#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds <a,b,...> \\
        --control-seeds <c,d,e> --seconds <s> [--out <file.json>]

In one process (the card's set-up paid once): for each seed, the cell's
program driven for a short window at the cell's own size and load, its
records judged against the plain reference (`check.py`); for each control
seed, the same records' starting points with the reference computed in
bfloat16 put in the program's place (the control). Prints one JSON line a
reading: {"seed", "side": "program" | "control", the counts of `check.NAMES`,
"answers", "answers_off", "check_s"}; `--out` also writes them all.
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    import argparse

    import torch

    from perfbench import check, harness, traffic

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    layout = harness.Layout(ROOT)
    cell = layout.cell(args.workload)
    config = layout.config(cell["config"])
    mix = layout.traffic(cell["traffic"])
    ref = check.reference_module(layout.reference(cell["config"]))
    observation = config["observation"]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    readings = []
    for seed in seeds + sorted(controls - set(seeds)):
        feed = traffic.build(layout, mix, harness.env_kwargs(config),
                             observation, "cuda", seed)
        feed.setup(args.seconds)
        feed.window(args.seconds, False)
        rec = feed.records()
        feed.free()
        sides = ([("program", False)] if seed in seeds else []) + (
            [("control", True)] if seed in controls else [])
        for side, control in sides:
            t = time.perf_counter()
            tally = feed.check(rec, ref, observation, control=control)
            row = {"workload": args.workload, "seed": seed, "side": side,
                   **tally.counts, "answers": tally.answers,
                   "answers_off": tally.answers_off,
                   "check_s": time.perf_counter() - t}
            readings.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
