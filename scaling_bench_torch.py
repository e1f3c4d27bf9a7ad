"""Weak-scaling curve over ranks, and one card's batch-saturation curve.

Counterpart of scaling_bench.py. The default mode runs the factors goal-
finding workload (bench_torch.build_factors_env: no rasterization, the
pure engine) with a fixed --envs_per_device at 1, 2, 4 and 8 ranks, up to
the devices there are: each size is that many processes joined by
`parallel.mesh.initialize_multihost`, one a card over NCCL on a GPU
machine, or gloo processes on the CPU (--device cpu, --devices N), which
stand in for the JAX bench's virtual devices and share the host's cores as
those do. Each rank steps its lanes through `ShardedRunner(mesh=...)`; a
size's rate is global lanes x steps over the slowest rank's wall time of a
chunk (an all_reduce(MAX) of the ranks' seconds), the best of 3 chunks
after a warm-up chunk. The engine is embarrassingly data-parallel (the
only collectives are metric sums), so steps/s should grow near-linearly
with ranks; the efficiency column makes regressions visible.

Run:  python scaling_bench_torch.py [--envs_per_device 64] [--steps 100]
      python scaling_bench_torch.py --device cpu --devices 2

--batch_sweep times image64 at anti_aliasing=1 (bench_torch.build_env,
the packed_raster kernel) at 256..8192 lanes on one card through the
runner's graph rollout, showing where one card's throughput saturates.
The JAX bench times a program that feeds every observation into a
reduction there, since XLA drops an unconsumed render as dead code; in
torch nothing drops the render, so the runner's own rollout is the honest
measurement:

    python scaling_bench_torch.py --batch_sweep [--steps 200]

Each mode replaces its metric's rows in --out (default SCALING_torch.jsonl)
and keeps the other rows. Rows carry "card": the card's name and power
limit (nvidia-smi), or "cpu".
"""

import argparse
import json
import os
import sys
import time

import torch

WEAK_METRIC = "weak_scaling_factors_env_steps_per_sec"
SWEEP_METRIC = "batch_saturation_image64_aa1_steps_per_sec"
SWEEP_BATCHES = (256, 512, 1024, 2048, 4096, 8192)
RANKS_TIMEOUT = 600  # seconds a size's ranks may take


def _card(device) -> str:
    from spriteworld_torch.utils import device as device_lib

    if torch.device(device).type == "cuda":
        return device_lib.card_name_and_power_limit()
    return "cpu"


def _timed_chunks(runner, steps, reps=3, replicated=None):
    """Seconds of `reps` chunks of `steps` steps after a reset and one
    warm-up chunk (which captures the graph); with `replicated`, each
    chunk's seconds are the slowest rank's (all_reduce MAX)."""
    state, _ = runner.reset(0)
    state, _ = runner.rollout(state, steps)
    cuda = runner.env.device.type == "cuda"
    times = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = runner.rollout(state, steps)
        if cuda:
            torch.cuda.synchronize()
        seconds = torch.tensor([time.perf_counter() - t0],
                               dtype=torch.float64, device=runner.env.device)
        if replicated is not None:
            replicated.all_reduce(seconds, op="max")
        assert m.steps == runner.num_envs * steps
        times.append(float(seconds))
    return times


def _rewrite_keeping_other_metrics(out_path, metric, new_rows):
    """Replace this metric's rows in the artifact, keep every other row."""
    kept = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            kept = [json.loads(l) for l in f if l.strip()]
        kept = [r for r in kept if r.get("metric") != metric]
    with open(out_path, "w") as f:
        for r in kept + new_rows:
            f.write(json.dumps(r) + "\n")


def batch_sweep(out, steps, batches=SWEEP_BATCHES, device="cuda"):
    """One card's batch-saturation curve: image64/AA=1 through the
    runner's graph rollout at each of `batches` lanes; returns the rows."""
    import bench_torch
    from spriteworld_torch.parallel import ShardedRunner

    env = bench_torch.build_env(anti_aliasing=1, device=device)
    card = _card(device)
    rows = []
    for num_envs in batches:
        runner = ShardedRunner(env, num_envs)
        best = min(_timed_chunks(runner, steps))
        sps = num_envs * steps / best
        rows.append({
            "metric": SWEEP_METRIC,
            "devices": 1,
            "num_envs": num_envs,
            "steps_per_sec": sps,
            "us_per_env_step": 1e6 / sps,
            "card": card,
        })
        print(json.dumps(rows[-1]), flush=True)
    _rewrite_keeping_other_metrics(out, SWEEP_METRIC, rows)
    return rows


def rank_main(envs_per_device, steps, device, rank, world, address):
    """One rank of one weak-scaling size: prints the global rate (rank 0)
    as a JSON line."""
    import bench_torch
    from spriteworld_torch.parallel import (ShardedRunner, env_mesh,
                                            initialize_multihost,
                                            replicated_sharding)

    initialize_multihost(address, int(world), int(rank), device=device)
    mesh = env_mesh(device)
    env = bench_torch.build_factors_env(device=mesh.device)
    runner = ShardedRunner(env, int(envs_per_device) * mesh.size, mesh=mesh)
    best = min(_timed_chunks(runner, int(steps),
                             replicated=replicated_sharding(mesh)))
    print(json.dumps({"devices": mesh.size, "num_envs": runner.num_envs,
                      "steps_per_sec": runner.num_envs * int(steps) / best}),
          flush=True)
    torch.distributed.destroy_process_group()
    # Leave at once: gloo's threads can abort the interpreter's own exit
    # (std::terminate) once the group is gone.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def weak_scaling(out, steps, envs_per_device, device="cuda", devices=8):
    """The weak-scaling rows at 1, 2, 4 and 8 ranks, up to the cards there
    are (CUDA) or `devices` gloo processes (CPU); returns the rows."""
    from spriteworld_torch.parallel import mesh as mesh_lib
    from spriteworld_torch.utils import device as device_lib

    dev = device_lib.resolve(device)
    if dev.type == "cuda":
        devices = torch.cuda.device_count()
    card = _card(dev)
    sizes = [s for s in (1, 2, 4, 8) if s <= devices]
    base = None
    rows = []
    for n in sizes:
        outs = mesh_lib.run_ranks(
            [os.path.abspath(__file__), "--rank_of", str(envs_per_device),
             str(steps), str(dev)], n, timeout=RANKS_TIMEOUT)
        got = json.loads(outs[0].strip().splitlines()[-1])
        sps = got["steps_per_sec"]
        if base is None:
            base = sps
        row = {
            "metric": WEAK_METRIC,
            "devices": n,
            "num_envs": got["num_envs"],
            "steps_per_sec": sps,
            "speedup_vs_1dev": sps / base,
            "efficiency": sps / (base * n),
            "card": card,
        }
        if dev.type == "cpu":
            # Gloo processes on one host share its cores, as the JAX
            # bench's virtual devices do: efficiency here measures host-
            # core contention, not interconnect scaling; the row shows the
            # sharded program runs at every size.
            row["note"] = ("gloo processes stand in for virtual devices; "
                           "virtual devices share host cores")
        rows.append(row)
        print(json.dumps(row), flush=True)
    _rewrite_keeping_other_metrics(out, WEAK_METRIC, rows)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--rank_of"]:
        return rank_main(*argv[1:])
    p = argparse.ArgumentParser()
    p.add_argument("--envs_per_device", type=int, default=64)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", default="SCALING_torch.jsonl")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; one rank a card) or cpu (gloo "
                        "processes)")
    p.add_argument("--devices", type=int, default=8,
                   help="with --device cpu: the most gloo processes")
    p.add_argument("--batch_sweep", action="store_true",
                   help="one card's image64/AA=1 saturation curve instead "
                        "of the weak-scaling curve")
    args = p.parse_args(argv)
    if args.batch_sweep:
        batch_sweep(args.out, args.steps, device=args.device)
    else:
        weak_scaling(args.out, args.steps, args.envs_per_device,
                     args.device, args.devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
