"""Throughput of the PyTorch/CUDA port on bench.py's workloads.

--workload image64 (default): a random agent steps B env lanes of 6-sprite
goal finding with 64x64 HSV image observations (bench.py's `image64`: 1
target + 5 distractors, SelectMove(scale=0.25), FindGoalPosition,
max_episode_length=20), at --aa (default 1); --fast renders with
pil_exact=False (the centroid fill and the box filter).

--workload factors: the same scenes with SpriteFactors observations (no
rendering). clustering, sorting, embodied: bench.py's config workloads, the
train mode of configs/cobra/clustering.py, configs/cobra/sorting.py and
configs/examples/goal_finding_embodied.py with a Success observation added,
each rendering with its config's own renderer.

--workload all: bench.py's list, one JSON line each: image64 exact at AA=1
and AA=5, image64 fast at AA=5, then factors, clustering, sorting and
embodied. 2048 lanes each by default.

--workload demo256: the interactive demo's scene (run_demo.py's defaults):
the cobra clustering config (train mode) with demo_ui.setup_run_ui's
overrides, DragAndDrop(scale=0.5), a 256x256 HSV ImageRenderer at
anti_aliasing=10 and Success, 256 lanes by default. Its 2560x2560 canvas
renders through the row-strip kernels (with --fast, in their centroid and
box mode). It stays outside `all`.

The lanes step through `spriteworld_torch.parallel.ShardedRunner`, a chunk
of --steps steps at a time (the runner keeps the episode metrics on the
device and reads them once a chunk), after one warm-up chunk. --runner
graph (default) replays each step as a captured CUDA graph; --runner eager
launches the same step's kernels one by one; --runner pairs runs both on the
same env and alternates their chunks (graph, eager, eager, graph, ...), so
the two are compared within one call. Each timed chunk ends in
torch.cuda.synchronize(); "value" is the best chunk's rate (bench.py's
rule), "median_steps_per_sec" the median chunk's.

Prints ONE JSON line per workload and runner in bench.py's shape, with
"runner", "backend": "cuda", the card's name and its power limit; with
pairs, then a line with each pair's chunk seconds. Needs a CUDA device.

With --profile N it then runs one chunk of N steps of each runner under
torch.profiler and prints a JSON line each: wall and device-busy time per
step, the device's idle share, kernel launches per step (a graph replay's
kernels counted one by one) and the kernels that take the most device time.
The profiler's own overhead lengthens those steps.

Usage: python bench_torch.py [--workload image64|factors|clustering|sorting|
                              embodied|demo256|all] [--aa N] [--fast]
                             [--runner graph|eager|pairs] [--num_envs B]
                             [--steps 50] [--chunks 3] [--profile N]
"""

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time

import torch

from spriteworld_torch import demo_ui
from spriteworld_torch.configs.cobra import clustering
from spriteworld_torch.core import actions as action_lib
from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import environment as env_lib
from spriteworld_torch.core import generators as sprite_generators
from spriteworld_torch.core import renderers
from spriteworld_torch.core import tasks
from spriteworld_torch.parallel import ShardedRunner


def goal_finding_parts():
    """6-sprite goal-finding scene: 1 hue target + 5 distractors."""
    common = distribs.Product([
        distribs.Continuous("x", 0.1, 0.9),
        distribs.Continuous("y", 0.1, 0.9),
        distribs.Discrete("shape", ["square", "triangle", "circle",
                                    "pentagon", "star_5", "spoke_4"]),
        distribs.Continuous("angle", 0, 360),
        distribs.Continuous("scale", 0.1, 0.2),
        distribs.Continuous("c1", 0.3, 1.0),
        distribs.Continuous("c2", 0.9, 1.0),
    ])
    target_hue = distribs.Continuous("c0", 0.0, 0.15)
    distractor_hue = distribs.Continuous("c0", 0.2, 0.9)
    init_sprites = sprite_generators.chain_generators(
        sprite_generators.generate_sprites(
            distribs.Product([common, target_hue]), num_sprites=1),
        sprite_generators.generate_sprites(
            distribs.Product([common, distractor_hue]), num_sprites=5))
    task = tasks.FindGoalPosition(
        filter_distrib=target_hue, goal_position=(0.5, 0.5),
        terminate_distance=0.05)
    return task, init_sprites


def build_env(anti_aliasing: int = 1, image_size=(64, 64),
              pil_exact: bool = True, device="cuda", seed: int = 0):
    """bench.py's image64 workload on the port."""
    task, init_sprites = goal_finding_parts()
    return env_lib.Environment(
        task=task,
        action_space=action_lib.SelectMove(scale=0.25),
        renderers={
            "image": renderers.ImageRenderer(
                image_size=tuple(image_size), anti_aliasing=anti_aliasing,
                color_to_rgb="hsv", pil_exact=pil_exact),
            "success": renderers.Success(),
        },
        init_sprites=init_sprites,
        max_episode_length=20,
        metadata={"name": "bench_goal_finding_6sprites"},
        device=device, seed=seed)


def build_factors_env(device="cuda", seed: int = 0):
    """bench.py's factors workload: goal finding with SpriteFactors."""
    task, init_sprites = goal_finding_parts()
    return env_lib.Environment(
        task=task,
        action_space=action_lib.SelectMove(scale=0.25),
        renderers={
            "factors": renderers.SpriteFactors(),
            "success": renderers.Success(),
        },
        init_sprites=init_sprites,
        max_episode_length=20,
        metadata={"name": "bench_goal_finding_factors"},
        device=device, seed=seed)


def config_of(module_name: str):
    """A config's train mode plus the Success observation, as a dict of
    Environment arguments (`module_name` under spriteworld_torch.configs)."""
    mod = importlib.import_module(f"spriteworld_torch.configs.{module_name}")
    cfg = mod.get_config("train")
    cfg["renderers"]["success"] = renderers.Success()
    return cfg


def config_env(module_name: str, device="cuda", seed: int = 0):
    """bench.py's _config_env: a config's train mode plus Success."""
    return env_lib.Environment(**config_of(module_name), device=device,
                               seed=seed)


# bench.py's WORKLOADS: name -> (metric suffix, builder(device, seed)).
WORKLOADS = {
    "factors": ("factors_6sprites", build_factors_env),
    "clustering": ("cobra_clustering",
                   lambda **kw: config_env("cobra.clustering", **kw)),
    "sorting": ("cobra_sorting",
                lambda **kw: config_env("cobra.sorting", **kw)),
    "embodied": ("goal_finding_embodied",
                 lambda **kw: config_env("examples.goal_finding_embodied",
                                         **kw)),
}


def demo_config(mode: str = "train", render_size: int = 256,
                anti_aliasing: int = 10, pil_exact: bool = True):
    """The cobra clustering config with the interactive demo's overrides
    (`demo_ui.demo_overrides`, at run_demo.py's defaults):
    DragAndDrop(scale=0.5) in place of SelectMove, an HSV image of
    render_size x render_size at `anti_aliasing`, and the Success
    observation."""
    return demo_ui.demo_overrides(
        clustering.get_config(mode), render_size, task_hsv_colors=True,
        anti_aliasing=anti_aliasing, pil_exact=pil_exact)


def build_demo_env(anti_aliasing: int = 10, render_size: int = 256,
                   pil_exact: bool = True, device="cuda", seed: int = 0):
    """The demo256 workload on the port."""
    return env_lib.Environment(
        **demo_config("train", render_size, anti_aliasing, pil_exact),
        device=device, seed=seed)


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed_chunks(runners, steps: int, chunks: int):
    """{mode: seconds of each of `chunks` timed chunks of `steps` steps},
    after a reset and one warm-up chunk (which captures a graph) of each
    runner, and {mode: final state}. With two runners the chunks alternate
    in pairs whose order flips each time (A B, B A, A B, ...)."""
    states = {}
    for mode, runner in runners.items():
        state, _ = runner.reset()
        states[mode], _ = runner.rollout(state, steps)
    times = {mode: [] for mode in runners}
    order = list(runners)
    for c in range(chunks):
        for mode in (order if c % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[mode], _ = runners[mode].rollout(states[mode], steps)
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
    return times, states


def profile(runner, state, steps: int) -> dict:
    """Device time by kernel over one chunk of `steps` steps, from
    torch.profiler (after one unprofiled chunk of the same length)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    state, _ = runner.rollout(state, steps)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.rollout(state, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels only: operator events carry their kernels' time too, and
    # the device-side ranges of `profiling.annotate` span them.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "runner": "graph" if runner.use_graph else "eager",
        "profile_steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels": [
            {"name": e.key[:80],
             "ms_per_step": e.self_device_time_total / 1e3 / steps,
             "launches_per_step": e.count / steps} for e in top],
    }


def todo_list(workload: str, aa, fast: bool):
    """[(name, anti_aliasing or None, pil_exact)] to run, in bench.py's
    order for "all"."""
    if workload == "all":
        return ([("image64", 1, True), ("image64", 5, True),
                 ("image64", 5, False)]
                + [(n, None, True) for n in WORKLOADS])
    if workload in ("image64", "demo256"):
        default_aa = 1 if workload == "image64" else 10
        return [(workload, default_aa if aa is None else aa, not fast)]
    return [(workload, None, True)]


def build(name: str, aa, exact: bool, device="cuda", seed: int = 0):
    """(env, metric suffix, extra JSON fields) of one workload."""
    if name in WORKLOADS:
        suffix, builder = WORKLOADS[name]
        return builder(device=device, seed=seed), suffix, {}
    if name == "image64":
        env = build_env(anti_aliasing=aa, pil_exact=exact, device=device,
                        seed=seed)
        suffix = ("64x64render_6sprites" if aa == 1
                  else f"64x64render_aa{aa}_6sprites")
    else:
        env = build_demo_env(anti_aliasing=aa, pil_exact=exact,
                             device=device, seed=seed)
        suffix = f"256x256render_aa{aa}_clustering"
    if not exact:
        suffix += "_fast"
    return env, suffix, {"anti_aliasing": aa, "pil_exact": exact}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="image64",
                   choices=["image64", *WORKLOADS, "demo256", "all"])
    p.add_argument("--aa", type=int, default=None,
                   help="anti_aliasing of image64 (default 1) or demo256 "
                        "(default 10)")
    p.add_argument("--fast", action="store_true",
                   help="image64 or demo256 with pil_exact=False (centroid "
                        "fill + box filter)")
    p.add_argument("--runner", default="graph",
                   choices=["graph", "eager", "pairs"],
                   help="replay captured CUDA graphs, launch the step's "
                        "kernels eagerly, or alternate the two")
    p.add_argument("--num_envs", type=int, default=None,
                   help="lanes (default: 2048; 256 for demo256)")
    p.add_argument("--steps", type=int, default=50,
                   help="steps per timed chunk")
    p.add_argument("--chunks", type=int, default=3,
                   help="timed chunks of each runner (best taken) after "
                        "one warm-up chunk")
    p.add_argument("--profile", type=int, default=0,
                   help="steps of a chunk to run under torch.profiler "
                        "after each workload")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch.py needs a CUDA device", file=sys.stderr)
        return 1
    card = card_name_and_power_limit()
    modes = ["graph", "eager"] if args.runner == "pairs" else [args.runner]
    for name, aa, exact in todo_list(args.workload, args.aa, args.fast):
        num_envs = args.num_envs or (256 if name == "demo256" else 2048)
        env, suffix, extra = build(name, aa, exact)
        runners = {m: ShardedRunner(env, num_envs, use_graph=m == "graph")
                   for m in modes}
        times, states = timed_chunks(runners, args.steps, args.chunks)
        for mode in modes:
            steps_per_sec = num_envs * args.steps / min(times[mode])
            print(json.dumps({
                "metric": f"env_steps_per_sec_per_chip_{suffix}",
                "value": steps_per_sec,
                "unit": "env-steps/s/chip",
                "vs_baseline": None,
                "workload": name,
                "runner": mode,
                "num_envs": num_envs,
                "chip_count": 1,
                "total_steps_per_sec": steps_per_sec,
                "median_steps_per_sec":
                    num_envs * args.steps / statistics.median(times[mode]),
                "chunk_seconds": times[mode],
                "backend": "cuda",
                **extra,
                "device": torch.cuda.get_device_name(0),
                "card": card,
            }), flush=True)
        if len(modes) == 2:
            pairs = list(zip(times["graph"], times["eager"]))
            print(json.dumps({
                "workload": name, "pairs_graph_eager_seconds": pairs,
                "graph_faster": sum(g < e for g, e in pairs),
                "card": card}), flush=True)
        if args.profile:
            for mode in modes:
                print(json.dumps(profile(runners[mode], states[mode],
                                         args.profile)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
