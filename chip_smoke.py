"""Drives the PyTorch/CUDA port on one card and checks it; exits non-zero on
any failure.

Phases:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel from spriteworld_torch/csrc (one nvcc per source,
     all started together);
  3. each kernel against its plain PyTorch version on the card, bit-exact,
     over seeded batches (all 12 shapes, random angles, 1-8 live sprites,
     the degenerate tiny/axis-aligned generator) at 64x64/AA=5, 64x64/AA=1
     and 32x32/AA=2, with a bg_color case and an HSV case; then the whole
     render on the card against the CPU on angle-0 scenes (trig exact);
  4. the main path: bench.py's image64 workload at anti_aliasing=5 over
     2048 lanes — reset, warm-up, 3 timed chunks of 50 steps, each step
     followed by torch.cuda.synchronize() — checking that every render went
     through the kernel, images are not blank, rewards are finite (NaN only
     where the goal filter is empty) and step types follow FIRST/MID/LAST;
  5. each kernel's time at the main path's shapes beside its plain version
     and its bound, as one JSON `kernels` line;
  6. the last line: {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py   (needs one CUDA card)
"""

import json
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BATCH = 2048
STEPS = 50
CHUNKS = 3
WARMUP_STEPS = 5


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def scene_batch(seed, b, kmax=8, degenerate=False, hsv=False, angle0=False):
    """Seeded factors f32[b, kmax, 10] and live counts i32[b] in 1..kmax."""
    from spriteworld_torch.core import state as state_lib

    rng = np.random.default_rng(seed)
    f = np.tile(state_lib.DEFAULT_FACTORS, (b, kmax, 1)).astype(np.float32)
    f[..., state_lib.X] = rng.uniform(0.1, 0.9, (b, kmax))
    f[..., state_lib.Y] = rng.uniform(0.1, 0.9, (b, kmax))
    if degenerate:
        f[..., state_lib.SHAPE] = rng.choice([3, 8, 9, 10, 11, 12], (b, kmax))
        f[..., state_lib.ANGLE] = np.where(
            np.arange(kmax) % 2 == 0,
            rng.choice([0.0, 90.0, 180.0], (b, kmax)),
            rng.uniform(0, 360, (b, kmax)))
        f[..., state_lib.SCALE] = rng.uniform(0.02, 0.07, (b, kmax))
    else:
        f[..., state_lib.SHAPE] = rng.integers(1, 13, (b, kmax))
        f[..., state_lib.ANGLE] = rng.uniform(0, 360, (b, kmax))
        f[..., state_lib.SCALE] = rng.uniform(0.08, 0.3, (b, kmax))
    if angle0:
        f[..., state_lib.ANGLE] = 0.0
    if hsv:
        f[..., 5:8] = rng.uniform(0, 1, (b, kmax, 3))
    else:
        f[..., 5:8] = rng.integers(0, 256, (b, kmax, 3))
    nums = rng.integers(1, kmax + 1, b).astype(np.int32)
    return f, nums


def compare(got, want):
    """(max |difference|, count of differing values) of two u8 tensors."""
    diff = (got.to(dtype=want.dtype, device=want.device).int()
            - want.int()).abs()
    return int(diff.max()), int((diff > 0).sum())


def kernel_vs_plain(torch, rasterize_cuda, colors):
    """Phase 3: every case bit-exact; returns the largest difference."""
    cases = [
        # (name, seed, image_size, aa, batch kwargs, render kwargs)
        ("64x64/AA=5", 1, (64, 64), 5, {}, {}),
        ("64x64/AA=5 degenerate", 2, (64, 64), 5, {"degenerate": True}, {}),
        ("64x64/AA=1", 3, (64, 64), 1, {}, {}),
        ("64x64/AA=1 degenerate", 4, (64, 64), 1, {"degenerate": True}, {}),
        ("32x32/AA=2", 5, (32, 32), 2, {}, {}),
        ("64x64/AA=5 bg_color", 6, (64, 64), 5, {},
         {"bg_color": (10, 20, 30)}),
        ("64x64/AA=5 hsv", 7, (64, 64), 5, {"hsv": True},
         {"color_to_rgb": colors.hsv_to_rgb}),
    ]
    worst = 0
    for name, seed, size, aa, bkw, rkw in cases:
        f, n = scene_batch(seed, 256, **bkw)
        tables = rasterize_cuda.prepare(
            torch.from_numpy(f).cuda(), torch.from_numpy(n).cuda(),
            size[0] * aa, size[1] * aa, rkw.get("color_to_rgb"))
        got = rasterize_cuda.scene_raster(tables, size, rkw.get("bg_color"))
        want = rasterize_cuda.render_rgb_batch_plain(
            tables, size, rkw.get("bg_color"))
        torch.cuda.synchronize()
        err, count = compare(got, want)
        print(f"kernel vs plain, {name}, B=256: max |diff| {err}, "
              f"{count} differing values")
        check(count == 0, f"scene kernel differs from its plain version "
                          f"({name})")
        worst = max(worst, err)

    # The whole render on the card against the CPU: with angle 0 the
    # vertices are exact on both, so the images must be equal.
    f, n = scene_batch(8, 64, angle0=True)
    kw = dict(image_size=(64, 64), anti_aliasing=5)
    gpu = rasterize_cuda.render_rgb_batch(
        torch.from_numpy(f).cuda(), torch.from_numpy(n).cuda(), **kw)
    cpu = rasterize_cuda.render_rgb_batch(
        torch.from_numpy(f), torch.from_numpy(n), **kw)
    err, count = compare(gpu, cpu)
    print(f"render on the card vs the CPU, 64x64/AA=5 angle 0, B=64: "
          f"max |diff| {err}, {count} differing values")
    check(count == 0, "render on the card differs from the CPU")
    return worst


def drive_main_path(torch, bench_torch, env_lib, rasterize_cuda, StepType):
    """Phase 4: image64 at AA=5 over 2048 lanes. Returns (steps/s, state)."""
    env = bench_torch.build_env(anti_aliasing=5, device="cuda", seed=0)
    benv = env_lib.BatchedEnvironment(env, BATCH)
    task = env.task
    dev = env.device

    rasterize_cuda.scene_raster.launches = 0
    renders = 0
    state, ts = benv.reset()
    renders += 1
    prev_type = ts.step_type
    bad_types = torch.zeros((), dtype=torch.int64, device=dev)
    bad_rewards = torch.zeros((), dtype=torch.int64, device=dev)
    blank = torch.zeros((), dtype=torch.int64, device=dev)
    seen = torch.zeros(3, dtype=torch.int64, device=dev)

    def step():
        nonlocal state, ts, prev_type, bad_types, bad_rewards, blank, seen
        state, ts = benv.step(state, benv.sample_actions())
        torch.cuda.synchronize()
        cur = ts.step_type
        first = cur == StepType.FIRST
        after_last = prev_type == StepType.LAST
        bad_types = bad_types + (first != after_last).sum()
        empty = ~task.filter_mask(state.factors, state.num_sprites).any(-1)
        nan = torch.isnan(ts.reward)
        bad_rewards = bad_rewards + (nan != (~first & empty)).sum() \
            + torch.isinf(ts.reward).sum()
        blank = blank + (ts.observation["image"].amax(dim=(1, 2, 3))
                         == 0).sum()
        seen = seen + torch.bincount(cur.long(), minlength=3)
        prev_type = cur

    for _ in range(WARMUP_STEPS):
        step()
    renders += WARMUP_STEPS
    best = float("inf")
    for c in range(CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        renders += STEPS
        print(f"main path chunk {c}: {STEPS} steps x {BATCH} lanes in "
              f"{dt:.4f} s")
    image = ts.observation["image"]
    check(tuple(image.shape) == (BATCH, 64, 64, 3)
          and image.dtype == torch.uint8, f"image {tuple(image.shape)}")
    launches = rasterize_cuda.scene_raster.launches
    print(f"scene_raster launches {launches} for {renders} renders; "
          f"step types seen (FIRST, MID, LAST) {seen.tolist()}")
    check(launches == renders, "a render did not go through the kernel")
    check(int(bad_types) == 0, f"{int(bad_types)} bad step-type transitions")
    check(int(bad_rewards) == 0, f"{int(bad_rewards)} bad rewards")
    check(int(blank) == 0, f"{int(blank)} blank images")
    check(int(seen[2]) > 0 and int(seen[0]) > 0, "no episode ended")
    return BATCH * STEPS / best, state


def time_kernel(torch, rasterize_cuda, colors, state):
    """Phase 5: scene_raster at the main path's inputs."""
    image_size, aa = (64, 64), 5
    tables = rasterize_cuda.prepare(state.factors, state.num_sprites,
                                    64 * aa, 64 * aa, colors.hsv_to_rgb)
    got = rasterize_cuda.scene_raster(tables, image_size)
    want = rasterize_cuda.render_rgb_batch_plain(tables, image_size)
    err, count = compare(got, want)
    print(f"kernel vs plain at the main path's inputs, B={BATCH}: "
          f"max |diff| {err}, {count} differing values")
    check(count == 0, "scene kernel differs from its plain version")

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    ms = event_ms(lambda: rasterize_cuda.scene_raster(tables, image_size), 20)
    plain_ms = event_ms(
        lambda: rasterize_cuda.render_rgb_batch_plain(tables, image_size), 2)

    # Least time: each input read once, each output written once, over the
    # memory rate; or the operations these inputs need over the float32
    # rate, whichever is larger.
    tab = tables.tab
    hx0, hq = rasterize_cuda.lanczos_taps(64 * aa, 64, "cuda")
    in_bytes = tab.numel() * 4 + 2 * (hx0.numel() + hq.numel()) * 4
    out_bytes = BATCH * 64 * 64 * 3
    s = rasterize_cuda
    count_v = tab[..., s.T_COUNT]
    rows = (tab[..., s.T_ROW1].clamp(max=64 * aa - 1)
            - tab[..., s.T_ROW0].clamp(min=0) + 1).clamp(min=0)
    cols = (tab[..., s.T_COL1].clamp(max=64 * aa - 1)
            - tab[..., s.T_COL0].clamp(min=0) + 1).clamp(min=0)
    # Per pixel of a sprite's bounds, a compare and an add per edge.
    fill_ops = float((rows * cols * count_v * 2).sum())
    taps = sum(len(q) for q in s.resample.pil_lanczos_fixed(64 * aa, 64)[1])
    # Per output of each pass, a multiply and an add per tap and channel.
    lanczos_ops = BATCH * 2 * 3 * taps * (64 * aa + 64)
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = (fill_ops + lanczos_ops) / FP32_OPS_PER_S * 1e3
    print(f"scene_raster bound: {in_bytes + out_bytes} bytes -> "
          f"{bytes_ms:.6f} ms; {fill_ops:.0f} fill + {lanczos_ops} Lanczos "
          f"operations -> {ops_ms:.6f} ms")
    return {
        "name": "scene_raster",
        "route": "cuda",
        "source": "spriteworld_torch/csrc/scene_raster.cu",
        "replaces": "spriteworld_tpu/ops/rasterize_pallas.py:312",
        "launches": None,  # filled in with the main path's count
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call rasterizes a scene
    }


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    import bench_torch
    from spriteworld_torch.core import environment as env_lib
    from spriteworld_torch.core.state import StepType
    from spriteworld_torch.ops import _build
    from spriteworld_torch.ops import rasterize_cuda
    from spriteworld_torch.utils import colors

    card = bench_torch.card_name_and_power_limit()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    worst = kernel_vs_plain(torch, rasterize_cuda, colors)
    steps_per_sec, state = drive_main_path(
        torch, bench_torch, env_lib, rasterize_cuda, StepType)
    launches = rasterize_cuda.scene_raster.launches
    print(f"env_steps_per_sec {steps_per_sec:.1f} (image64, AA=5, "
          f"{BATCH} lanes) on {card}")
    entry = time_kernel(torch, rasterize_cuda, colors, state)
    entry["launches"] = launches
    entry["max_abs_err"] = max(entry["max_abs_err"], worst)
    print(f"scene_raster at B={BATCH}: kernel {entry['ms']:.4f} ms, plain "
          f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.6f} ms "
          f"({entry['bound_by']}) on {card}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
