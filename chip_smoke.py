"""Drives the PyTorch/CUDA port on one card and checks it; exits non-zero on
any failure.

Phases:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel from spriteworld_torch/csrc (one nvcc per source,
     all started together), and hold the renderer's Python mirrors of the
     kernels' shared-memory layouts equal to the kernels' own, with the
     Lanczos and the box layouts of the scene kernel and packed_raster's
     at several K and tile heights, and the blocks each layout keeps
     resident on an SM at the paths' shapes;
  3. each kernel against its plain PyTorch version on the card, bit-exact,
     over seeded batches. The scene kernel: all 12 shapes, random angles,
     1-8 live sprites, the degenerate tiny/axis-aligned generator, at
     64x64/AA=5, 64x64/AA=1 and 32x32/AA=2, with a bg_color case and an HSV
     case; then the whole render on the card against the CPU on angle-0
     scenes (trig exact). The row-strip kernels: 256x256/AA=10, 128x128/AA=5,
     a degenerate batch, a non-square canvas and 1024x1024/AA=1, each whole
     render and the h-pass and v-pass on their own; ImageRenderer at
     128x128/AA=5 and 256x256/AA=10 taking the strips; then strips forced
     at 64x64/AA=5 against the scene kernel (two independent kernels).
     The other modes: packed_raster at 64x64, 32x32, 16x16 and 48x64 with
     both fills, a bg_color, an HSV and a degenerate case, and against the
     scene kernel forced at 64x64/AA=1; the scene kernel in centroid+box at
     64x64/AA=5 and 32x32/AA=2 and in exact+box; the strip kernels in
     centroid+box at 256x256/AA=10 and 128x128/AA=5, and forced at
     64x64/AA=5 box against the scene kernel in box mode; then the ten
     mosaic-parity CASES of tests_tpu/test_mosaic_parity.py through the
     renderer's dispatch, each checked to run the kernel it should; batches
     of 16 sprites (K + 1 = 17 slots, the h-pass's table route) through
     the scene and strip kernels; the card against the CPU
     (`vertex_trig`): world-vertex values at random angles, SelectMove
     picks and Embodied carries on clicks placed on sprite edges (and one
     float32 ulp off them), anti_aliasing=1 pixels at 64x64, 128x128 and
     256x256, each checked to differ nowhere, beside the counts that
     float32 sine and cosine give; the IMMA instructions in each built
     kernel (cuobjdump -sass); the scene kernel with the Lanczos filter on
     the edges of its live-unit test (`live_unit_cases`: no live sprite,
     sprites across each border, squares one pixel short of a unit's span
     and one pixel into it, all 12 slots live; 64x64/AA=5 and 32x48/AA=3),
     bit for bit, with its count of live v-pass units equal to the twin
     masks' (`rasterize_cuda.scene_live_units`);
  4. the main path: bench.py's image64 workload at anti_aliasing=5 over
     2048 lanes through BatchedEnvironment(use_graph=False), the eager
     step (phases 5 and 6 too) — reset, warm-up, 3 timed chunks of 50
     steps, each step followed by torch.cuda.synchronize() — checking that
     every render went through the scene kernel and every draw through
     the lane_random kernel, its fresh scenes through its scene or tree
     mode, images are not blank, rewards are finite (NaN only where the
     goal filter is empty) and step types follow FIRST/MID/LAST;
  5. the demo path: the cobra clustering config with the interactive
     demo's overrides (DragAndDrop(scale=0.5), 256x256 HSV images at
     anti_aliasing=10, Success) over 256 lanes — reset, warm-up, 3 chunks of
     20 steps — checking that every render went through the strip kernels,
     images are not blank, rewards are finite wherever the task is valid
     and step types follow FIRST/MID/LAST;
  6. every bench.py workload (bench_torch.py's builders): image64 at AA=1
     (packed_raster, and in its fast centroid mode), image64 fast at AA=5
     (the scene kernel in
     centroid+box), factors (no kernel), clustering, sorting and embodied
     (the scene kernel), 2048 lanes each, and demo256 fast over 256 lanes
     (the strip kernel in centroid+box): a short warm-up and one timed
     chunk longer than an episode, with the same per-step checks, launch
     counts by kernel and mode, and for embodied that actions moved the
     agent's body; each workload's env-steps/s on a line of its own;
  7. the runner (spriteworld_torch.parallel.ShardedRunner) on image64 at
     AA=5 and AA=1, sorting and embodied (integer actions) over 2048
     lanes and demo256 over 256: a
     chunk of 8 steps replayed from a captured CUDA graph, whose capture
     launched the path's kernels (and no other) through their wrappers,
     equal bit for bit (state, step types, rewards, images, metrics) to
     the eager runner's chunk from the same state and action key, run
     under torch.cuda.set_sync_debug_mode("error"); metrics against the
     stacked timesteps; two replays from one state taking the same fresh
     scenes (the lanes' keys) and different actions (the action key goes
     on); graph and eager env-steps/s from alternating chunks; and a
     chunk whose fresh scenes leave rejection elements pending after the
     first round, run again and equal to the eager step loop;
  8. the split: scene_raster at image64/AA=5 (B=2048) and strip_raster +
     strip_vpass at demo256 (B=256) in exact+lanczos, exact+box and
     centroid+box on their paths' scenes (one JSON `split` line); each
     kernel's time at its path's shapes (`ms`: launches queued between two
     events; `device_ms`: the same, queued behind a spin of the card, so
     that a kernel shorter than its wrapper's host time is timed on the
     device) beside its plain version and two bounds (the bytes count
     the table entries the kernels need, not the table's padding;
     `bound_ms`, every edge at every pixel and every tap at the
     float32 rate; `bound_tc_ms`, the work as the kernels do it: the
     compacted fill at the float32 rate, the Lanczos multiply-adds of the
     h-pass units that hold more than one slot and of the v-pass at the
     int8 tensor-core rate; for the centroid+box entries the compacted
     centroid fill and the box by words as those kernels do them, with
     their share of one-slot box blocks; every entry with its resident
     blocks an SM), packed_raster in both fills, as one JSON `kernels`
     line (strip_vpass's library time: the JAX package's XLA v-pass as
     one float32 einsum with its rounding, and how many values it
     differs in), and the scene kernel's time at image64/AA=1 beside
     packed_raster's in each fill; every kernel also timed inside a CUDA
     graph of its launches (`graph_ms`); row 1 (scene_raster) also gives,
     under `paths`, its device ms and live v-pass units on the scenes of
     the four scene-kernel cells' configurations at 2048 lanes and at B=1,
     held to the plain version;
  9. the single env at B=1 (run before phase 8, whose kernels line stays
     last but one): each kernel and mode (scene exact+lanczos and
     centroid+box at 64x64/AA=5, strips in both at 256x256/AA=10,
     packed_raster in both fills at 64x64/AA=1, and the dispatch's pick
     for setup_run_ui's default 256x256/AA=1) at B = 1, 2 and 3 through
     the renderer's dispatch against the plain version, launched once at
     that batch (`by_batch`); media.record_episode, eager, on
     goal_finding_new_position and sorting (64x64/AA=5), the demo config
     (256x256/AA=10) and image64 (64x64/AA=1) with a deterministic click
     policy, every frame equal to the plain version's render of its state
     and every render through the config's kernels at B=1;
     example_run_loop_torch.run at 4 lanes with images, one log line an
     episode, its reset and step replayed from graphs; the dm_env adapter
     where dm_env is installed, else a line that says so; make_gifs_torch,
     writing its GIF where Pillow is installed, else a line that says so;
     ms an eager single-env step (median and best of 20), kernel launches
     and device-busy ms a step (torch.profiler) on each of the four
     configs, as one JSON line (`single_env_step`); then the compiled
     surface (9.6) on the same configs: BatchedEnvironment at 1 and 4
     lanes, the dm_env adapter (over a stand-in for dm_env's TimeStep and
     spec classes where dm_env is not installed) and
     media.record_episode/step_frame replay captured graphs by default and
     equal their eager twins (use_graph=False) bit for bit over two
     episodes and an auto-reset, with eager draws (sample_actions,
     sample_contained_position, the default policy) between replays, host
     reads counted under torch.cuda.set_sync_debug_mode("warn"), each
     kernel launched only to warm up and capture (counted from 0, added to
     phase 8's launches); the low-acceptance config at B=1 re-run and
     equal; graph and eager step_frame timed in turn (median and best of
     20) and profiled, as one JSON line (`single_env_graph`);
 10. the trainer, the mesh and the batch sweep (run after phase 9, before
     phase 8): train_example_torch.train at 1024 lanes x 20 steps, 5
     iterations, with factor and with image observations (packed_raster
     launched on the image path, counted into its kernels entry; nothing
     on the factors path), losses finite, a rollout replayed from the
     graph equal bit for bit to the eager one from the same parameters,
     state and key, both under
     torch.cuda.set_sync_debug_mode("error"), the images the policy saw
     at the first step equal to the plain render, the steady-state
     env-steps/s and the rollout/update split, and one rollout and one
     update under torch.profiler (busy ms, launches, top kernels); a
     one-rank NCCL group
     through parallel.mesh.initialize_multihost, whose
     ShardedRunner(mesh=...) over 2048 lanes of image64 at AA=1 equals
     the runner without a mesh; scaling_bench_torch's batch sweep at 256,
     2048 and 8192 lanes (rows into chiprun_out/scaling_smoke.jsonl);
 11. the renderer contract and action dtypes on the card (run after phase
     10, before phase 8): (a) ImageRenderer.render of one scene equals
     render_batch at its lane at image64/AA=5 (scene kernel), demo256/AA=10
     (strips) and image64/AA=1 (packed_raster), each render launching its
     kernel at B=1 (`by_batch`); (b) a renderer written to the JAX
     contract (a one-scene `render`, batched by torch.func.vmap) inside
     BatchedEnvironment's graph at 4 lanes, equal to the eager step and to
     a hand-batched twin over episodes with auto-resets; (c) float64 numpy
     actions through BatchedEnvironment's graph and media.step_frame equal
     to the same actions in float32, rewards float32, and a float32 action
     after float64 ones steps; (d) ImageRenderer refuses JAX's use_pallas,
     so no flag sends card tensors to the plain rasterizer, and a
     SpriteFactors subclass that overrides render batches its own render
     inside the graph; the phase's seconds beside the card's name and
     power limit; its launches are added to the `kernels` line;
 12. per-lane keys and JAX's draws (run after phase 11, before phase
     8): (a) the lane_random kernel bit-exact against its plain twin, on
     the card and on the CPU (normals within one float32 ulp of the CPU's,
     whose float64 log1p is its own), at B in {1, 3, 2048} and n in {1, 7,
     64}, in every mode (randint over several spans, the rejection chain
     in both layouts) and on strided keys, and `choice` on the card
     against the CPU; (b) on the low-acceptance config with action
     noise, the compiled step replayed from a graph is a function of its
     state (two steps from one state, half the lanes resetting, equal),
     and lanes 3, 7 and 12 of 16, stepped alone from the same lane keys
     and actions, equal those lanes of the batch, rejection deferred or
     re-run; (c) a runner of 16 lanes equals ranks 0 and 1 of a two-rank
     mesh stepped one after the other on the card, lane for lane; (d)
     every config in each of its modes, `BatchedEnvironment.reset(17)` at
     64 lanes on the card equal to the CPU twin's in every state field
     (the tests hold the CPU's to the JAX package's); the phase's seconds
     beside the card's name and power limit. Phase 8's `kernels` line
     ends with lane_random: the draws of one image64/AA=5 step at 2048
     lanes replayed, held against the plain twin and timed beside it, its
     bound, the main path's (phase 4's) draw launches, and each mode timed
     alone in and out of a graph (`by_mode`), then lane_random_scene: the
     kernel's scene mode over the leaf-tree generators of sorting, the
     compositional example and goal finding at 2048 strided card keys,
     held 0 words apart from their plain bodies on the same keys, timed
     eagerly and in a graph beside them (`by_config`; sorting's head the
     entry), its bound from the blocks the scenes need, registers and
     spill of `lane_random_scene_kernel`, and phase 4's scene launches
     (two a fresh scene), then lane_random_tree: the kernel's tree mode
     over the roots of every config that takes it (TREE_CONFIGS) at 2048
     strided card keys, held 0 words apart from the composites' plain
     bodies over the leaves' scene mode and from every node's plain body,
     timed eagerly and in a graph beside the route before it (`by_config`;
     sorting's head the entry), its bound from the blocks the chosen
     branches need, registers and spill of `lane_random_tree_kernel` and
     of `lane_random_scene_kernel`, and phase 4's tree and scene launches
     (image64's Chain takes the tree mode), then scene_tables: the main
     path's tables from the kernel against the plain twin on the card and
     on the CPU in both fills and every colour route (0 values apart), its
     time beside the twin's eager and in a graph, its bound, registers and
     spill, and phase 4's launches (one a render), then task_eval: every
     shipped config's task in both modes on 2048 lanes of seeded scenes
     and on the edge states, the kernel's reward, success and validity
     held 0 words apart from the task's methods on the card, a step's three
     evaluations timed for the benchmarked rollout configs beside the
     methods eager and in a graph, the bound of their bytes, registers and
     spill, and phase 4's launches (three a step);
 13. the last line: {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py   (needs one CUDA card)
python3 -c 'import chip_smoke; chip_smoke.split_only()'   (phase 8's split)
python3 -c 'import chip_smoke; chip_smoke.packed_only()'  (packed_raster)
python3 -c 'import chip_smoke; chip_smoke.scene_only()'   (scene_raster)
"""

import contextlib
import dataclasses
import json
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 on the tensor cores, dense
BATCH = 2048
STEPS = 50
CHUNKS = 3
WARMUP_STEPS = 5
DEMO_BATCH = 256
DEMO_STEPS = 20
DEMO_WARMUP_STEPS = 3
DEMO_SIZE, DEMO_AA = 256, 10
# Phase 6: warm-up steps and one timed chunk longer than the longest
# episode (50 steps), so every lane ends one.
WORKLOAD_WARMUP_STEPS = 2
WORKLOAD_STEPS = 55


class SmokeFailure(RuntimeError):
    pass


def lane_keys(seed, shape, device="cuda"):
    """Keys int32[*shape, 2] of `split(key(seed), shape)`."""
    from spriteworld_torch.ops import lane_random

    return lane_random.split(lane_random.key(seed, device), shape)


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


def check_layouts(rasterize_cuda):
    """Phase 2: the dispatch's Python mirrors of the kernels' shared-memory
    layouts equal the kernels' own, over the shapes and downsample modes
    the phases use."""
    rc = rasterize_cuda
    scene_lib = rc._scene_launcher()[0]
    strip_lib = rc._strip_launchers()[0]
    packed_lib = rc._packed_launcher()[0]
    v = 30
    for (h, w, aa, k) in [(64, 64, 5, 6), (64, 64, 1, 8), (32, 32, 2, 8),
                          (64, 64, 6, 6), (256, 256, 10, 4), (128, 128, 5, 8),
                          (96, 160, 3, 8), (1024, 1024, 1, 8)]:
        hc, wc = h * aa, w * aa
        for ds in ((rc.DS_IDENTITY,) if aa == 1
                   else (rc.DS_LANCZOS, rc.DS_BOX)):
            lanczos = ds == rc.DS_LANCZOS
            cp = (rc.lanczos_tiles(wc, w).pitch if lanczos
                  else rc._round16(wc))
            wp, hp = rc.hpass_geometry(hc, h, w) if lanczos else (0, 0)
            want = scene_lib.scene_raster_smem_bytes(
                k, rc.table_width(v), hc, aa, cp, wp, hp)
            got = rc.scene_smem_bytes(k, v, hc, wc, h, w, ds)
            check(got == want, f"scene layout mirror {got} != {want} at "
                               f"{h}x{w}/AA={aa}, mode {ds}")
            if (h, w, aa) in ((64, 64, 5), (64, 64, 6)):
                blocks = scene_lib.scene_raster_blocks_per_sm(got,
                                                          int(lanczos))
                print(f"scene layout at {h}x{w}/AA={aa}, mode {ds}: {got} "
                      f"bytes, {blocks} resident blocks an SM")
            rows = min(hc, rc.default_strip_rows(
                hc, cp, 8 if lanczos else (aa if ds == rc.DS_BOX else 1)))
            want = strip_lib.strip_raster_smem_bytes(
                k, (rows + 7) // 8 * 8 if lanczos else rows, cp)
            got = rc.strip_smem_bytes(k, rows, wc, w if lanczos else None)
            check(got == want, f"strip layout mirror {got} != {want}")
            if (h, w, aa) == (256, 256, 10):
                blocks = strip_lib.strip_raster_blocks_per_sm(got,
                                                          int(lanczos))
                print(f"strip layout at 256x256/AA=10, mode {ds}: {rows} "
                      f"rows, {got} bytes, {blocks} resident blocks an SM")
    for k in (1, 6, 8, 16, 254):
        for rows in (16, 48, 64, 128):
            want = packed_lib.packed_raster_smem_bytes(k, v, rows)
            got = rc.packed_smem_bytes(k, v, rows)
            check(got == want, f"packed layout mirror {got} != {want} at "
                               f"K={k}, {rows} rows")
            if (k, rows) == (6, 64):
                blocks = packed_lib.packed_raster_blocks_per_sm(got, rows)
                print(f"packed layout at K=6, 64 rows: {got} bytes, "
                      f"{blocks} resident blocks an SM")
    print("shared-memory layout mirrors equal the kernels' own")


def strips_vs_plain(torch, rasterize_cuda, colors):
    """Phase 3, strips: every case bit-exact; returns the largest
    difference of (strip_raster, strip_vpass)."""
    rc = rasterize_cuda
    cases = [
        # (name, seed, b, image_size, aa, strip_rows, batch kw, render kw)
        ("256x256/AA=10 hsv", 11, 8, (256, 256), 10, None, {"hsv": True},
         {"color_to_rgb": colors.hsv_to_rgb}),
        ("128x128/AA=5", 12, 32, (128, 128), 5, None, {}, {}),
        ("64x64/AA=5 degenerate, 7-row strips", 13, 64, (64, 64), 5, 7,
         {"degenerate": True}, {}),
        ("96x160/AA=3 bg_color", 14, 16, (96, 160), 3, None, {},
         {"bg_color": (10, 20, 30)}),
        ("1024x1024/AA=1", 15, 4, (1024, 1024), 1, None, {}, {}),
    ]
    worst_fill = worst_v = 0
    for name, seed, b, size, aa, rows, bkw, rkw in cases:
        f, n = scene_batch(seed, b, **bkw)
        tables = rc.prepare(
            torch.from_numpy(f).cuda(), torch.from_numpy(n).cuda(),
            size[0] * aa, size[1] * aa, rkw.get("color_to_rgb"))
        bg = rkw.get("bg_color")
        got = rc.render_strips(tables, size, bg, rows)
        want = rc.render_rgb_batch_plain(tables, size, bg)
        torch.cuda.synchronize()
        err, count = compare(got, want)
        print(f"strip kernels vs plain, {name}, B={b}: max |diff| {err}, "
              f"{count} differing values")
        check(count == 0, f"strip kernels differ from the plain version "
                          f"({name})")
        if aa == 1:
            worst_fill = max(worst_fill, err)
            continue
        # Each kernel on its own: the h-pass, then the v-pass on the plain
        # h-pass, copied into the kernel's buffer layout.
        hp = rc.strip_raster(tables, size, bg, rows)
        hp_plain = rc.hpass_plain(tables, size[1], bg)
        err_h, count_h = compare(hp, hp_plain)
        _, hp_in = rc.hpass_buffer(b, tables.hc, size[0], size[1],
                                   hp_plain.device)
        hp_in.copy_(hp_plain)
        err_v, count_v = compare(rc.strip_vpass(hp_in, size[0]),
                                 rc.vpass_plain(hp_plain, size[0]))
        print(f"  h-pass vs plain: max |diff| {err_h}, {count_h} differing; "
              f"v-pass vs plain: max |diff| {err_v}, {count_v} differing")
        check(count_h == 0, f"strip h-pass differs ({name})")
        check(count_v == 0, f"strip v-pass differs ({name})")
        worst_fill = max(worst_fill, err, err_h)
        worst_v = max(worst_v, err_v)

    # The renderer's "auto" dispatch sends these canvases to the strips.
    from spriteworld_torch.core import renderers

    for size, aa in ((128, 5), (256, 10)):
        f, n = scene_batch(17, 4, hsv=True)
        f, n = torch.from_numpy(f).cuda(), torch.from_numpy(n).cuda()
        before = (rc.scene_raster.launches, rc.strip_raster.launches)
        got = renderers.ImageRenderer(
            (size, size), anti_aliasing=aa,
            color_to_rgb="hsv").render_batch(f, n, None)
        after = (rc.scene_raster.launches, rc.strip_raster.launches)
        want = rc.render_rgb_batch_plain(
            rc.prepare(f, n, size * aa, size * aa, colors.hsv_to_rgb),
            (size, size))
        err, count = compare(got, want)
        print(f"ImageRenderer({size}x{size}, anti_aliasing={aa}) on the "
              f"card: scene/strip launches {before} -> {after}, max |diff| "
              f"{err} against plain")
        check(after == (before[0], before[1] + 1),
              f"ImageRenderer at {size}x{size}/AA={aa} did not take the "
              "strip kernel")
        check(count == 0, f"ImageRenderer at {size}x{size}/AA={aa} differs "
                          "from the plain version")
        worst_fill = max(worst_fill, err)

    # Two independent kernels: strips forced at the main path's size against
    # the scene kernel.
    f, n = scene_batch(16, 256)
    tables = rc.prepare(torch.from_numpy(f).cuda(),
                        torch.from_numpy(n).cuda(), 320, 320, None)
    err, count = compare(rc.render_strips(tables, (64, 64), None, 48),
                         rc.scene_raster(tables, (64, 64)))
    print(f"strip kernels (48-row strips) vs scene kernel, 64x64/AA=5, "
          f"B=256: max |diff| {err}, {count} differing values")
    check(count == 0, "strip kernels differ from the scene kernel")
    return worst_fill, worst_v


def modes_vs_plain(torch, rasterize_cuda, colors):
    """Phase 3, the other modes: packed_raster, and the centroid and box
    modes of the scene and strip kernels, bit-exact against the plain
    version and against each other. Returns the largest difference by
    kernel and mode."""
    rc = rasterize_cuda
    worst = {}

    def record(key, got, want, what):
        err, count = compare(got, want)
        print(f"{what}: max |diff| {err}, {count} differing values")
        check(count == 0, f"{what} differs")
        worst[key] = max(worst.get(key, 0), err)

    def tables_of(seed, b, size, aa, pil_exact, bkw=None, rkw=None):
        f, n = scene_batch(seed, b, **(bkw or {}))
        return rc.prepare(torch.from_numpy(f).cuda(),
                          torch.from_numpy(n).cuda(), size[0] * aa,
                          size[1] * aa, (rkw or {}).get("color_to_rgb"),
                          pil_exact)

    hsv = {"color_to_rgb": colors.hsv_to_rgb}
    packed_cases = [
        # (label, seed, image_size, batch kw, render kw)
        ("64x64", 21, (64, 64), {}, {}),
        ("32x32", 22, (32, 32), {}, {}),
        ("16x16", 23, (16, 16), {}, {}),
        ("48x64", 24, (48, 64), {}, {}),
        ("64x64 bg_color", 25, (64, 64), {}, {"bg_color": (10, 20, 30)}),
        ("64x64 hsv", 26, (64, 64), {"hsv": True}, hsv),
        ("64x64 degenerate", 27, (64, 64), {"degenerate": True}, {}),
        # Rows of 3w bytes stored in 4-byte words (w = 4, 8) and in bytes
        # (w = 1, 2); frames taller than a tile (128 rows).
        ("16x8", 29, (16, 8), {}, {}),
        ("32x4", 30, (32, 4), {}, {}),
        ("64x2", 40, (64, 2), {}, {}),
        ("256x1", 41, (256, 1), {}, {}),
        ("384x8", 42, (384, 8), {}, {}),
        ("512x16", 43, (512, 16), {}, {}),
    ]
    for label, seed, size, bkw, rkw in packed_cases:
        for pe in (True, False):
            t = tables_of(seed, 256, size, 1, pe, bkw, rkw)
            bg = rkw.get("bg_color")
            mode = rc.mode_name(pe, rc.DS_IDENTITY)
            record(("packed_raster", mode), rc.packed_raster(t, size, bg),
                   rc.render_rgb_batch_plain(t, size, bg),
                   f"packed_raster vs plain, {label}, {mode}, B=256")
    # Two independent kernels at anti_aliasing=1.
    for pe in (True, False):
        t = tables_of(28, 256, (64, 64), 1, pe)
        mode = rc.mode_name(pe, rc.DS_IDENTITY)
        record(("packed_raster", mode), rc.packed_raster(t, (64, 64)),
               rc.scene_raster(t, (64, 64)),
               f"packed_raster vs scene kernel, 64x64/AA=1, {mode}, B=256")

    scene_cases = [
        # (label, seed, image_size, aa, pil_exact, downsample)
        ("64x64/AA=5", 31, (64, 64), 5, False, "auto"),
        ("32x32/AA=2", 32, (32, 32), 2, False, "auto"),
        ("64x64/AA=5", 33, (64, 64), 5, True, "box"),
        ("64x64/AA=6", 34, (64, 64), 6, False, "auto"),
        ("64x64/AA=6", 39, (64, 64), 6, True, "auto"),
    ]
    for label, seed, size, aa, pe, ds in scene_cases:
        t = tables_of(seed, 256, size, aa, pe)
        mode = rc.mode_name(pe, rc.downsample_mode(aa, pe, ds))
        record(("scene_raster", mode), rc.scene_raster(t, size, None, ds),
               rc.render_rgb_batch_plain(t, size, None, ds),
               f"scene kernel vs plain, {label}, {mode}, B=256")

    strip_cases = [
        # (label, seed, b, image_size, aa, strip_rows, render kw)
        ("256x256/AA=10 hsv", 35, 8, (256, 256), 10, None, hsv),
        ("128x128/AA=5", 36, 32, (128, 128), 5, None, {}),
        ("64x64/AA=5, 10-row strips", 37, 64, (64, 64), 5, 10, {}),
    ]
    for label, seed, b, size, aa, rows, rkw in strip_cases:
        t = tables_of(seed, b, size, aa, False, {"hsv": bool(rkw)}, rkw)
        mode = rc.mode_name(False, rc.DS_BOX)
        record(("strip_raster", mode), rc.render_strips(t, size, None, rows),
               rc.render_rgb_batch_plain(t, size),
               f"strip kernel vs plain, {label}, {mode}, B={b}")
    # Strips forced at the fast path's size against the scene kernel, in
    # both fills with the box filter.
    for pe in (True, False):
        t = tables_of(38, 256, (64, 64), 5, pe)
        mode = rc.mode_name(pe, rc.DS_BOX)
        record(("strip_raster", mode),
               rc.render_strips(t, (64, 64), None, 15, "box"),
               rc.scene_raster(t, (64, 64), None, "box"),
               f"strip kernel (15-row strips) vs scene kernel, 64x64/AA=5, "
               f"{mode}, B=256")
    return worst


# tests_tpu/test_mosaic_parity.py's CASES, each with the kernel it runs.
CASES = [
    # (image_size, aa, pil_exact, downsample, kernel_mode, kernel)
    ((64, 64), 1, True, "auto", "auto", "packed_raster"),
    ((64, 64), 1, False, "auto", "auto", "packed_raster"),
    ((32, 32), 2, True, "auto", "auto", "scene_raster"),
    ((32, 32), 2, False, "auto", "auto", "scene_raster"),
    ((64, 64), 5, True, "auto", "auto", "scene_raster"),
    ((64, 64), 5, False, "auto", "auto", "scene_raster"),
    ((64, 64), 5, True, "box", "auto", "scene_raster"),
    ((64, 64), 5, True, "auto", "strips", "strip_raster"),
    ((64, 64), 5, False, "auto", "strips", "strip_raster"),
    ((64, 64), 1, True, "auto", "scene", "scene_raster"),
]


def check_cases(torch, rasterize_cuda):
    """Phase 3: the mosaic-parity CASES through the renderer's dispatch,
    each against the plain version on the card, each through its kernel.
    Returns the largest difference."""
    rc = rasterize_cuda
    kernels = (rc.scene_raster, rc.strip_raster, rc.strip_vpass,
               rc.packed_raster)
    worst = 0
    for i, (size, aa, pe, ds, km, kernel) in enumerate(CASES):
        f, n = scene_batch(40 + i, 64)
        f, n = torch.from_numpy(f).cuda(), torch.from_numpy(n).cuda()
        before = {k.__name__: k.launches for k in kernels}
        got = rc.render_rgb_batch(f, n, image_size=size, anti_aliasing=aa,
                                  pil_exact=pe, downsample=ds,
                                  kernel_mode=km)
        ran = sorted(k.__name__ for k in kernels
                     if k.launches != before[k.__name__])
        t = rc.prepare(f, n, size[0] * aa, size[1] * aa, None, pe)
        err, count = compare(got, rc.render_rgb_batch_plain(t, size, None,
                                                            ds))
        print(f"CASE {size} AA={aa} pil_exact={pe} downsample={ds} "
              f"kernel_mode={km}: ran {ran}, max |diff| {err}, {count} "
              "differing values")
        want = [kernel]
        if kernel == "strip_raster" and rc.downsample_mode(
                aa, pe, ds) == rc.DS_LANCZOS:
            want = ["strip_raster", "strip_vpass"]
        check(ran == want, f"CASE {i} ran {ran}, not {want}")
        check(count == 0, f"CASE {i} differs from the plain version")
        worst = max(worst, err)
    return worst


def drive(torch, benv, steps, chunks, warmup, image_shape, bad_rewards_of,
          label, moved_of=None):
    """Reset, `warmup` steps, then `chunks` timed chunks of `steps` steps,
    each step synchronised and checked: step types follow FIRST/MID/LAST,
    no image is blank (where the workload renders one, of `image_shape`),
    `bad_rewards_of(state, ts, first)` flags no lane, and, given
    `moved_of(before, state, ts)`, some lane moved. Returns (best steps/s,
    final state, renders)."""
    from spriteworld_torch.core.state import StepType

    dev = benv.env.device
    state, ts = benv.reset()
    renders = 1
    prev_type = ts.step_type
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    bad_types = bad_rewards = blank = moved = zero
    seen = torch.zeros(3, dtype=torch.int64, device=dev)

    def step():
        nonlocal state, ts, prev_type, bad_types, bad_rewards, blank, seen
        nonlocal moved
        # The step donates its state (its buffers come back): keep a copy
        # of the state the body moved from.
        before = state.clone() if moved_of is not None else None
        state, ts = benv.step(state, benv.sample_actions())
        torch.cuda.synchronize()
        cur = ts.step_type
        first = cur == StepType.FIRST
        after_last = prev_type == StepType.LAST
        bad_types = bad_types + (first != after_last).sum()
        bad_rewards = bad_rewards + bad_rewards_of(state, ts, first).sum()
        if image_shape is not None:
            blank = blank + (ts.observation["image"].amax(dim=(1, 2, 3))
                             == 0).sum()
        if moved_of is not None:
            moved = moved + moved_of(before, state, ts).sum()
        seen = seen + torch.bincount(cur.long(), minlength=3)
        prev_type = cur

    for _ in range(warmup):
        step()
    renders += warmup
    best = float("inf")
    for c in range(chunks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        renders += steps
        print(f"{label} chunk {c}: {steps} steps x {benv.num_envs} lanes in "
              f"{dt:.4f} s")
    if image_shape is not None:
        image = ts.observation["image"]
        check(tuple(image.shape) == (benv.num_envs,) + image_shape
              and image.dtype == torch.uint8, f"image {tuple(image.shape)}")
    print(f"{label}: step types seen (FIRST, MID, LAST) {seen.tolist()}")
    check(int(bad_types) == 0, f"{int(bad_types)} bad step-type transitions")
    check(int(bad_rewards) == 0, f"{int(bad_rewards)} bad rewards")
    check(int(blank) == 0, f"{int(blank)} blank images")
    check(int(seen[2]) > 0 and int(seen[0]) > 0, "no episode ended")
    if moved_of is not None:
        print(f"{label}: {int(moved)} lane-steps moved the body")
        check(int(moved) > 0, "no action moved a body")
    return benv.num_envs * steps / best, state, renders


def drive_main_path(torch, bench_torch, env_lib, rasterize_cuda):
    """Phase 4: image64 at AA=5 over 2048 lanes. Returns (steps/s, state,
    scene_raster launches, lane_random draw launches, lane_random scene
    launches, lane_random tree launches)."""
    from spriteworld_torch.ops import lane_random

    env = bench_torch.build_env(anti_aliasing=5, device="cuda", seed=0)
    benv = env_lib.BatchedEnvironment(env, BATCH, use_graph=False)
    task = env.task

    def bad_rewards(state, ts, first):
        empty = ~task.filter_mask(state.factors, state.num_sprites).any(-1)
        return (torch.isnan(ts.reward) != (~first & empty)) \
            | torch.isinf(ts.reward)

    rasterize_cuda.reset_launch_counts()
    lane_random.reset_launch_counts()
    rate, state, renders = drive(torch, benv, STEPS, CHUNKS, WARMUP_STEPS,
                                 (64, 64, 3), bad_rewards, "main path")
    launches = rasterize_cuda.scene_raster.launches
    tables = rasterize_cuda.scene_tables.launches
    scenes = lane_random.threefry_launch.by_mode.get("scene", 0)
    trees = lane_random.threefry_launch.by_mode.get("tree", 0)
    draws = lane_random.threefry_launch.launches - scenes - trees
    print(f"scene_raster launches {launches} for {renders} renders; "
          f"scene_tables launches {tables} "
          f"{json.dumps(rasterize_cuda.scene_tables.by_mode)}; "
          f"lane_random launches {draws + scenes + trees} "
          f"{json.dumps(lane_random.threefry_launch.by_mode)}")
    check(launches == renders, "a render did not go through the kernel")
    check(tables == renders, "a render's tables did not come from the "
          "scene_tables kernel")
    check(draws > 0, "no draw went through the lane_random kernel")
    check(scenes + trees > 0, "no fresh scene went through the lane_random "
          "kernel's scene or tree mode")
    return rate, state, launches, draws, scenes, trees


def drive_demo_path(torch, bench_torch, env_lib, rasterize_cuda):
    """Phase 5: the demo's clustering scene at 256x256/AA=10 over 256 lanes.
    Returns (steps/s, state, {kernel: launches})."""
    env = bench_torch.build_demo_env(anti_aliasing=DEMO_AA,
                                     render_size=DEMO_SIZE, device="cuda",
                                     seed=0)
    benv = env_lib.BatchedEnvironment(env, DEMO_BATCH, use_graph=False)

    def bad_rewards(state, ts, first):
        return ~torch.isfinite(ts.reward) & state.task_valid

    rasterize_cuda.reset_launch_counts()
    rate, state, renders = drive(
        torch, benv, DEMO_STEPS, CHUNKS, DEMO_WARMUP_STEPS,
        (DEMO_SIZE, DEMO_SIZE, 3), bad_rewards, "demo path")
    launches = {fn.__name__: fn.launches for fn in (
        rasterize_cuda.strip_raster, rasterize_cuda.strip_vpass,
        rasterize_cuda.scene_raster)}
    print(f"demo path launches {launches} for {renders} renders; "
          f"task valid on {int(state.task_valid.sum())} of {DEMO_BATCH} "
          "lanes")
    check(launches["strip_raster"] == renders
          and launches["strip_vpass"] == renders,
          "a demo render did not go through the strip kernels")
    check(launches["scene_raster"] == 0, "a demo render took the scene "
                                         "kernel")
    return rate, state, launches


# Phase 6: (label, bench_torch workload, anti_aliasing, pil_exact, lanes,
# the kernel and mode every render must take, or None for no kernel).
WORKLOADS = [
    ("image64 AA=1", "image64", 1, True, BATCH,
     ("packed_raster", "exact+identity")),
    ("image64 AA=1 fast", "image64", 1, False, BATCH,
     ("packed_raster", "centroid+identity")),
    ("image64 AA=5 fast", "image64", 5, False, BATCH,
     ("scene_raster", "centroid+box")),
    ("factors", "factors", None, True, BATCH, None),
    ("clustering", "clustering", None, True, BATCH,
     ("scene_raster", "exact+lanczos")),
    ("sorting", "sorting", None, True, BATCH,
     ("scene_raster", "exact+lanczos")),
    ("embodied", "embodied", None, True, BATCH,
     ("scene_raster", "exact+lanczos")),
    ("demo256 fast", "demo256", DEMO_AA, False, DEMO_BATCH,
     ("strip_raster", "centroid+box")),
]


def drive_workloads(torch, bench_torch, env_lib, rasterize_cuda, card):
    """Phase 6: every bench.py workload, and demo256 fast. Returns {label:
    (steps/s, final state, {kernel: {mode: launches}})}."""
    rc = rasterize_cuda
    kernels = (rc.scene_raster, rc.strip_raster, rc.strip_vpass,
               rc.packed_raster)
    out = {}
    for label, name, aa, exact, lanes, want in WORKLOADS:
        env, _, _ = bench_torch.build(name, aa, exact, device="cuda", seed=0)
        benv = env_lib.BatchedEnvironment(env, lanes, use_graph=False)
        task = env.task
        if hasattr(task, "filter_mask"):  # FindGoalPosition
            def bad_rewards(state, ts, first, task=task):
                empty = ~task.filter_mask(state.factors,
                                          state.num_sprites).any(-1)
                return (torch.isnan(ts.reward) != (~first & empty)) \
                    | torch.isinf(ts.reward)
        else:
            def bad_rewards(state, ts, first):
                return ~torch.isfinite(ts.reward) & state.task_valid
        moved_of = None
        if name == "embodied":
            def moved_of(before, state, ts):
                b = torch.arange(lanes, device=state.factors.device)
                body = (before.num_sprites - 1).clamp(min=0).long()
                was = before.factors[b, body, 0:2]
                now = state.factors[b, body, 0:2]
                return (ts.step_type != 0) & (was != now).any(-1)
        image_shape = None
        if "image" in env.renderers:
            image_shape = env.renderers["image"].image_size + (3,)
        rc.reset_launch_counts()
        rate, state, renders = drive(
            torch, benv, WORKLOAD_STEPS, 1, WORKLOAD_WARMUP_STEPS,
            image_shape, bad_rewards, label, moved_of)
        launches = {k.__name__: dict(k.by_mode) for k in kernels}
        print(f"{label} launches {launches} for {renders} renders")
        expected = {k.__name__: {} for k in kernels}
        if want is not None:
            expected[want[0]] = {want[1]: renders}
        check(launches == expected,
              f"{label}: a render did not take {want}")
        print(f"env_steps_per_sec {rate:.1f} ({label}, {lanes} lanes) on "
              f"{card}")
        out[label] = (rate, state, launches)
    return out


# Phase 7, the runner: (label, bench_torch workload, anti_aliasing, lanes,
# {kernel: mode} that the captured step launches).
RUNNER_PATHS = [
    ("image64 AA=5", "image64", 5, BATCH, {"scene_raster": "exact+lanczos"}),
    ("image64 AA=1", "image64", 1, BATCH,
     {"packed_raster": "exact+identity"}),
    ("sorting", "sorting", None, BATCH, {"scene_raster": "exact+lanczos"}),
    ("demo256", "demo256", DEMO_AA, DEMO_BATCH,
     {"strip_raster": "exact+lanczos", "strip_vpass": "lanczos"}),
    ("embodied", "embodied", None, BATCH, {"scene_raster": "exact+lanczos"}),
]
RUNNER_STEPS = 8  # the compared chunk, with stacked timesteps
RUNNER_TIMED_STEPS = 20  # steps of each timed chunk
RUNNER_PAIRS = 3  # timed graph/eager chunk pairs


def launch_counts(rasterize_cuda):
    rc = rasterize_cuda
    return {k.__name__: dict(k.by_mode) for k in (
        rc.scene_raster, rc.strip_raster, rc.strip_vpass, rc.packed_raster)}


def equal_runs(torch, a, b, what):
    """Checks two (state, Metrics, stacked TimeStep) results bit-equal."""
    from spriteworld_torch.core.state import STATE_FIELDS

    (sa, ma, ta), (sb, mb, tb) = a, b
    for name in STATE_FIELDS:
        check(torch.equal(getattr(sa, name), getattr(sb, name)),
              f"{what}: state field {name} differs")
    for name in ("step_type", "discount"):
        check(torch.equal(getattr(ta, name), getattr(tb, name)),
              f"{what}: {name} differs")
    check(torch.equal(ta.reward.nan_to_num(), tb.reward.nan_to_num())
          and torch.equal(ta.reward.isnan(), tb.reward.isnan()),
          f"{what}: rewards differ")
    for key in ta.observation:
        check(torch.equal(ta.observation[key], tb.observation[key]),
              f"{what}: observation {key} differs")
    check(ma == mb, f"{what}: metrics differ ({ma} against {mb})")


def metrics_of(tss, ret_acc):
    """(episodes, successes, return sum, reward sum) recomputed on the host
    in float64 from stacked timesteps, from per-lane returns `ret_acc`."""
    reward = np.nan_to_num(tss.reward.cpu().numpy().astype(np.float64))
    last = tss.step_type.cpu().numpy() == 2
    succ = tss.observation["success"].cpu().numpy()
    acc = ret_acc.cpu().numpy().astype(np.float64)
    returns = 0.0
    for t in range(reward.shape[0]):
        acc += reward[t]
        returns += acc[last[t]].sum()
        acc[last[t]] = 0.0
    return (int(last.sum()), int((last & succ).sum()), returns,
            float(reward.sum()))


def low_acceptance_env(bench_torch, env_lib, device="cuda",
                       image_size=(64, 64)):
    """image64 at AA=1 whose sprite x comes from a Selection that accepts
    4% of its proposals: at 2048 lanes x 6 sprites a step's fresh scenes
    leave elements pending after the first rejection round (an element
    stays pending with chance 0.96^32 = 0.27, so at one lane most steps
    do)."""
    from spriteworld_torch.core import actions, renderers
    from spriteworld_torch.core import distributions as d
    from spriteworld_torch.core import generators

    task, _ = bench_torch.goal_finding_parts()
    pos = d.Selection(d.Product([d.Continuous("x", 0.0, 1.0),
                                 d.Continuous("y", 0.1, 0.9)]),
                      d.Continuous("x", 0.3, 0.34))
    sprites = generators.generate_sprites(d.Product([
        pos, d.Discrete("shape", ["square", "triangle", "star_5"]),
        d.Continuous("angle", 0, 360), d.Continuous("scale", 0.1, 0.2),
        d.Continuous("c0", 0.0, 0.9), d.Continuous("c1", 0.3, 1.0),
        d.Continuous("c2", 0.9, 1.0)]), num_sprites=6)
    return env_lib.Environment(
        task=task, action_space=actions.SelectMove(scale=0.25),
        renderers={"image": renderers.ImageRenderer(
                       image_size, anti_aliasing=1, color_to_rgb="hsv"),
                   "success": renderers.Success()},
        init_sprites=sprites, max_episode_length=20, device=device, seed=0)


def drive_runner(torch, bench_torch, env_lib, rasterize_cuda, card):
    """Phase 7: each path through ShardedRunner. The first chunk captures
    a graph (one warm-up launch and one captured launch of each of the
    path's kernels, none other; replays add none) and its stacked
    timesteps and metrics must equal, bit for bit, the eager runner's from
    the same state and action key, run under torch.cuda.set_sync_debug_mode
    ("error"); the metrics must agree with the timesteps; two replays of a
    one-step graph from one state must take the same fresh scenes (the
    lanes' keys) and different actions (the runner's action key goes on);
    then timed graph/eager chunk pairs. Last, a chunk whose fresh scenes
    leave rejection elements pending runs again, and must equal the plain
    eager step loop. Returns {label: (graph env-steps/s, eager)}."""
    from spriteworld_torch.ops import lane_random
    from spriteworld_torch.parallel import ShardedRunner

    rates = {}
    for label, name, aa, lanes, kernels in RUNNER_PATHS:
        env, _, _ = bench_torch.build(name, aa, True, device="cuda", seed=0)
        graph = ShardedRunner(env, lanes)
        eager = ShardedRunner(env, lanes, use_graph=False)
        check(graph.use_graph, "the runner does not default to a graph")
        start, _ = graph.reset(1)
        eager.action_key = graph.action_key
        rasterize_cuda.reset_launch_counts()
        ran_graph = graph.rollout(start, RUNNER_STEPS, return_timesteps=True)
        captured = launch_counts(rasterize_cuda)
        want = {k: {} for k in captured}
        for k, mode in kernels.items():
            want[k] = {mode: 2}
        print(f"runner {label}: launches through the wrappers while "
              f"capturing and replaying {RUNNER_STEPS} steps: {captured}")
        check(captured == want, f"runner {label}: the captured step did "
                                f"not launch {kernels} (once to warm up, "
                                "once captured) and nothing else")
        eager.episode_returns = np.zeros(lanes, np.float32)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ran_eager = eager.rollout(start, RUNNER_STEPS,
                                      return_timesteps=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(launch_counts(rasterize_cuda) == {
            k: {m: n + (RUNNER_STEPS if k in kernels else 0)
                for m, n in v.items()} for k, v in want.items()},
            f"runner {label}: an eager step did not launch the kernels")
        equal_runs(torch, ran_graph, ran_eager, f"runner {label}")
        _, m, tss = ran_graph
        host = metrics_of(tss, torch.zeros(lanes))
        check((m.episodes, m.successes) == host[:2]
              and abs(m.return_sum - host[2]) <= 1e-4 * max(1, abs(host[2]))
              and abs(m.reward_sum - host[3]) <= 1e-4 * abs(host[3]),
              f"runner {label}: metrics {m} disagree with the timesteps "
              f"{host}")
        image = tss.observation["image"]
        side = DEMO_SIZE if name == "demo256" else 64
        check(tuple(image.shape) == (RUNNER_STEPS, lanes, side * side * 3)
              and int(image.amax(-1).eq(0).sum()) == 0,
              f"runner {label}: images {tuple(image.shape)} or blank")
        print(f"runner {label}: graph and eager chunks equal; {m}")

        # Two replays of one graph from one state: from the initial state
        # every lane takes the fresh scene of its key, the same twice,
        # and a policy that keeps its actions in a buffer shows them
        # drawn anew from the runner's action key, which goes on.
        a, _ = graph.rollout(env.initial_state(lanes), 1)
        b, _ = graph.rollout(env.initial_state(lanes), 1)
        fresh = (a.factors == b.factors).flatten(1).all(1)
        seen = env.sample_action(lane_random.split(
            lane_random.key(0, env.device), lanes))

        def recording(keys, state, seen=seen, env=env):
            actions = env.sample_action(keys)
            seen.copy_(actions)
            return actions

        recorder = ShardedRunner(env, lanes, policy=recording)
        recorder.rollout(ran_graph[0], 1)
        first = seen.clone()
        recorder.rollout(ran_graph[0], 1)
        drawn = (first != seen).flatten(1).any(1)
        print(f"runner {label}: two replays from one state: fresh scenes "
              f"equal in {int(fresh.sum())}, actions differ in "
              f"{int(drawn.sum())} of {lanes} lanes")
        # Integer actions take few values, so two draws of a lane agree by
        # chance (Embodied's: 1 in 8): most lanes, not all, must differ.
        anew = bool(drawn.all()) if seen.is_floating_point() \
            else 2 * int(drawn.sum()) > lanes
        check(bool(fresh.all()) and anew,
              f"runner {label}: a replay's draws are not those of its "
              "keys")

        times, _ = bench_torch.timed_chunks(
            {"graph": graph, "eager": eager}, RUNNER_TIMED_STEPS,
            2 * RUNNER_PAIRS)
        rate = {k: lanes * RUNNER_TIMED_STEPS / min(v)
                for k, v in times.items()}
        print(f"env_steps_per_sec graph {rate['graph']:.1f} eager "
              f"{rate['eager']:.1f} ({label}, {lanes} lanes, runner, best "
              f"of {2 * RUNNER_PAIRS} chunks of {RUNNER_TIMED_STEPS} "
              f"steps each, alternating) on {card}; chunk seconds "
              f"{json.dumps(times)}")
        check(graph.reruns == 0 and eager.reruns == 0,
              f"runner {label}: a chunk ran again")
        keys = lane_random.split(lane_random.key(3, env.device), lanes)
        fresh_ms = graph_ms(torch, lambda: env.initial_state(keys), 10)
        print(f"runner {label}: fresh scenes for all {lanes} lanes, as "
              f"every step samples them: {fresh_ms:.4f} ms of device time "
              f"in a graph, on {card}")
        rates[label] = (rate["graph"], rate["eager"])

    env = low_acceptance_env(bench_torch, env_lib)
    runner = ShardedRunner(env, BATCH)
    start, _ = runner.reset(2)
    action_key = runner.action_key
    ran = runner.rollout(start, 4, return_timesteps=True)
    check(runner.reruns == 1, f"the low-acceptance chunk ran "
                              f"{runner.reruns} times again, not once")
    check(bool(ran[0].sample_ok.all()), "a lane's scene was not sampled")
    state = start
    for t in range(4):
        action_key, step_key = lane_random.split(action_key, 2)
        state, ts = env.step_batch(state, env.sample_action(
            lane_random.split(step_key, BATCH)))
        check(torch.equal(ts.observation["image"].reshape(BATCH, -1),
                          ran[2].observation["image"][t])
              and torch.equal(ts.step_type, ran[2].step_type[t]),
              f"re-run chunk step {t} differs from the eager loop")
    from spriteworld_torch.core.state import STATE_FIELDS
    for name in STATE_FIELDS:
        check(torch.equal(getattr(state, name), getattr(ran[0], name)),
              f"re-run chunk: state field {name} differs")
    print("runner: a chunk with rejection pending after the first round "
          "ran again and equals the eager loop")
    return rates


# Phase 9, the single env. Each kernel and mode of the path at B = 1, 2
# and 3 against its plain version: (label, image_size, anti_aliasing,
# pil_exact, {kernel: mode} the dispatch launches, or None where the
# dispatch's pick is printed and held against plain).
SINGLE_CASES = [
    ("scene, exact+lanczos", (64, 64), 5, True,
     {"scene_raster": "exact+lanczos"}),
    ("scene, centroid+box", (64, 64), 5, False,
     {"scene_raster": "centroid+box"}),
    ("strips, exact+lanczos", (DEMO_SIZE, DEMO_SIZE), DEMO_AA, True,
     {"strip_raster": "exact+lanczos", "strip_vpass": "lanczos"}),
    ("strips, centroid+box", (DEMO_SIZE, DEMO_SIZE), DEMO_AA, False,
     {"strip_raster": "centroid+box"}),
    ("packed, exact", (64, 64), 1, True,
     {"packed_raster": "exact+identity"}),
    ("packed, centroid", (64, 64), 1, False,
     {"packed_raster": "centroid+identity"}),
    ("setup_run_ui's default", (DEMO_SIZE, DEMO_SIZE), 1, True, None),
]
SINGLE_BATCHES = (1, 2, 3)
SINGLE_MAX_STEPS = 30  # record_episode's steps at most
SINGLE_WARMUP_STEPS = 3
SINGLE_TIMED_STEPS = 20
SINGLE_PROFILED_STEPS = 5


def batch_counts(rasterize_cuda):
    rc = rasterize_cuda
    return {k.__name__: dict(k.by_batch) for k in (
        rc.scene_raster, rc.strip_raster, rc.strip_vpass, rc.packed_raster)}


def single_vs_plain(torch, rasterize_cuda, colors, dev="cuda"):
    """Phase 9.1: every case of SINGLE_CASES at each of SINGLE_BATCHES
    through the renderer's dispatch, each launching its kernel and mode
    once at that batch and no other, against the plain version on the
    card. Returns the largest difference."""
    rc = rasterize_cuda
    worst = 0
    for i, (label, size, aa, pe, want) in enumerate(SINGLE_CASES):
        for b in SINGLE_BATCHES:
            f, n = scene_batch(90 + i, b, hsv=True)
            f = torch.from_numpy(f).to(dev)
            n = torch.from_numpy(n).to(dev)
            rc.reset_launch_counts()
            got = rc.render_rgb_batch(
                f, n, image_size=size, anti_aliasing=aa,
                color_to_rgb=colors.hsv_to_rgb, pil_exact=pe)
            ran = {k: v for k, v in launch_counts(rc).items() if v}
            batches = {k: v for k, v in batch_counts(rc).items() if v}
            t = rc.prepare(f, n, size[0] * aa, size[1] * aa,
                           colors.hsv_to_rgb, pe)
            err, count = compare(got, rc.render_rgb_batch_plain(t, size))
            print(f"single env, {label} {size[0]}x{size[1]}/AA={aa}, B={b}:"
                  f" ran {ran}, max |diff| {err}, {count} differing values")
            if want is None:
                check(len(ran) == 1, f"{label}: ran {ran}")
            else:
                check(ran == {k: {m: 1} for k, m in want.items()},
                      f"{label}, B={b}: ran {ran}, not {want}")
            check(batches == {k: {b: 1} for k in ran},
                  f"{label}, B={b}: launched at batches {batches}")
            check(count == 0, f"{label}, B={b}: differs from plain")
            worst = max(worst, err)
    return worst


def single_env_paths(bench_torch, dev="cuda"):
    """Phase 9's four configs: [(label, env, {kernel: mode} each render
    launches)]."""
    lanczos = {"scene_raster": "exact+lanczos"}
    return [
        ("goal_finding_new_position 64x64/AA=5",
         bench_torch.config_env("cobra.goal_finding_new_position",
                                device=dev, seed=0), lanczos),
        ("sorting 64x64/AA=5",
         bench_torch.config_env("cobra.sorting", device=dev, seed=0),
         lanczos),
        ("demo 256x256/AA=10",
         bench_torch.build_demo_env(anti_aliasing=DEMO_AA,
                                    render_size=DEMO_SIZE, device=dev,
                                    seed=0),
         {"strip_raster": "exact+lanczos", "strip_vpass": "lanczos"}),
        ("image64 64x64/AA=1",
         bench_torch.build_env(anti_aliasing=1, device=dev, seed=0),
         {"packed_raster": "exact+identity"}),
    ]


def scripted_policy(torch, env):
    """A deterministic click policy: at step t, click the centre of live
    sprite t mod n and move it a tenth of a frame at most toward the
    frame's centre, through SelectMove's or DragAndDrop's second click."""
    from spriteworld_torch.core import actions
    from spriteworld_torch.utils import device as device_lib

    space = env.action_space
    drag = isinstance(space, actions.DragAndDrop)
    steps = [0]

    def policy(keys, state):
        del keys
        host = device_lib.to_host({"pos": state.factors[0, :, 0:2],
                                   "n": state.num_sprites[0]})
        k = steps[0] % max(1, int(host["n"]))
        steps[0] += 1
        pos = host["pos"][k]
        click = np.clip((0.5 - pos) * 0.5, -0.1, 0.1) / space._scale
        click = click + (pos if drag else 0.5)
        return torch.as_tensor(np.concatenate([pos, click])[None],
                               dtype=torch.float32, device=env.device)

    return policy


def plain_frames(rasterize_cuda, renderer, factors, num_sprites):
    """The images of `renderer` for scenes [T, K, 10] through the plain
    version on the scenes' device."""
    size, aa = renderer.image_size, renderer._anti_aliasing
    tables = rasterize_cuda.prepare(factors, num_sprites, size[0] * aa,
                                    size[1] * aa, renderer._color_to_rgb,
                                    renderer._pil_exact)
    return rasterize_cuda.render_rgb_batch_plain(
        tables, size, renderer._bg_color, renderer._downsample)


def record_single(torch, bench_torch, rasterize_cuda, dev="cuda"):
    """Phase 9.2: media.record_episode at B=1, eager, on each config of
    `single_env_paths` with `scripted_policy`, up to SINGLE_MAX_STEPS
    steps: every frame equals the plain version's render of its state,
    and every render launched the config's kernels and modes at B=1, once
    a frame. Returns {label: (frames, raster launches)}."""
    from spriteworld_torch.utils import media

    rc = rasterize_cuda
    out = {}
    for label, env, kernels in single_env_paths(bench_torch, dev):
        rc.reset_launch_counts()
        frames, states = media.record_episode(
            env, 0, max_steps=SINGLE_MAX_STEPS,
            policy=scripted_policy(torch, env), return_states=True,
            use_graph=False)
        counts = {k: v for k, v in launch_counts(rc).items() if v}
        batches = {k: v for k, v in batch_counts(rc).items() if v}
        renders = len(frames)
        want = plain_frames(
            rc, env.renderers["image"],
            torch.cat([s.factors for s in states]),
            torch.cat([s.num_sprites for s in states]))
        err, count = compare(torch.from_numpy(frames).to(dev), want)
        blank = int((want.amax(dim=(1, 2, 3)) == 0).sum())
        print(f"single env record_episode, {label}: {renders} frames, "
              f"launches {counts} at batches {batches}; frames against "
              f"plain renders of their states: max |diff| {err}, {count} "
              f"differing values, {blank} blank")
        check(counts == {k: {m: renders} for k, m in kernels.items()},
              f"{label}: launches {counts}, not {kernels} once a frame")
        check(batches == {k: {1: renders} for k in kernels},
              f"{label}: launched at batches {batches}, not 1")
        check(count == 0, f"{label}: a frame differs from plain")
        check(blank == 0 and renders >= 2, f"{label}: blank or no steps")
        out[label] = (frames, counts)
    return out


def run_loop_single(torch, rasterize_cuda, dev="cuda"):
    """Phase 9.3: example_run_loop_torch.run at 4 lanes with images, one
    episode a lane: one log line per finished episode, its reset and step
    replayed from graphs of scene_raster at B=4."""
    import logging

    import example_run_loop_torch

    lines = []

    class Collect(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = example_run_loop_torch.logger
    handler = Collect(logging.INFO)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    rasterize_cuda.reset_launch_counts()
    try:
        episodes = example_run_loop_torch.run(
            num_episodes=1, num_envs=4, render_images=True, device=dev)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    batches = {k: v for k, v in batch_counts(rasterize_cuda).items() if v}
    logged = [m for m in lines if m.startswith("Episode done")]
    print(f"single env example_run_loop_torch.run: {len(episodes)} "
          f"episodes, {len(logged)} log lines, launches at batches "
          f"{batches}; first: {logged[:1]}")
    check(len(logged) == len(episodes) and 4 <= len(episodes) < 8,
          "example_run_loop_torch.run did not log each episode once")
    # BatchedEnvironment replays graphs: the kernel launched only to warm
    # up and capture the reset and the step.
    check(batches == {"scene_raster": {4: 4}},
          f"example_run_loop_torch.run launched {batches}")


def adapter_single(torch, bench_torch, dev="cuda"):
    """Phase 9.4: the dm_env adapter where dm_env is installed (reset, then
    steps of `action_space.sample()`, each observation held to
    `observation_spec`), and make_gifs_torch, writing its GIF where Pillow
    is installed."""
    import importlib.util
    import os
    import tempfile

    import make_gifs_torch

    if importlib.util.find_spec("dm_env") is None:
        print("dm_env is not installed on this machine: the dm_env adapter "
              "was held on the CPU only (tests/test_torch_adapters.py)")
    else:
        from spriteworld_torch.adapters import dm_env_adapter

        for label, cfg in (
                ("goal_finding_new_position",
                 bench_torch.config_of("cobra.goal_finding_new_position")),
                ("demo", bench_torch.demo_config())):
            env = dm_env_adapter.Environment(**cfg, seed=0, device=dev)
            spec = env.observation_spec()
            ts = env.reset()
            for i in range(SINGLE_TIMED_STEPS + 1):
                if i:
                    ts = env.step(env.action_space.sample())
                for name, s in spec.items():
                    s.validate(np.asarray(ts.observation[name]))
            print(f"dm_env adapter, {label}: reset and "
                  f"{SINGLE_TIMED_STEPS} steps of action_space.sample(), "
                  f"every observation of its spec's shape and dtype")
    if importlib.util.find_spec("PIL") is None:
        frames = make_gifs_torch.record("goal_finding_video", 4, dev,
                                        SINGLE_MAX_STEPS)
        print(f"Pillow is not installed on this machine: make_gifs_torch "
              f"recorded {len(frames)} frames and wrote no GIF")
    else:
        with tempfile.TemporaryDirectory() as out:
            path = make_gifs_torch.make_gif("goal_finding_video", out, 4, 2,
                                            dev, SINGLE_MAX_STEPS)
            size = os.path.getsize(path)
        print(f"Pillow is installed: make_gifs_torch wrote "
              f"goal_finding_video.gif ({size} bytes)")
        check(size > 0, "make_gifs_torch wrote an empty GIF")


def time_single(torch, bench_torch, rasterize_cuda, card, dev="cuda"):
    """Phase 9.5: wall ms an eager single-env step (`media.step_frame` with
    use_graph=False: the step at B=1 and its one device-to-host copy) on
    each config of `single_env_paths`, median and best of
    SINGLE_TIMED_STEPS steps of pre-drawn random actions after
    SINGLE_WARMUP_STEPS; the raster kernels' launches a step from their
    counters, and every kernel's launches and device-busy ms a step from
    torch.profiler over SINGLE_PROFILED_STEPS more. Returns {label:
    {...}}."""
    import statistics

    from spriteworld_torch.utils import media

    rc = rasterize_cuda
    out = {}
    for label, env, kernels in single_env_paths(bench_torch, dev):
        state, _ = env.reset_batch(1)
        actions = list(env.sample_action(lane_keys(1, (
            SINGLE_WARMUP_STEPS + SINGLE_TIMED_STEPS
            + SINGLE_PROFILED_STEPS, 1), env.device)))
        torch.cuda.synchronize()
        ms = []
        for i in range(SINGLE_WARMUP_STEPS + SINGLE_TIMED_STEPS):
            if i == SINGLE_WARMUP_STEPS:
                rc.reset_launch_counts()
            t0 = time.perf_counter()
            state, _, _ = media.step_frame(env, state, actions[i],
                                           use_graph=False)
            ms.append((time.perf_counter() - t0) * 1e3)
        ms = ms[SINGLE_WARMUP_STEPS:]
        raster = {k: {m: c / SINGLE_TIMED_STEPS for m, c in v.items()}
                  for k, v in launch_counts(rc).items() if v}
        check(raster == {k: {m: 1.0} for k, m in kernels.items()},
              f"{label}: timed steps launched {raster}")
        profiled = iter(actions[-SINGLE_PROFILED_STEPS:])

        def step():
            nonlocal state
            state, _, _ = media.step_frame(env, state, next(profiled),
                                           use_graph=False)

        prof = step_profile(torch, step, SINGLE_PROFILED_STEPS)
        del prof["graph_launches_per_step"]
        out[label] = {"ms_median": statistics.median(ms), "ms_best": min(ms),
                      **prof, "raster_launches_per_step": raster}
        print(f"single env step, {label}: {out[label]['ms_median']:.3f} ms "
              f"median, {out[label]['ms_best']:.3f} ms best of "
              f"{SINGLE_TIMED_STEPS} (B=1, eager, after "
              f"{SINGLE_WARMUP_STEPS} warm-up steps); "
              f"{out[label]['kernel_launches_per_step']:.1f} kernel "
              f"launches and {out[label]['device_busy_ms_per_step']:.4f} "
              f"device-busy ms a step, copies a step "
              f"{out[label]['copies_per_step']} (torch.profiler, "
              f"{SINGLE_PROFILED_STEPS} steps); raster {raster}; on {card}")
    return out


# The mode of a kernels-line entry named without one.
DEFAULT_MODES = {"scene_raster": "exact+lanczos",
                 "strip_raster": "exact+lanczos", "strip_vpass": "lanczos",
                 "packed_raster": "exact+identity"}
# Phase 9.6: the compiled step-by-step surface. Graph and eager steps timed
# in turn after warm-up, and steps profiled of each.
GRAPH_TIMED_STEPS = 20
GRAPH_WARMUP_STEPS = 3
GRAPH_LANES = (1, 4)  # BatchedEnvironment's lanes
REJECT_STEPS = 12  # the low-acceptance config's steps at B=1


@contextlib.contextmanager
def dm_env_stand_in():
    """Within the block, `import dm_env` finds the installed package or,
    where it is not installed, a stand-in with what the port's adapter
    and action spaces call: `Environment`, `StepType`,
    `TimeStep`, `restart`/`transition`/`termination` and `specs.Array`,
    `BoundedArray`, `DiscreteArray` (with `validate`). Yields whether the
    package is installed."""
    import collections
    import enum
    import importlib.util
    import types

    if importlib.util.find_spec("dm_env") is not None:
        yield True
        return

    class StepType(enum.IntEnum):
        FIRST = 0
        MID = 1
        LAST = 2

    time_step = collections.namedtuple(
        "TimeStep", "step_type reward discount observation")

    class Array:
        def __init__(self, shape, dtype, name=None):
            self.shape, self.dtype, self.name = (tuple(shape),
                                                 np.dtype(dtype), name)

        def validate(self, value):
            value = np.asarray(value)
            if value.shape != self.shape or (
                    self.dtype != object and value.dtype != self.dtype):
                raise ValueError(f"{value.shape} {value.dtype} against "
                                 f"{self.shape} {self.dtype}")
            return value

    class BoundedArray(Array):
        def __init__(self, shape, dtype, minimum, maximum, name=None):
            super().__init__(shape, dtype, name)
            self.minimum, self.maximum = minimum, maximum

    class DiscreteArray(BoundedArray):
        def __init__(self, num_values, dtype=np.int32, name=None):
            super().__init__((), dtype, 0, num_values - 1, name)
            self.num_values = num_values

    specs = types.ModuleType("dm_env.specs")
    specs.Array, specs.BoundedArray = Array, BoundedArray
    specs.DiscreteArray = DiscreteArray
    mod = types.ModuleType("dm_env")
    mod.specs, mod.StepType, mod.TimeStep = specs, StepType, time_step
    mod.Environment = type("Environment", (), {})
    mod.restart = lambda observation: time_step(
        StepType.FIRST, None, None, observation)
    mod.transition = lambda reward, observation, discount=1.0: time_step(
        StepType.MID, reward, discount, observation)
    mod.termination = lambda reward, observation: time_step(
        StepType.LAST, reward, 0.0, observation)
    sys.modules["dm_env"], sys.modules["dm_env.specs"] = mod, specs
    try:
        yield False
    finally:
        for name in ("dm_env", "dm_env.specs",
                     "spriteworld_torch.adapters.dm_env_adapter"):
            sys.modules.pop(name, None)


@contextlib.contextmanager
def host_reads(torch, counts):
    """Within the block, torch.cuda.set_sync_debug_mode("warn"); appends
    to `counts` how many calls in it waited for the device."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counts.append(sum("synchroniz" in str(w.message) for w in caught))


def adapter_of(dm_env_adapter, env, use_graph):
    """The dm_env adapter over `env`'s configuration, seeded 0 like it."""
    return dm_env_adapter.Environment(
        task=env.task, action_space=env.action_space,
        renderers=env.renderers, init_sprites=env._init_sprites,
        keep_in_frame=env._keep_in_frame,
        max_episode_length=env.max_episode_length, metadata=env.metadata,
        seed=0, device=env.device, use_graph=use_graph)


def same_host(a, b) -> bool:
    """Whether two host values (timesteps, observations, sprite lists)
    are equal, NaN to NaN."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a).__name__ == type(b).__name__ and all(
            same_host(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_host(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)) or (isinstance(a, np.ndarray)
                                        and a.dtype == object):
        return len(a) == len(b) and all(same_host(x, y)
                                        for x, y in zip(a, b))
    if hasattr(a, "factors"):  # a host Sprite
        return same_host(dict(a.factors), dict(b.factors))
    if a is None or b is None:
        return a is b
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=np.asarray(
        a).dtype.kind == "f")


def same_states(torch, a, b) -> bool:
    from spriteworld_torch.core.state import STATE_FIELDS

    return all(torch.equal(getattr(a, n), getattr(b, n))
               for n in STATE_FIELDS)


def same_timesteps(torch, a, b) -> bool:
    """Whether two TimeSteps of tensors are equal, NaN to NaN."""
    def leaves(tree):
        if isinstance(tree, (dict, list)):
            items = tree.values() if isinstance(tree, dict) else tree
            return [x for v in items for x in leaves(v)]
        return [tree]

    pairs = zip(leaves([a.step_type, a.reward, a.discount, a.observation]),
                leaves([b.step_type, b.reward, b.discount, b.observation]))
    return all(torch.equal(x.nan_to_num(), y.nan_to_num())
               and torch.equal(x.isnan(), y.isnan()) for x, y in pairs)


def episodes_of(step_types) -> bool:
    """Whether lane-0 step types hold two LASTs and a FIRST after one."""
    lasts = [i for i, t in enumerate(step_types) if t == 2]
    return len(lasts) >= 2 and 0 in step_types[lasts[0]:]


def run_batched(torch, env, lanes, use_graph, steps):
    """BatchedEnvironment over `lanes`: reset, then `steps` steps of
    `sample_actions()` (eager draws between replays). Returns ([(state
    copy, TimeStep)], host reads of each step, reruns at each step,
    whether the step holds a rejection node)."""
    from spriteworld_torch.core import environment as env_lib

    benv = env_lib.BatchedEnvironment(env, lanes, use_graph=use_graph)
    check(benv.use_graph == use_graph, "BatchedEnvironment's default")
    reads, reruns = [], []
    with host_reads(torch, reads):
        state, ts = benv.reset()
    out = [(state.clone(), ts)]
    for _ in range(steps):
        actions = benv.sample_actions()
        with host_reads(torch, reads):
            state, ts = benv.step(state, actions)
        out.append((state.clone(), ts))
        reruns.append(benv.reruns)
    step = benv._compiled._programs["step"]
    return out, reads, reruns, step.graph is None or step.rejects


def run_adapter(torch, dm_env_adapter, env, use_graph, steps):
    """The dm_env adapter: reset, then `steps` steps of
    `action_space.sample()`, every third step also `observation()` and
    `sample_contained_position()` (an eager split of the adapter's key
    between replays). Returns ([host results], host reads of each step,
    the adapter)."""
    adapter = adapter_of(dm_env_adapter, env, use_graph)
    out, reads = [], []
    with host_reads(torch, reads):
        out.append(adapter.reset())
    for t in range(steps):
        action = adapter.action_space.sample()
        with host_reads(torch, reads):
            out.append(adapter.step(action))
        if t % 3 == 1:
            out.append(adapter.observation())
            out.append(adapter.sample_contained_position())
    return out, reads, adapter


def run_media(torch, media, env, use_graph, steps):
    """media: record_episode seeded 0, then one seeded 1 with its states,
    then step_frame past that episode's LAST (the auto-reset). Returns ([frames and states], host reads of the
    second episode, its frames, reruns)."""
    first = media.record_episode(env, 0, max_steps=steps,
                                 use_graph=use_graph)
    reads = []
    compiled = media._compiled(env, use_graph)
    reruns = compiled.reruns
    with host_reads(torch, reads):
        frames, states = media.record_episode(
            env, 1, max_steps=steps, return_states=True,
            use_graph=use_graph)
    out = [first, frames, states]
    state = states[-1]
    for t in range(2):
        state, frame, last = media.step_frame(
            env, state, env.sample_action(lane_keys(t, 1, env.device)),
            use_graph=use_graph)
        out.append((state.clone(), frame, last))
    return out, reads[0], len(frames), compiled.reruns - reruns


def single_env_graph(torch, bench_torch, rasterize_cuda, card, dev="cuda"):
    """Phase 9.6, the compiled step-by-step surface on each config of
    `single_env_paths`: BatchedEnvironment at 1 and 4 lanes, the dm_env
    adapter and media.record_episode/step_frame replay captured graphs by
    default, and each equals its eager twin (use_graph=False) bit for bit
    over two episodes and an auto-reset, with eager draws between replays,
    both under torch.cuda.set_sync_debug_mode("warn") with the host reads
    counted (the adapter and media one a step; BatchedEnvironment's graph
    none, or the rejection flag where its step holds a rejection node;
    its eager twin the flag every step; one more where a step ran again).
    The graph paths launch each of the config's kernels only while warming
    up and capturing (2 a program), counted from 0. Then the low-acceptance
    config at B=1 (steps run again, equal to the host-checked eager
    steps), and graph and eager `step_frame` timed in turn and profiled.
    Returns ({label: times}, {kernel: {mode: launches}} of the graph
    paths)."""
    from spriteworld_torch.core import environment as env_lib
    from spriteworld_torch.utils import media

    rc = rasterize_cuda
    times, graph_launches = {}, {}
    with dm_env_stand_in() as installed:
        from spriteworld_torch.adapters import dm_env_adapter

        if not installed:
            print("dm_env is not installed on this machine: phase 9.6 "
                  "drives the adapter with a stand-in for dm_env's "
                  "TimeStep and spec classes")
        for i, (label, _, kernels) in enumerate(single_env_paths(
                bench_torch, dev)):
            def fresh():
                return single_env_paths(bench_torch, dev)[i][1]

            steps = 2 * fresh().max_episode_length + 2
            runs = {}
            for use_graph in (True, False):
                rc.reset_launch_counts()
                batched = {lanes: run_batched(torch, fresh(), lanes,
                                              use_graph, steps)
                           for lanes in GRAPH_LANES}
                adapter = run_adapter(torch, dm_env_adapter, fresh(),
                                      use_graph, steps)
                recorded = run_media(torch, media, fresh(), use_graph,
                                     steps)
                runs[use_graph] = (batched, adapter, recorded,
                                   launch_counts(rc), batch_counts(rc))
            (g_b, g_a, g_m, g_counts, g_batches), (e_b, e_a, e_m, _, _) = (
                runs[True], runs[False])
            reruns = {"adapter": g_a[2]._compiled.reruns, "media": g_m[3]}
            for lanes in GRAPH_LANES:
                (g_out, g_reads, g_re, g_pends), (e_out, e_reads, e_re, _) = (
                    g_b[lanes], e_b[lanes])
                check(len(g_out) == len(e_out) and all(
                    same_states(torch, gs, es)
                    and same_timesteps(torch, gts, ets)
                    for (gs, gts), (es, ets) in zip(g_out, e_out)),
                    f"{label}: BatchedEnvironment at {lanes} lanes, graph "
                    f"and eager differ")
                types = [int(ts.step_type[0]) for _, ts in g_out]
                check(episodes_of(types), f"{label}: no two episodes and "
                                          f"an auto-reset in lane 0")
                # Reads a step after the first (whose capture syncs): the
                # flag where it can be set, one more where a step re-ran.
                for name, reads, re, flag in (
                        ("graph", g_reads, g_re, g_pends),
                        ("eager", e_reads, e_re, True)):
                    # A re-run's host-checked rejection reads once or more.
                    check(all(r == int(flag) if b == a else r > int(flag)
                              for r, a, b in zip(reads[2:], re, re[1:])),
                          f"{label}, {lanes} lanes, {name}: host reads "
                          f"{reads}, reruns {re}")
                reruns[f"batched {lanes}"] = g_re[-1]
                print(f"single env graph, {label}, BatchedEnvironment at "
                      f"{lanes} lanes: {len(g_out) - 1} steps equal to the "
                      f"eager ones; host reads a step graph "
                      f"{sorted(set(g_reads[2:]))}, eager "
                      f"{sorted(set(e_reads[2:]))}; the step holds a "
                      f"rejection node: {g_pends}; reruns {g_re[-1]}")
            (g_out, g_reads, g_ad), (e_out, e_reads, e_ad) = g_a, e_a
            check(len(g_out) == len(e_out) and all(
                same_host(x, y) for x, y in zip(g_out, e_out)),
                f"{label}: the adapter's graph and eager steps differ")
            for name, reads, ad in (("graph", g_reads, g_ad),
                                    ("eager", e_reads, e_ad)):
                check(all(r == 1 for r in reads[2:])
                      or ad._compiled.reruns > 0,
                      f"{label}: the adapter's {name} steps read the host "
                      f"{reads} times")
            print(f"single env graph, {label}, dm_env adapter: reset, "
                  f"{steps} steps, observations and contained positions "
                  f"equal to the eager ones; host reads a step graph "
                  f"{sorted(set(g_reads[2:]))}, eager "
                  f"{sorted(set(e_reads[2:]))}")
            (g_out, g_reads, g_frames, g_re), (e_out, e_reads, e_frames,
                                               e_re) = g_m, e_m
            check(np.array_equal(g_out[0], e_out[0])
                  and np.array_equal(g_out[1], e_out[1])
                  and all(same_states(torch, a, b)
                          for a, b in zip(g_out[2], e_out[2]))
                  and all(same_states(torch, a[0], b[0])
                          and np.array_equal(a[1], b[1]) and a[2] == b[2]
                          for a, b in zip(g_out[3:], e_out[3:])),
                  f"{label}: record_episode's graph and eager frames or "
                  "states differ")
            check((g_reads == g_frames or g_re) and (e_reads == e_frames
                                                      or e_re),
                  f"{label}: record_episode read the host {g_reads} / "
                  f"{e_reads} times for {g_frames} frames")
            counts = [int(s[0].step_count) for s in g_out[3:]]
            check(int(g_out[2][-1].reset_next) and counts[0] == 0,
                  f"{label}: step_frame past LAST did not reset")
            print(f"single env graph, {label}, record_episode: "
                  f"{len(g_out[0])} + {g_frames} frames and 2 steps past "
                  f"LAST (step counts {counts}) equal to the eager ones; "
                  f"{g_reads} host reads for {g_frames} frames")
            # The graph paths: 2 launches a captured program (warm-up and
            # capture), at B=1 the reset and step of BatchedEnvironment
            # and media and the adapter's observation too, plus re-runs.
            at_one = 2 * 7 + reruns["batched 1"] + reruns["adapter"] \
                + reruns["media"]
            want = {k: {1: at_one, 4: 4 + reruns["batched 4"]}
                    for k in kernels}
            got = {k: v for k, v in g_batches.items() if v}
            print(f"single env graph, {label}: launches through the "
                  f"wrappers on the graph paths {got} (reruns {reruns})")
            check(got == want, f"{label}: the graph paths launched {got}, "
                               f"not {want}")
            for k, v in g_counts.items():
                for m, n in v.items():
                    graph_launches.setdefault(k, {})
                    graph_launches[k][m] = graph_launches[k].get(m, 0) + n
            times[label] = time_graph_steps(torch, media, fresh(), card,
                                            label)
        low_acceptance(torch, bench_torch, env_lib, dm_env_adapter)
    return times, graph_launches


def low_acceptance(torch, bench_torch, env_lib, dm_env_adapter):
    """The low-acceptance config at B=1: BatchedEnvironment's graph steps
    against the host-checked eager step_batch loop from the same seed, and
    the adapter's graph steps against its eager ones; steps re-run."""
    graph = env_lib.BatchedEnvironment(
        low_acceptance_env(bench_torch, env_lib), 1)
    plain = low_acceptance_env(bench_torch, env_lib)
    state, ts = graph.reset()
    want, wts = plain.reset_batch(1)
    equal = same_states(torch, state, want) and same_timesteps(torch, ts, wts)
    for keys in batched_action_keys(plain.root_key(), 1, REJECT_STEPS):
        state, ts = graph.step(state, graph.sample_actions())
        want, wts = plain.step_batch(want, plain.sample_action(keys))
        equal = equal and same_states(torch, state, want) \
            and same_timesteps(torch, ts, wts)
    check(graph.use_graph and graph.reruns >= 1 and equal,
          f"low acceptance, BatchedEnvironment: {graph.reruns} reruns, "
          f"equal to the host-checked steps: {equal}")
    runs = [run_adapter(torch, dm_env_adapter,
                        low_acceptance_env(bench_torch, env_lib), use_graph,
                        REJECT_STEPS) for use_graph in (True, False)]
    adapter_reruns = runs[0][2]._compiled.reruns
    check(adapter_reruns >= 1 and all(
        same_host(x, y) for x, y in zip(runs[0][0], runs[1][0])),
        f"low acceptance, adapter: {adapter_reruns} reruns, graph and "
        "eager differ")
    print(f"single env graph, low acceptance at B=1: BatchedEnvironment "
          f"re-ran {graph.reruns} of {REJECT_STEPS + 1} launches and equals "
          f"the host-checked step_batch loop; the adapter re-ran "
          f"{adapter_reruns} and equals its eager twin")


def batched_action_keys(key, lanes, steps):
    """The lane action keys of `steps` calls of BatchedEnvironment's
    `sample_actions()` after `reset(key)`: the action key starts at
    fold_in(key, 1), and each call splits it into the next one and the
    call's, split over the lanes."""
    from spriteworld_torch.ops import lane_random

    action_key = lane_random.fold_in(key, 1)
    for _ in range(steps):
        action_key, step_key = lane_random.split(action_key, 2)
        yield lane_random.split(step_key, lanes)


def step_profile(torch, run, steps: int) -> dict:
    """Kernels, copies by kind and device-busy ms a step over `steps`
    calls of `run()` under torch.profiler, and graph launches a step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    launched = [e for e in device
                if not e.key.startswith(("Memcpy", "Memset"))]
    copies = {}  # by kind: DtoH (each a wait for the device), DtoD, HtoD
    for e in device:
        if e.key.startswith("Memcpy"):
            kind = e.key.split()[1]
            copies[kind] = copies.get(kind, 0) + e.count / steps
    return {
        "kernel_launches_per_step": sum(e.count for e in launched) / steps,
        "copies_per_step": copies,
        "device_busy_ms_per_step":
            sum(e.self_device_time_total for e in launched) / 1e3 / steps,
        "graph_launches_per_step": sum(
            e.count for e in events if e.key == "cudaGraphLaunch") / steps,
    }


def time_graph_steps(torch, media, env, card, label):
    """Graph and eager `media.step_frame` at B=1 in turn (its action drawn
    before the clock starts): median and best wall ms of
    GRAPH_TIMED_STEPS each after GRAPH_WARMUP_STEPS, then
    SINGLE_PROFILED_STEPS of each under torch.profiler."""
    import statistics

    state = {use_graph: env.reset_batch(1)[0] for use_graph in (True, False)}
    ms = {True: [], False: []}
    keys = iter(lane_keys(5, (2 * (GRAPH_WARMUP_STEPS + GRAPH_TIMED_STEPS
                                   + SINGLE_PROFILED_STEPS), 1), env.device))

    def step(use_graph):
        action = env.sample_action(next(keys))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[use_graph], _, _ = media.step_frame(
            env, state[use_graph], action, use_graph=use_graph)
        return (time.perf_counter() - t0) * 1e3

    for i in range(GRAPH_WARMUP_STEPS + GRAPH_TIMED_STEPS):
        for use_graph in ((True, False) if i % 2 else (False, True)):
            t = step(use_graph)
            if i >= GRAPH_WARMUP_STEPS:
                ms[use_graph].append(t)
    out = {}
    for use_graph, name in ((True, "graph"), (False, "eager")):
        out[name] = {"ms_median": statistics.median(ms[use_graph]),
                     "ms_best": min(ms[use_graph]),
                     **step_profile(torch, lambda: step(use_graph),
                                    SINGLE_PROFILED_STEPS)}
    print(f"single env graph step, {label}: graph "
          f"{out['graph']['ms_median']:.3f} ms median, "
          f"{out['graph']['ms_best']:.3f} best; eager "
          f"{out['eager']['ms_median']:.3f} / {out['eager']['ms_best']:.3f} "
          f"(B=1, {GRAPH_TIMED_STEPS} each in turn); a step: graph "
          f"{out['graph']['kernel_launches_per_step']:.1f} kernels, "
          f"{out['graph']['device_busy_ms_per_step']:.4f} device-busy ms, "
          f"{out['graph']['graph_launches_per_step']:.1f} graph launches; "
          f"eager {out['eager']['kernel_launches_per_step']:.1f} kernels, "
          f"{out['eager']['device_busy_ms_per_step']:.4f} ms; on {card}")
    return out


def single_env(torch, bench_torch, rasterize_cuda, colors, card,
               dev="cuda"):
    """Phase 9, the single env at B=1: kernels against plain (9.1),
    record_episode (9.2), example_run_loop_torch (9.3), the dm_env adapter
    and make_gifs_torch (9.4), then the eager step's times (9.5) and the
    compiled surface against its eager twin with its times (9.6), each
    with one JSON line of the times. Returns (the largest kernel
    difference, {kernel: {mode: launches}} of 9.6's graph paths)."""
    worst = single_vs_plain(torch, rasterize_cuda, colors, dev)
    record_single(torch, bench_torch, rasterize_cuda, dev)
    run_loop_single(torch, rasterize_cuda, dev)
    adapter_single(torch, bench_torch, dev)
    times = time_single(torch, bench_torch, rasterize_cuda, card, dev)
    print(json.dumps({"single_env_step": times, "card": card}))
    graph_times, graph_launches = single_env_graph(
        torch, bench_torch, rasterize_cuda, card, dev)
    print(json.dumps({"single_env_graph": graph_times, "card": card}))
    return worst, graph_launches


# Phase 10: the trainer at full width (10.1), the mesh on one card (10.2)
# and the batch sweep (10.3).
TRAIN_LANES = 1024  # train_example.py's default --num_envs
TRAIN_STEPS = 20  # its default --steps
TRAIN_ITERS = 5
MESH_LANES = 2048
MESH_STEPS = 12  # two chunks outlast an episode (20 steps)
SWEEP_BATCHES = (256, 2048, 8192)
SWEEP_STEPS = 10
SWEEP_OUT = "chiprun_out/scaling_smoke.jsonl"


def equal_rollouts(torch, a, b, what):
    """Checks two trainer rollouts ((state, Rollout) each) bit-equal."""
    from spriteworld_torch.core.state import STATE_FIELDS

    (sa, ra), (sb, rb) = a, b
    for name in STATE_FIELDS:
        check(torch.equal(getattr(sa, name), getattr(sb, name)),
              f"{what}: state field {name} differs")
    for name in ("z", "adv", "valid", "reward", "success"):
        check(torch.equal(getattr(ra, name), getattr(rb, name)),
              f"{what}: {name} differs")
    for i, (x, y) in enumerate(zip(ra.obs, rb.obs)):
        check(torch.equal(x, y), f"{what}: policy input {i} differs")


def drive_trainer(torch, rasterize_cuda, card, dev="cuda"):
    """Phase 10.1: train_example_torch.train at 1024 lanes x 20 steps for
    TRAIN_ITERS iterations in each observation mode. Losses finite; the
    image mode launched packed_raster (exact, at B=1024: the reset's
    render, then once to warm up and once captured; replays are not
    counted) and no other kernel, the factors mode none. Then, from the
    trained state: one rollout replayed from the graph against the eager
    rollout from the same parameters, state and key, both
    under torch.cuda.set_sync_debug_mode("error"), equal bit for bit;
    the images the policy saw at the first step against the plain render
    of that state. Returns {mode: (stats, launches by mode)}."""
    import train_example_torch as tt

    rc = rasterize_cuda
    out = {}
    for obs in ("factors", "image"):
        t0 = time.perf_counter()
        rc.reset_launch_counts()
        stats = {}
        _, history = tt.train(num_envs=TRAIN_LANES, iters=TRAIN_ITERS,
                              rollout_steps=TRAIN_STEPS, seed=0,
                              log_every=2, obs_mode=obs, device=dev,
                              stats=stats)
        counts = {k: v for k, v in launch_counts(rc).items() if v}
        batches = {k: v for k, v in batch_counts(rc).items() if v}
        trainer = stats.pop("trainer")
        print(f"trainer {obs}: launches through the wrappers {counts} at "
              f"batches {batches}; history {json.dumps(history)}")
        check(all(np.isfinite(m[k]) for m in history for k in m),
              f"trainer {obs}: a loss or metric is not finite")
        # The reset's render, then the warm-up and the captured step (an
        # eager trainer, on the CPU, renders every step).
        n = 3 if trainer.use_graph else 1 + TRAIN_ITERS * TRAIN_STEPS
        want = ({} if obs == "factors" else
                {"packed_raster": {"exact+identity": n}})
        check(counts == want and batches == {
            k: {TRAIN_LANES: n} for k in want},
            f"trainer {obs}: launches {counts} at {batches}, not {want}")
        check(trainer.use_graph == (dev == "cuda") and trainer.reruns == 0,
              f"trainer {obs}: no graph, or a rollout ran again")

        point = trainer.save_point()
        runs = []
        for use_graph in (trainer.use_graph, False):
            trainer.restore_point(point)
            torch.cuda.set_sync_debug_mode("error")
            try:
                ro = trainer.rollout(use_graph=use_graph).clone()
                state = type(trainer.state)(**{
                    n: x.clone() for n, x in vars(trainer.state).items()})
            finally:
                torch.cuda.set_sync_debug_mode(0)
            runs.append((state, ro))
        equal_rollouts(torch, runs[0], runs[1], f"trainer {obs}")
        line = (f"trainer {obs}: a rollout replayed from the graph equals "
                "the eager one bit for bit (states, z, rewards, advantages, "
                "masks, policy inputs); no host sync in either")
        if obs == "image":
            from spriteworld_torch.core import state as state_lib

            renderer = trainer.env.renderers["image"]
            factors, num = point[0].factors, point[0].num_sprites
            want_img = plain_frames(rc, renderer, factors, num)
            err, count = compare(runs[0][1].obs[0][0], want_img)
            blank = int((want_img.amax(dim=(1, 2, 3)) == 0).sum())
            # train_example.py draws only the hue (c0): saturation and
            # value keep their default 0, so every sprite is black. The
            # same scenes in full colour, through the same dispatch.
            vivid = factors.clone()
            vivid[..., state_lib.C1] = 1.0
            vivid[..., state_lib.C2] = 1.0
            got_vivid = renderer.render_batch(vivid, num, None)
            want_vivid = plain_frames(rc, renderer, vivid, num)
            err_v, count_v = compare(got_vivid, want_vivid)
            blank_v = int((want_vivid.amax(dim=(1, 2, 3)) == 0).sum())
            line += (f"; first-step images against the plain render of "
                     f"their states: max |diff| {err}, {count} differing "
                     f"values, {blank} of {want_img.shape[0]} blank (black "
                     f"sprites, as train_example.py draws them); the same "
                     f"scenes at full saturation and value: max |diff| "
                     f"{err_v}, {count_v} differing, {blank_v} blank")
            check(count == 0 and count_v == 0 and blank_v == 0,
                  "trainer image: the policy's images differ from plain")
        print(line)
        print(f"trainer {obs}, {TRAIN_LANES} lanes x {TRAIN_STEPS} steps, "
              f"{TRAIN_ITERS} iterations: steady-state "
              f"{stats['env_steps_per_sec']:.1f} env-steps/s, rollout "
              f"{stats['rollout_ms']:.3f} ms, update "
              f"{stats['update_ms']:.3f} ms an iteration (median, device "
              f"time between events), on {card}; phase "
              f"{time.perf_counter() - t0:.1f} s")
        if dev == "cuda":
            profile_trainer(torch, trainer, obs, card)
        out[obs] = (stats, counts)
    return out


def profile_trainer(torch, trainer, obs, card):
    """One rollout and one update of a trained `trainer` under
    torch.profiler (after one of each unprofiled): device-busy ms and
    kernel launches of each, and the kernels that take the most device
    time, as one JSON line."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    rollout = trainer.rollout()
    trainer.update(rollout)
    for part in ("rollout", "update"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if part == "rollout":
                rollout = trainer.rollout()
            else:
                trainer.update(rollout)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out[part] = {
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in kernels) / 1e3,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90],
                             "ms": e.self_device_time_total / 1e3,
                             "launches": e.count} for e in top]}
    print(json.dumps({"trainer_profile": {obs: out}, "card": card}))


def mesh_one_card(torch, bench_torch, dev="cuda"):
    """Phase 10.2: a one-rank group (NCCL on the card) through
    `initialize_multihost`; ShardedRunner(mesh=env_mesh()) on image64 at
    AA=1 over 2048 lanes, two chunks, against the runner without a mesh
    from the same seed: equal metrics (episodes, successes, both sums)
    and states. The group is destroyed after."""
    import torch.distributed as dist

    from spriteworld_torch.core.state import STATE_FIELDS
    from spriteworld_torch.parallel import ShardedRunner
    from spriteworld_torch.parallel import mesh as mesh_lib

    t0 = time.perf_counter()
    mesh_lib.initialize_multihost(f"127.0.0.1:{mesh_lib.free_port()}", 1,
                                  0, device=dev)
    try:
        mesh = mesh_lib.env_mesh(dev)
        backend = dist.get_backend()
        check(mesh.size == 1 and mesh.group is not None,
              f"the one-rank mesh is {mesh}")
        runs = []
        for m in (mesh, None):
            env = bench_torch.build_env(anti_aliasing=1, device=dev, seed=0)
            runner = ShardedRunner(env, MESH_LANES, mesh=m)
            state, _ = runner.reset(5)
            state, m1 = runner.rollout(state, MESH_STEPS)
            state, m2 = runner.rollout(state, MESH_STEPS)
            runs.append((state, m1, m2))
    finally:
        dist.destroy_process_group()
    (sa, *ma), (sb, *mb) = runs
    print(f"mesh of one rank ({backend}), image64 AA=1, {MESH_LANES} lanes, "
          f"2 chunks of {MESH_STEPS} steps: {ma} with the mesh, {mb} "
          f"without; phase {time.perf_counter() - t0:.1f} s")
    check(ma == mb and ma[1].episodes > 0,
          "the one-rank mesh's metrics differ from the runner's")
    for name in STATE_FIELDS:
        check(torch.equal(getattr(sa, name), getattr(sb, name)),
              f"the one-rank mesh's state field {name} differs")
    check(backend == ("nccl" if dev == "cuda" else "gloo"),
          f"the group's backend is {backend}")


def sweep_batches(rasterize_cuda, card, dev="cuda"):
    """Phase 10.3: scaling_bench_torch --batch_sweep at SWEEP_BATCHES
    lanes, SWEEP_STEPS steps a chunk, its rows into SWEEP_OUT; each batch
    launched packed_raster 3 times (reset, warm-up, capture)."""
    import os

    import scaling_bench_torch

    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(SWEEP_OUT), exist_ok=True)
    rasterize_cuda.reset_launch_counts()
    rows = scaling_bench_torch.batch_sweep(SWEEP_OUT, SWEEP_STEPS,
                                           SWEEP_BATCHES, dev)
    batches = {k: v for k, v in batch_counts(rasterize_cuda).items() if v}
    print(f"batch sweep on {card}: launches at batches {batches}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    check([r["num_envs"] for r in rows] == list(SWEEP_BATCHES)
          and all(r["steps_per_sec"] > 0 for r in rows),
          f"batch sweep rows {rows}")
    # The reset's render, the warm-up and the captured step (eager on the
    # CPU: the reset and every step of the 4 chunks).
    n = 3 if dev == "cuda" else 1 + 4 * SWEEP_STEPS
    check(batches == {"packed_raster": {b: n for b in SWEEP_BATCHES}},
          f"batch sweep launches {batches}")


def trainer_mesh_sweep(torch, bench_torch, rasterize_cuda, card,
                       dev="cuda"):
    """Phase 10. Returns the trainer's packed_raster launches by mode."""
    t0 = time.perf_counter()
    trained = drive_trainer(torch, rasterize_cuda, card, dev)
    mesh_one_card(torch, bench_torch, dev)
    sweep_batches(rasterize_cuda, card, dev)
    print(json.dumps({"trainer": {
        obs: stats for obs, (stats, _) in trained.items()}, "card": card}))
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s")
    return trained["image"][1].get("packed_raster", {})


# Phase 11: the renderer contract and action dtypes. (label, image_size,
# anti_aliasing, {kernel: mode} a render launches) of (a) and (d).
CONTRACT_CASES = [
    ("image64 AA=5, scene", (64, 64), 5, {"scene_raster": "exact+lanczos"}),
    ("demo256 AA=10, strips", (DEMO_SIZE, DEMO_SIZE), DEMO_AA,
     {"strip_raster": "exact+lanczos", "strip_vpass": "lanczos"}),
    ("image64 AA=1, packed", (64, 64), 1,
     {"packed_raster": "exact+identity"}),
]
CONTRACT_LANES = 4
CONTRACT_EPISODE = 8  # max_episode_length of (b)'s and (c)'s env
CONTRACT_STEPS = 2 * CONTRACT_EPISODE + 2


def contract_renderers(torch, renderers):
    """A renderer written to the JAX contract (a one-scene `render` only:
    the masked sum of the live sprites' x and the live mask), so its
    render_batch is the default torch.func.vmap; and a hand-batched twin."""
    class SumX(renderers.AbstractRenderer):
        def render(self, factors, num_sprites, success):
            del success
            live = torch.arange(factors.shape[0],
                                device=factors.device) < num_sprites
            return {"sum_x": torch.where(live, factors[:, 0], 0.0).sum(),
                    "live": live}

        def observation_spec(self):
            return {"sum_x": renderers.ShapeDtype((), torch.float32),
                    "live": renderers.ShapeDtype((self.max_sprites,),
                                                 torch.bool)}

    class SumXBatched(SumX):
        def render_batch(self, factors, num_sprites, success):
            del success
            live = (torch.arange(factors.shape[1], device=factors.device)
                    < num_sprites[:, None])
            return {"sum_x": torch.where(live, factors[..., 0], 0.0).sum(-1),
                    "live": live}

    return SumX(), SumXBatched()


def doubled_factors(torch, renderers):
    """A SpriteFactors subclass that overrides `render` (the factors
    doubled, the mask negated): its render_batch must be the vmap of that
    `render`, not SpriteFactors' batched body."""
    class Doubled(renderers.SpriteFactors):
        def render(self, factors, num_sprites, success):
            out = super().render(factors, num_sprites, success)
            return {"factors": 2 * out["factors"], "mask": ~out["mask"]}

    return Doubled()


def refuses_use_pallas():
    """Phase 11 (d), first half: ImageRenderer refuses JAX's use_pallas,
    the flag that would send card tensors to the plain rasterizer."""
    from spriteworld_torch.core import renderers

    for value in ("auto", True, False):
        try:
            renderers.ImageRenderer((64, 64), use_pallas=value)
        except TypeError:
            continue
        check(False, f"ImageRenderer(use_pallas={value!r}) was accepted")
    print("renderer contract (d): ImageRenderer(use_pallas=...) is refused "
          "(TypeError): card tensors render only through the kernels")


def contract_env(bench_torch, renderers, extra, dev, seed=0):
    """bench.py's image64 scene at AA=1 with `extra` renderers beside the
    image and success, episodes of CONTRACT_EPISODE steps."""
    from spriteworld_torch.core import actions as action_lib
    from spriteworld_torch.core import environment as env_lib

    task, init_sprites = bench_torch.goal_finding_parts()
    return env_lib.Environment(
        task=task, action_space=action_lib.SelectMove(scale=0.25),
        renderers=dict(extra, image=renderers.ImageRenderer(
            (64, 64), anti_aliasing=1, color_to_rgb="hsv"),
            success=renderers.Success()),
        init_sprites=init_sprites, max_episode_length=CONTRACT_EPISODE,
        device=dev, seed=seed)


def one_scene_renders(torch, rasterize_cuda, dev="cuda"):
    """Phase 11 (a): for each case of CONTRACT_CASES, ImageRenderer.render
    of each scene equals render_batch at its lane, and launched the case's
    kernel once for the batch and once a scene. Returns ({kernel: {mode: launches}}, the largest difference)."""
    from spriteworld_torch.core import renderers

    rc = rasterize_cuda
    b = CONTRACT_LANES
    launched, worst = {}, 0
    for i, (label, size, aa, want) in enumerate(CONTRACT_CASES):
        f, n = scene_batch(110 + i, b, hsv=True)
        f, n = torch.from_numpy(f).to(dev), torch.from_numpy(n).to(dev)
        r = renderers.ImageRenderer(size, anti_aliasing=aa,
                                    color_to_rgb="hsv")
        rc.reset_launch_counts()
        batch = r.render_batch(f, n, None)
        singles = [r.render(f[j], n[j], None) for j in range(b)]
        ran = {k: v for k, v in launch_counts(rc).items() if v}
        batches = {k: v for k, v in batch_counts(rc).items() if v}
        errs = [compare(one, batch[j]) for j, one in enumerate(singles)]
        worst = max([worst] + [e for e, _ in errs])
        print(f"renderer contract (a), {label}: render of each of {b} "
              f"scenes against render_batch at its lane, max |diff| "
              f"{max(e for e, _ in errs)}, {sum(c for _, c in errs)} "
              f"differing values; ran {ran} at batches {batches}")
        check(all(one.shape == batch.shape[1:] for one in singles)
              and all(c == 0 for _, c in errs),
              f"{label}: render differs from render_batch")
        if dev == "cuda":
            check(ran == {k: {m: 1 + b} for k, m in want.items()},
                  f"{label}: ran {ran}, not {want} {1 + b} times")
            check(batches == {k: {b: 1, 1: b} for k in want},
                  f"{label}: launched at batches {batches}")
        for k, modes in ran.items():
            for m, c in modes.items():
                launched.setdefault(k, {})
                launched[k][m] = launched[k].get(m, 0) + c
    return launched, worst


def user_renderer_graph(torch, bench_torch, dev="cuda"):
    """Phase 11 (b): the JAX-contract renderer beside the image inside
    BatchedEnvironment at CONTRACT_LANES lanes, replayed from a graph (on
    the card) and eager, over CONTRACT_STEPS steps (an auto-reset in every
    lane): graph equal to eager, and the vmapped renderer equal to its
    hand-batched twin at every step; (d), second half: beside them a
    SpriteFactors subclass that overrides `render` gives that render's
    output, not SpriteFactors'."""
    from spriteworld_torch.core import renderers

    runs = {}
    for use_graph in ((True, False) if dev == "cuda" else (False,)):
        one_scene, twin = contract_renderers(torch, renderers)
        env = contract_env(bench_torch, renderers,
                           {"sum_x": one_scene, "sum_x_twin": twin,
                            "doubled": doubled_factors(torch, renderers),
                            "factors": renderers.SpriteFactors()}, dev)
        runs[use_graph] = run_batched(torch, env, CONTRACT_LANES, use_graph,
                                      CONTRACT_STEPS)[0]
    g_out, e_out = runs[dev == "cuda"], runs[False]
    check(len(g_out) == len(e_out) and all(
        same_states(torch, gs, es) and same_timesteps(torch, gts, ets)
        for (gs, gts), (es, ets) in zip(g_out, e_out)),
        "renderer contract (b): graph and eager steps differ")
    for t, (state, ts) in enumerate(g_out):
        obs = ts.observation
        check(obs["sum_x"]["sum_x"].shape == (CONTRACT_LANES,)
              and all(torch.equal(obs["sum_x"][k], obs["sum_x_twin"][k])
                      for k in ("sum_x", "live")),
              f"renderer contract (b), step {t}: the one-scene renderer "
              "differs from its hand-batched twin")
        check(torch.equal(obs["sum_x"]["live"], state.alive),
              f"renderer contract (b), step {t}: live mask")
        check(torch.equal(obs["doubled"]["factors"],
                          2 * obs["factors"]["factors"])
              and torch.equal(obs["doubled"]["mask"], ~obs["factors"]["mask"]),
              f"renderer contract (d), step {t}: the SpriteFactors subclass "
              "did not render through its own render")
    types = torch.stack([ts.step_type for _, ts in g_out]).cpu().numpy()
    check(all(episodes_of(list(types[:, lane]))
              for lane in range(CONTRACT_LANES)),
          "renderer contract (b): no two episodes and an auto-reset")
    print(f"renderer contract (b): a one-scene renderer (torch.func.vmap "
          f"of its render) inside BatchedEnvironment's "
          f"{'graph' if dev == 'cuda' else 'eager step'} at "
          f"{CONTRACT_LANES} lanes, {CONTRACT_STEPS} steps with auto-resets:"
          f" equal to the eager step and to its hand-batched twin")
    print("renderer contract (d): a SpriteFactors subclass overriding "
          "render gave its own render's output at every step, in the same "
          "run")


def float64_actions(torch, bench_torch, dev="cuda"):
    """Phase 11 (c): float64 numpy actions through BatchedEnvironment
    (graph on the card) and media.step_frame give the states, timesteps
    and frames of the same actions in float32, bit for bit, with float32
    rewards; an action of the other dtype after them steps."""
    from spriteworld_torch.core import environment as env_lib
    from spriteworld_torch.core import renderers
    from spriteworld_torch.utils import media

    rng = np.random.default_rng(111)
    envs = [contract_env(bench_torch, renderers, {}, dev) for _ in range(4)]
    benvs = [env_lib.BatchedEnvironment(e, CONTRACT_LANES) for e in envs[:2]]
    states = [b.reset()[0] for b in benvs]
    frames = [envs[2].initial_state(1), envs[3].initial_state(1)]
    for t in range(CONTRACT_STEPS):
        a = rng.uniform(0, 1, (CONTRACT_LANES, 4))
        pos = states[0].factors[:, 0, 0:2].cpu().numpy()
        a[::2, :2] = pos[::2]  # clicks on a sprite's centre
        out = [b.step(s, x) for b, s, x in zip(
            benvs, states, (a, a.astype(np.float32)))]
        states = [s for s, _ in out]
        check(out[0][1].reward.dtype == torch.float32
              and same_states(torch, *states)
              and same_timesteps(torch, out[0][1], out[1][1]),
              f"renderer contract (c), step {t}: float64 actions through "
              "BatchedEnvironment differ from float32 ones")
        one = [media.step_frame(e, s, x[:1]) for e, s, x in zip(
            envs[2:], frames, (a, a.astype(np.float32)))]
        frames = [s for s, _, _ in one]
        check(same_states(torch, *frames)
              and np.array_equal(one[0][1], one[1][1])
              and one[0][2] == one[1][2],
              f"renderer contract (c), step {t}: float64 actions through "
              "media.step_frame differ from float32 ones")
    for b, s, x in zip(benvs, states, (a.astype(np.float32), a)):
        check(b.step(s, x)[1].reward.dtype == torch.float32,
              "renderer contract (c): a reward is not float32")
    check(all(b._compiled._actions.dtype == torch.float32 for b in benvs),
          "renderer contract (c): the action buffer is not float32")
    print(f"renderer contract (c): {CONTRACT_STEPS} steps of float64 numpy "
          f"actions through BatchedEnvironment ({CONTRACT_LANES} lanes, "
          f"graph: {benvs[0].use_graph}) and media.step_frame equal to "
          f"float32 ones bit for bit, rewards float32; a float32 action "
          f"after float64 ones and a float64 one after float32 ones step")


def renderer_contract(torch, bench_torch, rasterize_cuda, card, dev="cuda"):
    """Phase 11, the renderer contract and action dtypes on the card.
    Returns ({kernel: {mode: launches}} of (a), (b) and (c), the largest
    difference of (a))."""
    t0 = time.perf_counter()
    launched, worst = one_scene_renders(torch, rasterize_cuda, dev)
    rasterize_cuda.reset_launch_counts()
    user_renderer_graph(torch, bench_torch, dev)
    float64_actions(torch, bench_torch, dev)
    refuses_use_pallas()
    for k, modes in launch_counts(rasterize_cuda).items():
        for m, c in modes.items():
            launched.setdefault(k, {})
            launched[k][m] = launched[k].get(m, 0) + c
    if dev == "cuda":
        check(launched.get("packed_raster", {}).get("exact+identity", 0)
              > 1 + CONTRACT_LANES,
              f"phase 11: packed_raster did not run in (b) and (c): "
              f"{launched}")
    print(f"phase 11 (renderer contract, action dtypes) took "
          f"{time.perf_counter() - t0:.1f} s on {card}; launches "
          f"{json.dumps(launched)}")
    return launched, worst


_SPIN_RATE = []


# Phase 12: per-lane keys. The lane_random kernel against its plain twin
# at these lane counts and counters, in every mode; the lanes and steps of
# the pure-step, lane-independence and runner-halves checks.
LANE_RANDOM_LANES = (1, 3, 2048)
LANE_RANDOM_COUNTERS = (1, 7, 64)
KEYS_LANES = 16
KEYS_STEPS = 6
KEYS_SUBSET = (3, 7, 12)


# The kernel's modes at the lane counts and counters above: keys lanes
# first and counters first with a start; bits; uniform on [0, 1) and on
# [-3, 5.5); randint over the spans the configs draw (3 shapes, 2 and 4
# Embodied actions), the dm_env adapter's seed range, a negative lo and an
# empty range (lo); normal; the rejection chain in both layouts.
LANE_RANDOM_MODES = (
    ("keys", {}), ("keys", {"start": 5}),
    ("keys", {"counters_first": True, "start": 9}),
    ("bits", {}), ("uniform", {}), ("uniform", {"lo": -3.0, "hi": 5.5}),
    ("randint", {"lo": 0, "hi": 3}), ("randint", {"lo": 0, "hi": 4}),
    ("randint", {"lo": 0, "hi": 2**31 - 1}),
    ("randint", {"lo": -2, "hi": 7}), ("randint", {"lo": 4, "hi": 4}),
    ("normal", {}), ("chain", {}), ("chain", {"counters_first": True}))
# choice's cumulative probabilities: Mixture's default over 3 and a p.
LANE_RANDOM_CHOICES = (np.ones(3) / 3, np.array([0.2, 0.5, 0.3]))


def lane_random_vs_plain(torch, dev="cuda"):
    """Phase 12 (a): `threefry_launch` on the card against its plain twin
    on the same keys, on the card and on the CPU, at every lane count of
    LANE_RANDOM_LANES and counter count of LANE_RANDOM_COUNTERS, in each
    mode of LANE_RANDOM_MODES, on contiguous keys and on keys that are a
    strided slice of a split; and `choice` (the uniform kernel, then a
    search of the cumulative sums) on the card against the CPU. Returns
    the largest number of words that differ (0: bit-exact). The normal's
    float64 log1p is the card's own in the kernel and in the twin on the
    card (equal), and the CPU's in the twin on the CPU: there the two may
    round across a float32 boundary, so its words are counted apart and
    held within one float32 ulp."""
    from spriteworld_torch.ops import lane_random as lr

    worst, cases = 0.0, 0
    normal_cpu = [0, 0]  # float32 words off the CPU twin, largest ulps
    for lanes in LANE_RANDOM_LANES:
        keys = lr.split(lr.key(lanes, dev), lanes)
        views = {"contiguous": keys,
                 "strided": lr.split(keys, 3)[:, 1]}
        for n in LANE_RANDOM_COUNTERS:
            for label, k in views.items():
                for name, kw in LANE_RANDOM_MODES:
                    mode = lr.MODE_NAMES.index(name)
                    got = lr.threefry_launch(k, n, mode, **kw)
                    for on_cpu in (False, True):
                        want = lr.threefry_plain(
                            k.cpu() if on_cpu else k, n, mode,
                            **kw).to(got.device)
                        check(got.shape == want.shape
                              and got.dtype == want.dtype,
                              f"lane_random {label} B={lanes} n={n} "
                              f"{name} {kw}: shape")
                        ulps = (got.view(torch.int32).long()
                                - want.view(torch.int32).long()).abs()
                        if on_cpu and mode == lr.NORMAL:
                            normal_cpu[0] += int((ulps != 0).sum())
                            normal_cpu[1] = max(normal_cpu[1],
                                                int(ulps.max()))
                            continue
                        worst = max(worst, float((ulps != 0).sum()))
                    cases += 1
                for p in LANE_RANDOM_CHOICES:
                    cum = lr.cumulative(p)
                    got = lr.choice(k, n, cum)
                    worst = max(worst, float(
                        (got.cpu() != lr.choice(k.cpu(), n, cum)).sum()))
                    cases += 1
    print(f"lane_random against its plain twin (card and CPU): {cases} "
          f"cases, B in {LANE_RANDOM_LANES}, n in {LANE_RANDOM_COUNTERS}, "
          f"{worst:.0f} words differ; normals against the CPU twin: "
          f"{normal_cpu[0]} words differ, by {normal_cpu[1]} ulp at most")
    check(worst == 0, "lane_random differs from its plain twin")
    check(normal_cpu[1] <= 1, "normals on the card and the CPU differ by "
                              "more than one float32 ulp")
    return worst


# Phase 12 (d): every config in each of its modes, reset from this seed
# over this many lanes on the card and on the CPU.
SEEDED_CONFIGS = (
    ("cobra.exploration", None),
    ("cobra.goal_finding_new_position", "train"),
    ("cobra.goal_finding_new_position", "test"),
    ("cobra.goal_finding_new_shape", "train"),
    ("cobra.goal_finding_new_shape", "test"),
    ("cobra.goal_finding_more_targets", "train"),
    ("cobra.goal_finding_more_targets", "test"),
    ("cobra.goal_finding_more_distractors", "train"),
    ("cobra.goal_finding_more_distractors", "test"),
    ("cobra.clustering", "train"),
    ("cobra.clustering", "test"),
    ("cobra.sorting", "train"),
    ("cobra.sorting", "test"),
    ("examples.goal_finding_embodied", None),
    ("examples.goal_finding_clustering", "train"),
    ("examples.goal_finding_clustering", "test"),
)
SEEDED_SEED = 17
SEEDED_LANES = 64


def seeded_scenes(torch, env_lib, dev="cuda"):
    """Phase 12 (d): `BatchedEnvironment.reset(SEEDED_SEED)` of every
    config of SEEDED_CONFIGS over SEEDED_LANES lanes, on the card (a
    graph) and on the CPU (the plain twins), observing factors and
    success: every state field equal bit for bit, factors and keys
    included. tests/test_torch_seeded_parity.py holds the CPU's to the JAX
    package's. Returns the number of configs."""
    import importlib

    from spriteworld_torch.core import renderers
    from spriteworld_torch.core.state import STATE_FIELDS

    def reset(path, mode, device):
        mod = importlib.import_module(f"spriteworld_torch.configs.{path}")
        cfg = mod.get_config(mode) if mode else mod.get_config()
        cfg["renderers"] = {"factors": renderers.SpriteFactors(),
                            "success": renderers.Success()}
        env = env_lib.Environment(**cfg, device=device)
        state, _ = env_lib.BatchedEnvironment(env, SEEDED_LANES).reset(
            SEEDED_SEED)
        return {n: getattr(state, n).cpu() for n in STATE_FIELDS}

    differ = []
    for path, mode in SEEDED_CONFIGS:
        card, cpu = reset(path, mode, dev), reset(path, mode, "cpu")
        bad = [n for n in STATE_FIELDS if not torch.equal(card[n], cpu[n])]
        if bad or not bool(card["sample_ok"].all()):
            differ.append((path, mode, bad))
    print(f"seeded scenes: reset({SEEDED_SEED}) of {len(SEEDED_CONFIGS)} "
          f"configs x modes at {SEEDED_LANES} lanes, card against the CPU "
          f"twin: {len(SEEDED_CONFIGS) - len(differ)} equal in every state "
          f"field{'' if not differ else f'; differ: {differ}'}")
    check(not differ, f"seeded scenes differ between the card and the CPU: "
                      f"{differ}")
    return len(SEEDED_CONFIGS)


def noisy_low_acceptance_env(bench_torch, env_lib, dev, image_size):
    """The low-acceptance config, its SelectMove with action noise."""
    from spriteworld_torch.core import actions

    env = low_acceptance_env(bench_torch, env_lib, device=dev,
                             image_size=image_size)
    env._action_space = actions.SelectMove(scale=0.25, noise_scale=0.05)
    return env


def pure_step_and_lanes(torch, bench_torch, env_lib, dev="cuda",
                        image_size=(64, 64)):
    """Phase 12 (b): on the low-acceptance config with action noise, the
    compiled (graph, on the card) step is a function of its state and
    actions: two steps from one state (half the lanes resetting) give
    equal states and timesteps; and each lane is a function of its key:
    KEYS_SUBSET of a KEYS_LANES-lane batch, reset and stepped KEYS_STEPS
    times in a batch of their own from the same lane keys and actions,
    equal those lanes of the batch, with rejection deferred (graph) and
    in the eager re-run alike."""
    from spriteworld_torch.core.state import STATE_FIELDS
    from spriteworld_torch.ops import lane_random as lr

    env = noisy_low_acceptance_env(bench_torch, env_lib, dev, image_size)
    use_graph = dev == "cuda"
    big = env_lib.Compiled(dev, KEYS_LANES, use_graph)
    keys = lr.split(lr.key(11, dev), KEYS_LANES)
    actions = env.sample_action(lr.split(lr.key(12, dev),
                                         (KEYS_STEPS, KEYS_LANES)))

    def launch(compiled, what):
        state, ts = what()
        if compiled.pending is not None and bool(compiled.pending):
            state, ts = compiled.rerun(env)
        return state.clone(), env_lib._map_timestep(torch.clone, ts)

    start, _ = launch(big, lambda: big.reset(env, keys))
    start.reset_next[::2] = True
    runs = [launch(big, lambda: big.step(env, start.clone(), actions[0]))
            for _ in range(2)]
    (sa, ta), (sb, tb) = runs
    pure = same_states(torch, sa, sb) and same_timesteps(torch, ta, tb)
    check(pure, "two steps from one state differ")
    check(bool((ta.step_type[::2] == 0).all()), "the resetting lanes did "
                                                 "not reset")

    sub = list(KEYS_SUBSET)
    small = env_lib.Compiled(dev, len(sub), use_graph)
    state, _ = launch(big, lambda: big.reset(env, keys))
    part, _ = launch(small, lambda: small.reset(env, keys[sub]))
    equal = True
    for t in range(KEYS_STEPS):
        state, ts = launch(big, lambda: big.step(env, state, actions[t]))
        part, pts = launch(small, lambda: small.step(env, part,
                                                     actions[t][sub]))
        equal = equal and all(torch.equal(getattr(state, n)[sub],
                                          getattr(part, n))
                              for n in STATE_FIELDS) \
            and torch.equal(ts.step_type[sub], pts.step_type) \
            and torch.equal(ts.observation["image"][sub],
                            pts.observation["image"])
    check(equal, f"lanes {sub} of {KEYS_LANES} differ from the same lanes "
                 "stepped alone")
    print(f"keys: a step is a function of its state (two steps from one "
          f"state equal, half the lanes resetting, with action noise); "
          f"lanes {sub} of {KEYS_LANES} equal the same lane keys stepped "
          f"{KEYS_STEPS} times alone ({'graph' if use_graph else 'eager'}; "
          f"re-runs {big.reruns} and {small.reruns})")
    return big.reruns + small.reruns


@contextlib.contextmanager
def local_metrics(mesh_lib):
    """Within the block a mesh's metric all-reduce leaves each rank's own
    sums: ranks of a mesh without a process group then run one after the
    other in one process."""
    saved = mesh_lib.Replicated.all_reduce
    mesh_lib.Replicated.all_reduce = lambda self, tensor, op="sum": tensor
    try:
        yield
    finally:
        mesh_lib.Replicated.all_reduce = saved


def runner_halves(torch, bench_torch, dev="cuda"):
    """Phase 12 (c): a runner of KEYS_LANES lanes against two runners of
    half as many, ranks 0 and 1 of a two-rank mesh stepped one after the
    other on one card (their action keys sliced as the mesh slices them,
    their metrics left local): every lane's step types, rewards and state,
    and the summed metrics' counts, equal; the float32 sums to rounding."""
    from spriteworld_torch.core.state import STATE_FIELDS
    from spriteworld_torch.parallel import ShardedRunner
    from spriteworld_torch.parallel import mesh as mesh_lib

    def run(mesh, lanes):
        env = bench_torch.build_env(anti_aliasing=1, image_size=(16, 16),
                                    device=dev, seed=0)
        env._max_episode_length = 3  # auto-resets inside the rollout
        runner = ShardedRunner(env, lanes, mesh=mesh)
        state, _ = runner.reset(21)
        state, m, tss = runner.rollout(state, KEYS_STEPS,
                                       return_timesteps=True)
        return state, m, tss

    whole = run(None, KEYS_LANES)
    with local_metrics(mesh_lib):
        halves = [run(mesh_lib.EnvMesh(size=2, rank=r,
                                       device=torch.device(dev)), KEYS_LANES)
                  for r in range(2)]
    state = {n: torch.cat([getattr(h[0], n) for h in halves])
             for n in STATE_FIELDS}
    equal = all(torch.equal(state[n], getattr(whole[0], n))
                for n in STATE_FIELDS) and all(
        torch.equal(torch.cat([getattr(h[2], f) for h in halves], 1)
                    .nan_to_num(), getattr(whole[2], f).nan_to_num())
        for f in ("step_type", "reward"))
    m = [h[1] for h in halves]
    counts = (m[0].episodes + m[1].episodes,
              m[0].successes + m[1].successes)
    sums = m[0].reward_sum + m[1].reward_sum
    check(equal and counts == (whole[1].episodes, whole[1].successes)
          and abs(sums - whole[1].reward_sum)
          <= 1e-5 * max(1.0, abs(whole[1].reward_sum)),
          f"the two halves differ from the whole runner: lanes equal "
          f"{equal}, counts {counts} against "
          f"{(whole[1].episodes, whole[1].successes)}")
    print(f"keys: a runner of {KEYS_LANES} lanes equals ranks 0 and 1 of "
          f"two stepped one after the other, lane for lane over "
          f"{KEYS_STEPS} steps ({whole[1].episodes} episodes)")


def record_lane_random(step):
    """The lane_random draws of `step()`: [(keys, n, mode, start,
    counters_first, lo, hi)] with each call's keys copied."""
    from spriteworld_torch.ops import lane_random as lr

    calls, draw = [], lr._threefry

    def recording(keys, n, mode, start=0, counters_first=False, lo=0.0,
                  hi=1.0):
        calls.append((keys.clone(), n, mode, start, counters_first, lo, hi))
        return draw(keys, n, mode, start, counters_first, lo, hi)

    lr._threefry = recording
    try:
        step()
    finally:
        lr._threefry = draw
    return calls


def lane_random_work(calls):
    """(threefry blocks, bytes, operations) of lane_random `calls` (as
    `record_lane_random` gives them): a block an output (keys, bits,
    uniform, normal), four an output of randint (the key's two halves and
    a block of each), two a round of the chain; each call's keys read once
    (8 bytes a lane) and its outputs written once (8 bytes a key, 4 a
    word). ~110 32-bit integer operations a block, counted at the float32
    rate outside the tensor cores (the table's nearest), and ~25 float32
    operations a normal (ErfInv32's polynomial and its log1p)."""
    from spriteworld_torch.ops import lane_random as lr

    blocks = nbytes = ops = 0.0
    for keys, n, mode, *_ in calls:
        lanes = keys.numel() // 2
        per = {lr.RANDINT: 4, lr.CHAIN: 2}.get(mode, 1)
        blocks += lanes * n * per
        outs = lanes * (n + 1 if mode == lr.CHAIN else n)
        nbytes += lanes * 8 + outs * (8 if mode in (lr.KEYS, lr.CHAIN)
                                      else 4)
        ops += 110.0 * lanes * n * per + (
            25.0 * lanes * n if mode == lr.NORMAL else 0.0)
    return blocks, nbytes, ops


# The kernels-line's modes timed alone at BATCH lanes: (mode, n, kwargs),
# the shapes a step draws (randint's one shape a lane, a rejection node's
# REJECTION_ROUNDS proposals of six sprites, four noise normals).
LANE_RANDOM_TIMED = (("keys", 2, {}), ("uniform", 1, {}),
                     ("randint", 1, {"lo": 0, "hi": 3}),
                     ("normal", 4, {}), ("chain", 32, {"sprites": 6}))


def time_lane_random_modes(torch, card):
    """Each mode of LANE_RANDOM_TIMED alone on BATCH lanes' keys (the
    chain on BATCH x sprites keys, counters first): eager (`ms`), on the
    device behind a spin (`device_ms`) and in a graph (`graph_ms`), beside
    its bound. Returns {mode: {...}}."""
    from spriteworld_torch.ops import lane_random as lr

    out = {}
    for name, n, kw in LANE_RANDOM_TIMED:
        kw = dict(kw)
        shape = (BATCH, kw.pop("sprites")) if "sprites" in kw else (BATCH,)
        keys = lr.split(lr.key(5, "cuda"), shape)
        mode = lr.MODE_NAMES.index(name)
        first = mode == lr.CHAIN
        call = (keys, n, mode, 0, first, kw.get("lo", 0.0),
                kw.get("hi", 1.0))

        def fn(call=call):
            lr.threefry_launch(*call)

        _, nbytes, ops = lane_random_work([call])
        bound_ms, bound_by = bound(nbytes, 0, ops)
        out[name] = {"lanes": list(shape), "n": n,
                     "ms": event_ms(torch, fn, 50),
                     "device_ms": event_ms(torch, fn, 50, spin=True),
                     "graph_ms": graph_ms(torch, fn, 20),
                     "bound_ms": bound_ms, "bound_by": bound_by}
    print("lane_random by mode at " + ", ".join(
        f"{k} {tuple(v['lanes'])}x{v['n']}: {v['ms']:.4f} ms "
        f"({v['device_ms']:.4f} on the device, {v['graph_ms']:.4f} in a "
        f"graph; bound {v['bound_ms']:.6f}, {v['bound_by']})"
        for k, v in out.items()) + f"; on {card}")
    return out


def time_lane_random(torch, bench_torch, env_lib, card, launches, steps):
    """The kernels-line entry of lane_random: the draws of one eager
    image64/AA=5 step at BATCH lanes (recorded, then replayed), kernel
    against plain twin (held equal), timed together (`ms`, `device_ms`,
    `graph_ms`) beside the plain twin; the bound from `lane_random_work`;
    `launches` is the main path's count (phase 4), over `steps` steps;
    `by_mode` times each mode alone (`time_lane_random_modes`)."""
    from spriteworld_torch.ops import lane_random as lr

    env = bench_torch.build_env(anti_aliasing=5, device="cuda", seed=0)
    benv = env_lib.BatchedEnvironment(env, BATCH, use_graph=False)
    state, _ = benv.reset(3)
    state, _ = benv.step(state, benv.sample_actions())
    calls = record_lane_random(
        lambda: benv.step(state, benv.sample_actions()))
    worst = 0.0
    for keys, n, mode, start, first, lo, hi in calls:
        got = lr.threefry_launch(keys, n, mode, start, first, lo, hi)
        want = lr.threefry_plain(keys, n, mode, start, first, lo, hi)
        worst = max(worst, float((got.view(torch.int32)
                                  != want.view(torch.int32)).sum()))
    check(worst == 0, "lane_random differs from plain on the step's draws")

    def kernel():
        for c in calls:
            lr.threefry_launch(*c)

    def plain():
        for c in calls:
            lr.threefry_plain(*c)

    blocks, nbytes, ops = lane_random_work(calls)
    by_mode = {}
    for k in calls:
        name = lr.MODE_NAMES[k[2]]
        by_mode[name] = by_mode.get(name, 0) + 1
    bound_ms, bound_by = bound(nbytes, 0, ops)
    entry = {
        "name": "lane_random", "route": "cuda",
        "source": "spriteworld_torch/csrc/lane_random.cu",
        "replaces": "spriteworld_tpu/core/environment.py:105 (XLA's "
                    "threefry under jax.random; no pallas_call)",
        "launches": launches, "max_abs_err": worst,
        "ms": event_ms(torch, kernel, 20),
        "device_ms": event_ms(torch, kernel, 20, spin=True),
        "graph_ms": graph_ms(torch, kernel, 10),
        "plain_ms": event_ms(torch, plain, 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_tc_ms": bound_ms, "bound_tc_by": bound_by,
        "library_ms": None,
        "step_draws": len(calls), "step_draws_by_mode": by_mode,
        "step_blocks": blocks, "launches_per_step": launches / steps,
        "by_mode": time_lane_random_modes(torch, card)}
    print(f"lane_random: one image64/AA=5 step at {BATCH} lanes draws "
          f"{len(calls)} times ({by_mode}, {blocks:.0f} blocks): kernel "
          f"{entry['ms']:.4f} ms ({entry['device_ms']:.4f} on the device, "
          f"{entry['graph_ms']:.4f} in a graph), plain "
          f"{entry['plain_ms']:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}); {launches} launches on the main path, "
          f"{launches / steps:.1f} a step; on {card}")
    return entry


# The benchmarked configurations (train mode) whose leaf-tree generators
# the kernels line's lane_random_scene entry draws; the first is timed.
SCENE_CONFIGS = ("cobra.sorting", "examples.goal_finding_clustering",
                 "cobra.goal_finding_new_position")


def generate_sprites_of(gen, out=None):
    """Every `GenerateSprites` node under `gen`, depth first, as often as
    the tree evaluates it."""
    from spriteworld_torch.core import generators

    out = [] if out is None else out
    if isinstance(gen, generators.GenerateSprites):
        out.append(gen)
    for child in getattr(gen, "gens", ()):
        generate_sprites_of(child, out)
    if hasattr(gen, "gen"):
        generate_sprites_of(gen.gen, out)
    return out


def scene_work(table, lanes, kmax):
    """(threefry blocks, bytes, operations) of one scene launch of `table`
    over `lanes` lanes of `kmax` slots: the blocks the scene needs
    (`SceneTable.needed_blocks`: the count and the sprites' key once a
    lane; a slot's key, its components' keys and its draws once a slot),
    not the ones the kernel's threads compute again; each lane's key read
    once (8 bytes), its factors, count and status written once; 110
    integer operations a block at the float32 rate (`lane_random_work`)."""
    blocks = table.needed_blocks(lanes, kmax)
    nbytes = lanes * (8 + 4 * kmax * table.width + 4 + 1)
    return blocks, nbytes, 110.0 * blocks


def scene_words_apart(torch, got, want):
    """Words in which two scenes (factors, num, ok) differ, factors by
    their bits."""
    return (int((got[0].view(torch.int32) != want[0].view(torch.int32))
                .sum()) + int((got[1] != want[1]).sum())
            + int((got[2] != want[2]).sum()))


def time_lane_random_scene(torch, card, launches, steps, lanes=BATCH,
                           dev="cuda"):
    """The kernels-line entry of the lane_random kernel's scene mode
    (`lane_random.draw_scene`): for each of SCENE_CONFIGS, its leaf-tree
    generators' scenes on `lanes` strided card keys against their plain
    bodies (`GenerateSprites._sample_plain`) on the same keys (held 0
    words apart), then all of them timed eagerly (`ms`, `device_ms`) and
    in a graph (`graph_ms`) beside the plain bodies (`plain_ms`,
    `plain_graph_ms`), with the bound of the blocks they need
    (`scene_work`); the first config's numbers head the entry. Registers
    and spill from the build log; `launches` is the main path's count of
    scene launches (phase 4), over `steps` steps."""
    import importlib

    from spriteworld_torch.ops import _build
    from spriteworld_torch.ops import lane_random as lr

    keys = lr.split(lr.key(2**31 + 99, dev), (lanes, 2))[:, 1]
    worst, by_config = 0, {}
    for config in SCENE_CONFIGS:
        mod = importlib.import_module(f"spriteworld_torch.configs.{config}")
        every = generate_sprites_of(mod.get_config("train")["init_sprites"])
        gens = [g for g in every if g._scene is not None]
        apart = sum(scene_words_apart(
            torch, lr.draw_scene(keys, g._scene, g.max_sprites),
            g._sample_plain(keys)) for g in gens)
        worst = max(worst, apart)

        def kernel(gens=gens):
            for g in gens:
                lr.draw_scene(keys, g._scene, g.max_sprites)

        def plain(gens=gens):
            for g in gens:
                g._sample_plain(keys)

        work = [scene_work(g._scene, lanes, g.max_sprites) for g in gens]
        blocks, nbytes, ops = (sum(w[i] for w in work) for i in range(3))
        bound_ms, bound_by = bound(nbytes, 0, ops)
        by_config[config] = {
            "generators": len(every), "scene": len(gens),
            "slots": sorted({g.max_sprites for g in gens}),
            "words_apart": apart,
            "ms": event_ms(torch, kernel, 20),
            "device_ms": event_ms(torch, kernel, 20, spin=True),
            "graph_ms": graph_ms(torch, kernel, 10),
            "plain_ms": event_ms(torch, plain, 3),
            "plain_graph_ms": graph_ms(torch, plain, 3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "blocks_needed": blocks,
            "blocks_computed": sum(lanes * g.max_sprites * g._scene.blocks
                                   for g in gens)}
        row = by_config[config]
        print(f"lane_random_scene, {config}: {row['scene']} of "
              f"{row['generators']} generators at {lanes} lanes, "
              f"{apart} words apart from their plain bodies; kernel "
              f"{row['ms']:.4f} ms ({row['device_ms']:.4f} on the device, "
              f"{row['graph_ms']:.4f} in a graph), plain "
              f"{row['plain_ms']:.4f} ms ({row['plain_graph_ms']:.4f} in a "
              f"graph), bound {bound_ms:.6f} ms ({bound_by}; {blocks} "
              f"blocks needed, {row['blocks_computed']} computed); on "
              f"{card}")
    check(worst == 0, "the lane_random scene mode differs from the plain "
          "body")
    head = by_config[SCENE_CONFIGS[0]]
    regs, spill = ptxas_lines(_build, "lane_random",
                              "lane_random_scene_kernel")
    entry = {
        "name": "lane_random_scene", "route": "cuda",
        "source": "spriteworld_torch/csrc/lane_random.cu",
        "replaces": "spriteworld_tpu/core/generators.py:108 (XLA's fusion "
                    "of GenerateSprites and its Product under vmap; no "
                    "pallas_call)",
        "launches": launches, "max_abs_err": worst,
        **{k: head[k] for k in ("ms", "device_ms", "graph_ms", "plain_ms",
                                "plain_graph_ms", "bound_ms", "bound_by",
                                "blocks_needed", "blocks_computed")},
        "bound_tc_ms": head["bound_ms"], "bound_tc_by": head["bound_by"],
        "library_ms": None, "registers": regs, "spill_bytes": spill,
        "scene_draws": head["scene"], "launches_per_step": launches / steps,
        "by_config": by_config}
    print(f"lane_random_scene: {regs} registers, {spill} bytes spilled; "
          f"{launches} scene launches on the main path, "
          f"{launches / steps:.1f} a step; on {card}")
    return entry


# The configurations and modes whose roots the kernels line's
# lane_random_tree entry draws in the tree mode; the first is timed.
TREE_CONFIGS = (("cobra.sorting", "train"), ("cobra.sorting", "test"),
                ("cobra.clustering", "train"),
                ("cobra.goal_finding_new_shape", "train"),
                ("cobra.goal_finding_more_targets", "train"),
                ("cobra.goal_finding_more_distractors", "train"),
                ("cobra.goal_finding_new_position", "test"),
                ("examples.goal_finding_clustering", "test"),
                ("examples.goal_finding_embodied", None))


@contextlib.contextmanager
def plain_routes(gen, leaves=False):
    """Every composite under `gen` takes its plain body while the block
    runs (the route before the tree mode: the leaves' scene mode under the
    composites' bodies); with `leaves` every `GenerateSprites` too."""
    saved, stack = [], [gen]
    while stack:
        node = stack.pop()
        stack += list(getattr(node, "gens", ())) + (
            [node.gen] if hasattr(node, "gen") else [])
        for attr in ("_tree",) + (("_scene",) if leaves else ()):
            if hasattr(node, attr):
                saved.append((node, attr, getattr(node, attr)))
                setattr(node, attr, None)
    try:
        yield
    finally:
        for node, attr, value in saved:
            setattr(node, attr, value)


def time_lane_random_tree(torch, card, launches, scene_launches, steps,
                          lanes=BATCH, dev="cuda"):
    """The kernels-line entry of the lane_random kernel's tree mode
    (`lane_random.draw_tree`): for each of TREE_CONFIGS, its root's scene
    on `lanes` strided card keys against the composites' plain bodies over
    the leaves' scene mode (the route before the tree mode) and against
    every node's plain body on the same keys (held 0 words apart), timed
    eagerly (`ms`, `device_ms`) and in a graph (`graph_ms`) beside the
    route before it (`plain_ms`, `plain_graph_ms`), with the bound of the
    blocks the lanes' chosen branches need (`TreeTable.needed_blocks`);
    the first config's numbers head the entry. Registers and spill of the
    tree and scene kernels from the build log; `launches` and
    `scene_launches` are the main path's tree and scene launches (phase
    4), over `steps` steps."""
    import importlib

    from spriteworld_torch.ops import _build
    from spriteworld_torch.ops import lane_random as lr

    keys = lr.split(lr.key(2**31 + 98, dev), (lanes, 2))[:, 1]
    worst, by_config = 0, {}
    for config, mode in TREE_CONFIGS:
        mod = importlib.import_module(f"spriteworld_torch.configs.{config}")
        root = (mod.get_config(mode) if mode else mod.get_config())[
            "init_sprites"]
        table = root._tree
        check(table is not None, f"{config} ({mode}): its root does not take "
              "the tree mode")
        got = lr.draw_tree(keys, table)
        apart = 0
        for leaves in (False, True):
            with plain_routes(root, leaves):
                apart += scene_words_apart(torch, got,
                                           root.sample_with_status(keys))
        worst = max(worst, apart)

        def kernel(table=table):
            lr.draw_tree(keys, table)

        def before(root=root):
            with plain_routes(root):
                root.sample_with_status(keys)

        blocks = table.needed_blocks(lanes)
        nbytes = lanes * (8 + 4 * table.kmax * table.width + 4 + 1)
        bound_ms, bound_by = bound(nbytes, 0, 110.0 * blocks)
        name = f"{config}.{mode}" if mode else config
        by_config[name] = {
            "slots": table.kmax, "words_apart": apart,
            "ms": event_ms(torch, kernel, 20),
            "device_ms": event_ms(torch, kernel, 20, spin=True),
            "graph_ms": graph_ms(torch, kernel, 10),
            "plain_ms": event_ms(torch, before, 3),
            "plain_graph_ms": graph_ms(torch, before, 3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "blocks_needed": blocks,
            "blocks_computed": lanes * table.blocks}
        row = by_config[name]
        print(f"lane_random_tree, {name}: {table.kmax} slots at {lanes} "
              f"lanes, {apart} words apart from the plain bodies; kernel "
              f"{row['ms']:.4f} ms ({row['device_ms']:.4f} on the device, "
              f"{row['graph_ms']:.4f} in a graph), the route before it "
              f"{row['plain_ms']:.4f} ms ({row['plain_graph_ms']:.4f} in a "
              f"graph), bound {bound_ms:.6f} ms ({bound_by}; {blocks:.0f} "
              f"blocks needed, {row['blocks_computed']:.0f} computed); on "
              f"{card}")
    check(worst == 0, "the lane_random tree mode differs from the plain "
          "bodies")
    head = by_config[next(iter(by_config))]
    regs, spill = ptxas_lines(_build, "lane_random", "lane_random_tree_kernel")
    scene_regs, scene_spill = ptxas_lines(_build, "lane_random",
                                          "lane_random_scene_kernel")
    entry = {
        "name": "lane_random_tree", "route": "cuda",
        "source": "spriteworld_torch/csrc/lane_random.cu",
        "replaces": "spriteworld_tpu/core/generators.py:132-197 (XLA's "
                    "fusion of ChainGenerators, SampleGenerator's lax.switch "
                    "and Shuffle under vmap; no pallas_call)",
        "launches": launches, "max_abs_err": worst,
        **{k: head[k] for k in ("ms", "device_ms", "graph_ms", "plain_ms",
                                "plain_graph_ms", "bound_ms", "bound_by",
                                "blocks_needed", "blocks_computed")},
        "bound_tc_ms": head["bound_ms"], "bound_tc_by": head["bound_by"],
        "library_ms": None, "registers": regs, "spill_bytes": spill,
        "scene_registers": scene_regs, "scene_spill_bytes": scene_spill,
        "launches_per_step": launches / steps,
        "scene_launches_per_step": scene_launches / steps,
        "by_config": by_config}
    print(f"lane_random_tree: {regs} registers, {spill} bytes spilled "
          f"(lane_random_scene_kernel: {scene_regs}, {scene_spill}); "
          f"{launches} tree and {scene_launches} scene launches on the main "
          f"path, {launches / steps:.1f} and {scene_launches / steps:.1f} a "
          f"step; on {card}")
    return entry


# The configurations whose task the kernels line's task_eval entry times,
# the first heading the entry: the benchmarked rollout cells'.
TASK_CONFIGS = ("examples.goal_finding_clustering", "cobra.sorting",
                "cobra.goal_finding_new_position")


def time_task_eval(torch, card, launches, steps, lanes=BATCH, dev="cuda"):
    """The kernels-line entry of `csrc/task_eval.cu`: every shipped
    config's task in both modes on its seeded scenes at `lanes` lanes
    (`tests/test_torch_task_eval.py`'s states: fresh scenes, then moved
    onto a grid and onto colour bounds) and on the edge states, each
    output the kernel gives held 0 words apart from the task's methods on
    the card; then, for each of TASK_CONFIGS, a step's three evaluations
    (the transition's three outputs, the fresh scene's validity, the
    render's success) timed through the kernel eagerly (`ms`, `device_ms`)
    and in a graph (`graph_ms`), the transition's launch alone in a graph
    (`launch_graph_ms`), beside the methods (`plain_ms`,
    `plain_graph_ms`), with the bound of the bytes read and written.
    Registers and spill from the build log; `launches` is the main path's
    count (phase 4), over `steps` steps."""
    import importlib.util
    import pathlib

    from spriteworld_torch.core import tasks
    from spriteworld_torch.ops import _build, task_eval

    # By path: another installed package may own the name `tests`.
    path = pathlib.Path(__file__).resolve().parent / "tests" \
        / "test_torch_task_eval.py"
    spec = importlib.util.spec_from_file_location("task_eval_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)

    every = task_eval.REWARD | task_eval.SUCCESS | task_eval.VALID
    worst, by_config = 0, {}
    for name in cases.CONFIGS:
        for mode in ("train", "test"):
            env, states = cases.seeded_states(name, mode, lanes, dev)
            table = tasks.task_table(env.task)
            for factors, num in states:
                got = task_eval.task_eval(table, factors, num, every, "check")
                worst = max(worst, cases.words_apart(
                    [g.cpu().numpy() for g in got],
                    cases.methods(env.task, factors, num)))
    for _, task, factors, num in cases.edge_states(dev):
        got = task_eval.task_eval(tasks.task_table(task), factors, num,
                                  every, "check")
        worst = max(worst, cases.words_apart([g.cpu().numpy() for g in got],
                                             cases.methods(task, factors,
                                                           num)))
    check(worst == 0, "task_eval differs from the task's methods")
    for name in TASK_CONFIGS:
        env, states = cases.seeded_states(name, "train", lanes, dev)
        factors, num = states[0]
        ev = tasks.Evaluator(env.task)

        def kernel(ev=ev, f=factors, n=num):
            ev.evaluate(f, n, every, "transition")
            ev.evaluate(f, n, task_eval.VALID, "fresh")
            ev.evaluate(f, n, task_eval.SUCCESS, "render")

        def plain(task=env.task, f=factors, n=num):
            task.reward(f, n)
            task.success(f, n)
            tasks.task_valid(task, f, n)
            tasks.task_valid(task, f, n)
            task.success(f, n)

        in_bytes = factors.numel() * 4 + num.numel() * 4
        bound_ms, bound_by = bound(in_bytes, lanes * 6, 0.0)
        by_config[name] = {
            "slots": factors.shape[1], "words": len(ev.table),
            "ms": event_ms(torch, kernel, 50),
            "device_ms": event_ms(torch, kernel, 50, spin=True),
            "graph_ms": graph_ms(torch, kernel, 20),
            "launch_graph_ms": graph_ms(torch, lambda ev=ev, f=factors,
                                        n=num: ev.evaluate(f, n, every,
                                                           "transition"),
                                        20),
            "plain_ms": event_ms(torch, plain, 5),
            "plain_graph_ms": graph_ms(torch, plain, 5),
            "bound_ms": 3 * bound_ms, "bound_by": bound_by,
            "bytes": 3 * (in_bytes + lanes * 6)}
        row = by_config[name]
        print(f"task_eval, {name}: a step's 3 launches at {lanes} lanes of "
              f"{row['slots']} slots {row['ms']:.4f} ms "
              f"({row['device_ms']:.4f} on the device, {row['graph_ms']:.4f}"
              f" in a graph; the transition's {row['launch_graph_ms']:.4f}),"
              f" the methods {row['plain_ms']:.4f} ms "
              f"({row['plain_graph_ms']:.4f} in a graph), bound "
              f"{row['bound_ms']:.6f} ms ({bound_by}); on {card}")
    head = by_config[TASK_CONFIGS[0]]
    regs, spill = ptxas_lines(_build, "task_eval")
    entry = {
        "name": "task_eval", "route": "cuda",
        "source": "spriteworld_torch/csrc/task_eval.cu",
        "replaces": "spriteworld_tpu/core/tasks.py and ops/clustering.py "
                    "(XLA's fusion of the tasks' reward, success and "
                    "validity; no pallas_call)",
        "launches": launches, "max_abs_err": worst,
        **{k: head[k] for k in ("ms", "device_ms", "graph_ms", "plain_ms",
                                "plain_graph_ms", "bound_ms", "bound_by",
                                "bytes")},
        "bound_tc_ms": head["bound_ms"], "bound_tc_by": head["bound_by"],
        "library_ms": None, "registers": regs, "spill_bytes": spill,
        "launches_per_step": launches / steps, "by_config": by_config}
    print(f"task_eval: {worst} words apart from the methods; {regs} "
          f"registers, {spill} bytes spilled; {launches} launches on the "
          f"main path, {launches / steps:.1f} a step; on {card}")
    return entry


def lane_keys_phase(torch, bench_torch, env_lib, card, dev="cuda"):
    """Phase 12: per-lane keys on the card (see the module docstring).
    Returns the largest kernel-against-plain difference."""
    from spriteworld_torch.ops import lane_random as lr

    t0 = time.perf_counter()
    worst = lane_random_vs_plain(torch, dev) if dev == "cuda" else 0.0
    counted = lr.threefry_launch.launches
    pure_step_and_lanes(torch, bench_torch, env_lib, dev)
    runner_halves(torch, bench_torch, dev)
    seeded_scenes(torch, env_lib, dev)
    print(f"phase 12 (per-lane keys; {lr.threefry_launch.launches - counted}"
          f" lane_random launches) took {time.perf_counter() - t0:.1f} s "
          f"on {card}")
    return worst


def spin_cycles_per_ms(torch):
    """Cycles of `torch.cuda._sleep` the card spins a millisecond, timed
    once a process between two events."""
    if not _SPIN_RATE:
        torch.cuda._sleep(1 << 20)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1 << 23)
        end.record()
        end.synchronize()
        _SPIN_RATE.append((1 << 23) / start.elapsed_time(end))
    return _SPIN_RATE[0]


def event_ms(torch, fn, reps, spin=False):
    """Mean device time of one call of `fn` over `reps` calls, after one,
    between two events (`ms` in the kernels line). With `spin` the card
    first spins for 1.5 times the host's time to enqueue the calls, at its
    measured spin rate, so they run back to back and a kernel shorter than
    its wrapper's host time is timed on the device, not on the host
    (`device_ms`)."""
    fn()
    torch.cuda.synchronize()
    cycles = 0
    if spin:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        cycles = int(spin_cycles_per_ms(torch)
                     * min(1.5 * reps * host_s, 2.0) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if cycles:
        torch.cuda._sleep(cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps):
    """Mean device time of one call of `fn` inside a CUDA graph of `reps`
    calls, between two events around one replay after a warm one
    (`graph_ms` in the kernels line: the kernel as the runner's graph
    replays it, with no wrapper on the host)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def table_bytes(tables):
    """Bytes of prepared `tables` a kernel must read: every sprite's edge
    count, and for each live sprite whose rows meet the canvas its other
    scalars, its `count` edges (5 floats each) and its `nf` features (3
    each); not the padding of each row to V edges and 2V features."""
    from spriteworld_torch.ops import rasterize_cuda as s

    tab = tables.tab
    count, nf = tab[..., s.T_COUNT], tab[..., s.T_NF]
    meets = ((count > 0) & (tab[..., s.T_ROW0] <= tables.hc - 1)
             & (tab[..., s.T_ROW1] >= 0))
    per = (s.NUM_SCALARS - 1 + s.NUM_EDGE_FIELDS * count
           + s.NUM_FEATURE_FIELDS * nf)
    return 4 * (count.numel() + int((per * meets).sum()))


def fill_ops(tables):
    """A compare and an add per edge for every pixel of each live sprite's
    bounds (clipped to the canvas): the exact fill's operations."""
    from spriteworld_torch.ops import rasterize_cuda as s

    tab = tables.tab
    rows = (tab[..., s.T_ROW1].clamp(max=tables.hc - 1)
            - tab[..., s.T_ROW0].clamp(min=0) + 1).clamp(min=0)
    cols = (tab[..., s.T_COL1].clamp(max=tables.wc - 1)
            - tab[..., s.T_COL0].clamp(min=0) + 1).clamp(min=0)
    return float((rows * cols * tab[..., s.T_COUNT] * 2).sum())


def compacted_fill_ops(torch, tables):
    """The exact fill's operations as the kernels do them: per live sprite
    and row of its bounds, 5 per edge for the crossing (a subtract, a
    multiply, an add) and the row-range test (two compares); per pixel of
    the bounds a compare and an add for each crossing the row keeps (the
    edges left with a weight after the odd-total trim)."""
    from spriteworld_torch.ops import rasterize_cuda as s

    total = 0.0
    for _, sub in s._plain_chunks(tables, s._PLAIN_PIXELS):
        rows = torch.arange(sub.hc, dtype=torch.float32,
                            device=sub.tab.device)
        for k in range(sub.tab.shape[1]):
            t = sub.tab[:, k]
            crossings = (s.exact_crossings(sub, k)[1] > 0).sum(-1)  # [B, hc]
            cols = (t[:, s.T_COL1].clamp(max=sub.wc - 1)
                    - t[:, s.T_COL0].clamp(min=0) + 1).clamp(min=0)
            inb = ((rows[None] >= t[:, s.T_ROW0, None])
                   & (rows[None] <= t[:, s.T_ROW1, None])
                   & (t[:, s.T_COUNT, None] > 0))
            per_row = 5 * t[:, s.T_COUNT, None] + 2 * crossings * cols[:, None]
            total += float((per_row * inb).sum())
    return total


def uniform_units(torch, tables, w):
    """(h-pass units whose window holds one slot throughout, all units) of
    these exact or centroid tables rendered to width w with Lanczos: a unit
    is 16 outputs (one m-tile's window of canvas columns) by 8 canvas rows.
    The kernels skip the products of such a unit (colour times tap sum)."""
    from spriteworld_torch.ops import rasterize_cuda as s

    tiles = s.lanczos_tiles(tables.wc, w)
    window = 32 * tiles.ksteps
    uniform = total = 0
    for _, sub in s._plain_chunks(tables, s._PLAIN_PIXELS):
        b, k, _ = sub.tab.shape
        slots = torch.zeros((b, sub.hc, tiles.pitch), dtype=torch.uint8,
                            device=sub.tab.device)
        for i in range(k):
            slots[..., :sub.wc] = torch.where(s._plain_fill(sub, i), i + 1,
                                              slots[..., :sub.wc])
        for start in tiles.kstart[:(w + 15) // 16]:
            win = slots[..., start:start + window].reshape(
                b, sub.hc // 8, 8 * window)
            uniform += int((win == win[..., :1]).all(-1).sum())
            total += win.shape[0] * win.shape[1]
    return uniform, total


def slot_canvas(torch, tables):
    """Yields u8[b, hc, wc] slot canvases (0 = background, k + 1 = sprite k
    on top) of `tables`, a chunk of scenes at a time."""
    from spriteworld_torch.ops import rasterize_cuda as s

    for _, sub in s._plain_chunks(tables, s._PLAIN_PIXELS):
        b, k, _ = sub.tab.shape
        slots = torch.zeros((b, sub.hc, sub.wc), dtype=torch.uint8,
                            device=sub.tab.device)
        for i in range(k):
            slots = torch.where(s._plain_fill(sub, i), i + 1, slots)
        yield slots


def lanczos_ops(resample, in_size, out_size, scenes, lines):
    """A multiply and an add per tap and channel of each output of one
    Lanczos pass over `lines` lines of `scenes` scenes."""
    taps = sum(len(q) for q in resample.pil_lanczos_fixed(in_size,
                                                          out_size)[1])
    return scenes * lines * taps * 3 * 2


def bound(in_bytes, out_bytes, ops, tc_ops=0.0):
    """(bound ms, "bytes" or "operations"): `ops` at the float32 rate and
    `tc_ops` at the int8 tensor-core rate."""
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = (ops / FP32_OPS_PER_S + tc_ops / INT8_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms
                                   else "operations")


def bounds(in_bytes, out_bytes, ops, fill_tc, lanczos_tc):
    """The two bounds of a kernel: `bound_ms` counts `ops` (the fill at
    every edge for every pixel of the bounds, every Lanczos tap) at the
    float32 rate, the column every PR has; `bound_tc_ms` counts the work as
    the kernels now do it: `fill_tc` compacted-fill operations at the
    float32 rate and `lanczos_tc` multiply-adds, those of the h-pass units
    that hold more than one slot and all of the v-pass's, at the int8
    tensor-core rate."""
    ms, by = bound(in_bytes, out_bytes, ops)
    tc_ms, tc_by = bound(in_bytes, out_bytes, fill_tc, lanczos_tc)
    return {"bound_ms": ms, "bound_by": by, "bound_tc_ms": tc_ms,
            "bound_tc_by": tc_by}


def time_strips(torch, rasterize_cuda, colors, state):
    """Phase 8, strips: strip_raster and strip_vpass at the demo path's
    inputs. Returns their `kernels` entries."""
    rc = rasterize_cuda
    size = (DEMO_SIZE, DEMO_SIZE)
    hc = DEMO_SIZE * DEMO_AA
    b = state.factors.shape[0]
    tables = rc.prepare(state.factors, state.num_sprites, hc, hc,
                        colors.hsv_to_rgb)
    hp = rc.strip_raster(tables, size)
    hp_plain = rc.hpass_plain(tables, DEMO_SIZE)
    err_h, count_h = compare(hp, hp_plain)
    img = rc.strip_vpass(hp, DEMO_SIZE)
    img_plain = rc.vpass_plain(hp_plain, DEMO_SIZE)
    err_v, count_v = compare(img, img_plain)
    print(f"strip kernels vs plain at the demo path's inputs, B={b}: "
          f"h-pass max |diff| {err_h} ({count_h} differing), v-pass max "
          f"|diff| {err_v} ({count_v} differing)")
    check(count_h == 0 and count_v == 0,
          "strip kernels differ from the plain version at the demo inputs")

    ms_h = event_ms(torch, lambda: rc.strip_raster(tables, size), 10)
    dev_h = event_ms(torch, lambda: rc.strip_raster(tables, size), 10, True)
    plain_h = event_ms(torch, lambda: rc.hpass_plain(tables, DEMO_SIZE), 1)
    graph_h = graph_ms(torch, lambda: rc.strip_raster(tables, size), 10)
    ms_v = event_ms(torch, lambda: rc.strip_vpass(hp, DEMO_SIZE), 20)
    dev_v = event_ms(torch, lambda: rc.strip_vpass(hp, DEMO_SIZE), 20, True)
    graph_v = graph_ms(torch, lambda: rc.strip_vpass(hp, DEMO_SIZE), 20)
    plain_v = event_ms(torch, lambda: rc.vpass_plain(hp, DEMO_SIZE), 2)

    from spriteworld_torch.ops import resample

    # The library call: the XLA v-pass of the JAX package
    # (rasterize_pallas.py:1484-1491) as one float32 einsum, TF32 off, on
    # its float32 h-pass [B, 3, hc, w], then its rounding.
    kh = torch.tensor(resample.pil_lanczos_matrix(hc, DEMO_SIZE),
                      device=hp.device)
    hp_f32 = hp.permute(0, 3, 1, 2).float().contiguous()

    def library_v():
        out = torch.einsum("oh,bchw->bcow", kh, hp_f32)
        return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib_v = event_ms(torch, library_v, 5)
        lib_img = library_v().flip(2).permute(0, 2, 3, 1).to(torch.uint8)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err_lib, count_lib = compare(lib_img, img)
    print(f"strip_vpass's library call (float32 einsum + round) at the demo "
          f"path's inputs: {lib_v:.4f} ms; against strip_vpass max |diff| "
          f"{err_lib}, {count_lib} of {img.numel()} values differ")
    del hp_f32

    # Taps: the tensor-core fragments and window starts of each pass.
    tiles = rc.lanczos_tiles(hc, DEMO_SIZE)
    taps_bytes = tiles.frags.nbytes + tiles.kstart.nbytes
    hp_bytes = hp.numel()
    f_ops = fill_ops(tables)
    f_ops_tc = compacted_fill_ops(torch, tables)
    h_ops = lanczos_ops(resample, hc, DEMO_SIZE, b, hc)
    v_ops = lanczos_ops(resample, hc, DEMO_SIZE, b, DEMO_SIZE)
    one_slot, units = uniform_units(torch, tables, DEMO_SIZE)
    bh = bounds(table_bytes(tables) + taps_bytes, hp_bytes, f_ops + h_ops,
                f_ops_tc, h_ops * (1 - one_slot / units))
    bv = bounds(hp_bytes + taps_bytes, img.numel(), v_ops, 0, v_ops)
    print(f"strip_raster bound: {f_ops:.0f} fill ({f_ops_tc:.0f} compacted) "
          f"+ {h_ops} h-pass operations ({one_slot} of {units} units one "
          f"slot), {hp_bytes} bytes out -> "
          f"{bh['bound_ms']:.6f} ms ({bh['bound_by']}), "
          f"{bh['bound_tc_ms']:.6f} ms ({bh['bound_tc_by']}) with the "
          f"compacted fill and the h-pass on the int8 tensor cores; "
          f"strip_vpass bound: {v_ops} "
          f"operations, {hp_bytes + img.numel()} bytes -> "
          f"{bv['bound_ms']:.6f} ms ({bv['bound_by']}), "
          f"{bv['bound_tc_ms']:.6f} ms ({bv['bound_tc_by']}) on the tensor "
          "cores")
    source = "spriteworld_torch/csrc/strip_raster.cu"
    return [{
        "name": "strip_raster", "route": "cuda", "source": source,
        "replaces": "spriteworld_tpu/ops/rasterize_pallas.py:761",
        "launches": None, "max_abs_err": err_h, "ms": ms_h,
        "device_ms": dev_h, "graph_ms": graph_h, "plain_ms": plain_h, **bh,
        # No single PyTorch call computes Pillow's fill and Lanczos.
        "library_ms": None,
    }, {
        "name": "strip_vpass", "route": "cuda", "source": source,
        "replaces": "spriteworld_tpu/ops/rasterize_pallas.py:1484",
        "launches": None, "max_abs_err": err_v, "ms": ms_v,
        "device_ms": dev_v, "graph_ms": graph_v, "plain_ms": plain_v, **bv,
        # One float32 einsum, as XLA computes this pass for the JAX
        # package; it misses Pillow's fixed-point rounding where printed.
        "library_ms": lib_v, "library_differing": count_lib,
    }]


def scene_tables_work(factors, tab):
    """(bytes read, bytes written, float32 operations) of the scene tables
    of `factors` [B, K, 10]: the factors read once, the table written once
    (the vertex bank, 3 kB, stays in cache); a vertex's rotation, scale
    and crossings ~40 operations, its float64 sine and cosine counted as
    ~40 more."""
    b, k, _ = factors.shape
    v = (tab.shape[-1] - 8) // 11
    return (factors.numel() * 4 + b * 4, tab.numel() * 4, 80.0 * b * k * v)


def ptxas_lines(_build, name, function=None):
    """(registers, spill bytes) of kernel library `name` from its build log
    (ptxas -v), of its entry function whose name holds `function` where
    given (else its last), (None, None) where the log has none."""
    import re

    log = _build.library_path(name).with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    if function is not None:
        text = next((part for part in text.split("Compiling entry function")
                     [1:] if function in part.partition("\n")[0]), "")
    regs = re.findall(r"Used (\d+) registers", text)
    spill = re.findall(r"(\d+) bytes spill stores", text)
    return ((int(regs[-1]) if regs else None),
            (int(spill[-1]) if spill else None))


def time_scene_tables(torch, rasterize_cuda, colors, state, card):
    """Phase 8, scene_tables: the main path's tables (image64/AA=5, B=2048,
    exact fill, HSV) from the kernel against the plain twin on the card
    and on the CPU (held equal), every fill and colour route held equal
    too; the kernel's time (`ms`, `device_ms`, `graph_ms`) beside the
    twin's eager and in a graph (`plain_graph_ms`: the ~230 kernels the
    render node ran before the kernel), at one lane too (`one_lane`), and
    the bound. Returns its `kernels` entry (`launches` filled in by the
    caller)."""
    from spriteworld_torch.ops import _build

    rc = rasterize_cuda
    f, n = state.factors, state.num_sprites
    hc = 64 * 5
    routes = {"none": None, "hsv": colors.hsv_to_rgb,
              "given": lambda c: 255.0 * c.flip(-1)}
    worst = 0
    for exact in (True, False):
        for route, cmap in routes.items():
            got = rc.scene_tables(f, n, hc, hc, cmap, exact).tab
            want = rc.prepare_plain(f, n, hc, hc, cmap, exact).tab
            host = rc.prepare_plain(f.cpu(), n.cpu(), hc, hc, cmap,
                                    exact).tab
            differ = int((got != want).sum())
            differ_cpu = int((got.cpu() != host).sum())
            worst = max(worst, differ, differ_cpu)
            print(f"scene_tables vs plain, {rc.tables_mode(exact, cmap)}, "
                  f"B={f.shape[0]}, K={f.shape[1]}: {differ} values differ "
                  f"from the twin on the card, {differ_cpu} from the CPU "
                  "twin")
    check(worst == 0, "scene_tables differs from its plain twin")

    def kernel():
        rc.scene_tables(f, n, hc, hc, colors.hsv_to_rgb)

    def plain():
        rc.prepare_plain(f, n, hc, hc, colors.hsv_to_rgb)

    def one_lane(fn):
        return lambda: fn(f[:1, :2], n[:1], hc, hc, colors.hsv_to_rgb)

    # A single env's step renders one scene (the single cells hold 2
    # sprite slots): the kernel and the twin in a graph at one lane.
    lane = {"device_ms": event_ms(torch, one_lane(rc.scene_tables), 50,
                                  spin=True),
            "graph_ms": graph_ms(torch, one_lane(rc.scene_tables), 20),
            "plain_graph_ms": graph_ms(torch, one_lane(rc.prepare_plain),
                                       5)}
    tab = rc.scene_tables(f, n, hc, hc, colors.hsv_to_rgb).tab
    in_bytes, out_bytes, ops = scene_tables_work(f, tab)
    bound_ms, bound_by = bound(in_bytes, out_bytes, ops)
    regs, spill = ptxas_lines(_build, "scene_tables")
    entry = {
        "name": "scene_tables", "route": "cuda",
        "source": "spriteworld_torch/csrc/scene_tables.cu",
        "replaces": "spriteworld_tpu/ops/rasterize_pallas.py:1083 and :77 "
                    "(XLA's fusion of _prepare and _build_edge_tables; no "
                    "pallas_call)",
        "launches": None, "max_abs_err": worst,
        "ms": event_ms(torch, kernel, 50),
        "device_ms": event_ms(torch, kernel, 50, spin=True),
        "graph_ms": graph_ms(torch, kernel, 20),
        "plain_ms": event_ms(torch, plain, 5),
        "plain_graph_ms": graph_ms(torch, plain, 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_tc_ms": bound_ms, "bound_tc_by": bound_by,
        "library_ms": None, "registers": regs, "spill_bytes": spill,
        "bytes": in_bytes + out_bytes, "one_lane": lane}
    print(f"scene_tables at B={f.shape[0]}, K={f.shape[1]}: kernel "
          f"{entry['ms']:.4f} ms ({entry['device_ms']:.4f} on the device, "
          f"{entry['graph_ms']:.4f} in a graph), plain {entry['plain_ms']:.4f}"
          f" ms ({entry['plain_graph_ms']:.4f} in a graph), bound "
          f"{bound_ms:.6f} ms ({bound_by}, {in_bytes + out_bytes} bytes); "
          f"{regs} registers, {spill} bytes spilled; one lane of 2 "
          f"slots {lane['device_ms']:.4f} ms on the device, "
          f"{lane['graph_ms']:.4f} in a graph (plain "
          f"{lane['plain_graph_ms']:.4f} in a graph); on {card}")
    return entry


def time_kernel(torch, rasterize_cuda, colors, state):
    """Phase 8: scene_raster at the main path's inputs."""
    image_size, aa = (64, 64), 5
    tables = rasterize_cuda.prepare(state.factors, state.num_sprites,
                                    64 * aa, 64 * aa, colors.hsv_to_rgb)
    got = rasterize_cuda.scene_raster(tables, image_size)
    want = rasterize_cuda.render_rgb_batch_plain(tables, image_size)
    err, count = compare(got, want)
    print(f"kernel vs plain at the main path's inputs, B={BATCH}: "
          f"max |diff| {err}, {count} differing values")
    check(count == 0, "scene kernel differs from its plain version")

    ms = event_ms(
        torch, lambda: rasterize_cuda.scene_raster(tables, image_size), 20)
    device_ms = event_ms(
        torch, lambda: rasterize_cuda.scene_raster(tables, image_size), 20,
        True)
    in_graph_ms = graph_ms(
        torch, lambda: rasterize_cuda.scene_raster(tables, image_size), 20)
    plain_ms = event_ms(
        torch,
        lambda: rasterize_cuda.render_rgb_batch_plain(tables, image_size), 2)

    # Least time: each input read once, each output written once, over the
    # memory rate; or the operations these inputs need over the float32
    # rate, whichever is larger.
    from spriteworld_torch.ops import resample

    tiles = rasterize_cuda.lanczos_tiles(64 * aa, 64)
    in_bytes = table_bytes(tables) + 2 * (tiles.frags.nbytes
                                          + tiles.kstart.nbytes)
    out_bytes = BATCH * 64 * 64 * 3
    f_ops = fill_ops(tables)
    f_ops_tc = compacted_fill_ops(torch, tables)
    h_ops = lanczos_ops(resample, 64 * aa, 64, BATCH, 64 * aa)
    v_ops = lanczos_ops(resample, 64 * aa, 64, BATCH, 64)
    one_slot, units = uniform_units(torch, tables, 64)
    bd = bounds(in_bytes, out_bytes, f_ops + h_ops + v_ops, f_ops_tc,
                h_ops * (1 - one_slot / units) + v_ops)
    print(f"scene_raster bound: {in_bytes + out_bytes} bytes, {f_ops:.0f} "
          f"fill ({f_ops_tc:.0f} compacted) + {h_ops} h-pass ({one_slot} "
          f"of {units} units one slot) + {v_ops} v-pass operations -> "
          f"{bd['bound_ms']:.6f} ms ({bd['bound_by']}), "
          f"{bd['bound_tc_ms']:.6f} ms ({bd['bound_tc_by']}) with the "
          "compacted fill and the Lanczos passes on the int8 tensor cores")
    return {
        "name": "scene_raster",
        "route": "cuda",
        "source": "spriteworld_torch/csrc/scene_raster.cu",
        "replaces": "spriteworld_tpu/ops/rasterize_pallas.py:312",
        "launches": None,  # filled in with the main path's count
        "max_abs_err": err,
        "ms": ms,
        "device_ms": device_ms,
        "graph_ms": in_graph_ms,
        "plain_ms": plain_ms,
        **bd,
        "library_ms": None,  # no single PyTorch call rasterizes a scene
    }


def centroid_ops(torch, tables):
    """The centroid fill's operations on these tables: per live sprite and
    row of its bounds, 4 per edge for the straddle test and crossing, and
    per column a compare and an add for each edge that straddles the row."""
    from spriteworld_torch.ops import rasterize_cuda as s

    tab = tables.tab
    v, hc, wc = tables.num_vertices, tables.hc, tables.wc
    rows = torch.arange(hc, dtype=torch.float32, device=tab.device)
    total = 0.0
    for k in range(tab.shape[1]):
        t = tab[:, k]
        y0 = t[:, s.NUM_SCALARS + s.C_Y0 * v:s.NUM_SCALARS + (s.C_Y0 + 1) * v]
        y1 = t[:, s.NUM_SCALARS + s.C_Y1 * v:s.NUM_SCALARS + (s.C_Y1 + 1) * v]
        py = rows[None, :, None] + 0.5
        straddles = ((y0[:, None] > py) != (y1[:, None] > py)).sum(-1)
        inb = ((rows[None] >= t[:, s.T_ROW0, None])
               & (rows[None] <= t[:, s.T_ROW1, None]))  # [B, hc]
        cols = (t[:, s.T_COL1].clamp(max=wc - 1)
                - t[:, s.T_COL0].clamp(min=0) + 1).clamp(min=0)
        per_row = straddles * 2 * cols[:, None] + 4 * t[:, s.T_COUNT, None]
        total += float((per_row * inb * (t[:, s.T_COUNT, None] > 0)).sum())
    return total


def word_box_ops(torch, tables, aa, unit_rows):
    """The box filter's work as the kernels now do it, on centroid or exact
    tables at anti_aliasing `aa`: (operations, one-slot blocks, blocks).
    Per output whose columns meet the column bounds of a sprite on its rows
    (`unit_rows` canvas rows from a multiple of it: the scene kernel's
    aa-row groups, the strip kernel's strips; every output when K > 32),
    2 per 32-bit word of its block (the XOR with its first slot and the
    mask); per block of more than one slot, 6 more a word (a byte permute
    and a __dp4a for each channel). The other outputs are background and
    read nothing."""
    from spriteworld_torch.ops import rasterize_cuda as s

    box = 0.0
    uniform = total = 0
    chunks = zip(s._plain_chunks(tables, s._PLAIN_PIXELS),
                 slot_canvas(torch, tables))
    for (_, sub), slots in chunks:
        tab = sub.tab
        b, k, _ = tab.shape
        hc, wc = sub.hc, sub.wc
        dev = tab.device
        live = tab[..., s.T_COUNT] > 0  # [b, K]
        pitch = s._round16(wc)
        canvas = torch.zeros((b, hc, pitch), dtype=torch.uint8, device=dev)
        canvas[..., :wc] = slots
        colors = torch.cat([torch.zeros((b, 1), device=dev),
                            tab[..., s.T_COLOR]], -1).to(torch.int64)
        h, w = hc // aa, wc // aa
        _, one_slot = s.box_words(canvas, colors, aa, w)
        x = torch.arange(w, device=dev)
        nw = (((x * aa) & 3) + aa + 3) >> 2  # [w]
        y = torch.arange(h, device=dev)
        lo = (y * aa) // unit_rows * unit_rows
        hi = (lo + unit_rows).clamp(max=hc) - 1
        on = (live[:, None] & (tab[:, None, :, s.T_ROW0] <= hi[None, :, None])
              & (tab[:, None, :, s.T_ROW1] >= lo[None, :, None]))  # [b,h,K]
        cols = ((tab[..., s.T_COL0, None] <= (x * aa + aa - 1))
                & (tab[..., s.T_COL1, None] >= x * aa))  # [b, K, w]
        met = (on[..., None] & cols[:, None]).any(2)  # [b, h, w]
        if k > 32:
            met = torch.ones_like(met)
        box += float((met * aa * nw * 2).sum()
                     + (met & ~one_slot).mul(aa * nw * 6).sum())
        uniform += int(one_slot.sum())
        total += one_slot.numel()
    return box, uniform, total


def time_modes(torch, rasterize_cuda, colors, workloads):
    """Phase 8, the kernels of this slice's modes at their paths' inputs:
    packed_raster at image64/AA=1 (B=2048) in both fills, each beside the
    scene kernel on the same tables, the scene kernel in centroid+box at
    image64/AA=5 (B=2048), the strip kernel in centroid+box at demo256
    (B=256). Returns their `kernels` entries, each with its resident blocks
    an SM; the two centroid+box ones also carry their share of one-slot box
    blocks."""
    rc = rasterize_cuda
    entries = []

    def entry(name, replaces, source, key, state, image_size, aa, pil_exact,
              run, reps, plain_reps, extra_ops, box_rows=None,
              blocks_of=None):
        h, w = image_size
        tables = rc.prepare(state.factors, state.num_sprites, h * aa, w * aa,
                            colors.hsv_to_rgb, pil_exact)
        got = run(tables)
        want = rc.render_rgb_batch_plain(tables, image_size)
        err, count = compare(got, want)
        b = tables.tab.shape[0]
        print(f"{name} vs plain at its path's inputs, B={b}: max |diff| "
              f"{err}, {count} differing values")
        check(count == 0, f"{name} differs from the plain version")
        ms = event_ms(torch, lambda: run(tables), reps)
        device_ms = event_ms(torch, lambda: run(tables), reps, True)
        in_graph_ms = graph_ms(torch, lambda: run(tables), reps)
        plain_ms = event_ms(
            torch, lambda: rc.render_rgb_batch_plain(tables, image_size),
            plain_reps)
        if pil_exact:
            f_ops = fill_ops(tables)
        else:
            f_ops = centroid_ops(torch, tables)
        in_bytes = table_bytes(tables)
        bound_ms, bound_by = bound(in_bytes, got.numel(),
                                   f_ops + extra_ops(b))
        extra = {"blocks_per_sm": blocks_of(tables)}
        # The centroid count is the compacted one already.
        tc_ops = compacted_fill_ops(torch, tables) if pil_exact else f_ops
        if box_rows is None:  # no downsample
            print(f"{name} bound: {in_bytes + got.numel()} bytes, "
                  f"{f_ops:.0f} fill ({tc_ops:.0f} compacted) operations; "
                  f"{extra['blocks_per_sm']} resident blocks an SM")
        else:  # the compacted fill and the word box, as the kernels do them
            box_w, one_slot, blocks = word_box_ops(torch, tables, aa,
                                                   box_rows)
            tc_ops += box_w
            extra["one_slot_blocks"] = [one_slot, blocks, one_slot / blocks]
            print(f"{name} bound: {in_bytes + got.numel()} bytes, "
                  f"{f_ops:.0f} fill + {extra_ops(b)} box operations at "
                  f"every pixel, {box_w:.0f} as the word box does them "
                  f"({one_slot} of {blocks} box blocks one slot); "
                  f"{extra['blocks_per_sm']} resident blocks an SM")
        tc_ms, tc_by = bound(in_bytes, got.numel(), tc_ops)
        print(f"{name} bounds: {bound_ms:.6f} ms ({bound_by}), "
              f"{tc_ms:.6f} ms ({tc_by}) as the kernel does the work")
        label, kernel, mode = key
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": workloads[label][2][kernel].get(mode, 0),
            "max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "graph_ms": in_graph_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # No Lanczos pass: the fill and box counts change.
            "bound_tc_ms": tc_ms, "bound_tc_by": tc_by,
            # No single PyTorch call fills and filters a scene.
            "library_ms": None, **extra,
        })
        return tables

    scene_lib = rc._scene_launcher()[0]
    strip_lib = rc._strip_launchers()[0]
    packed_lib = rc._packed_launcher()[0]

    def packed_blocks(t):
        rows = rc.default_tile_rows(64)
        return packed_lib.packed_raster_blocks_per_sm(
            rc.packed_smem_bytes(t.tab.shape[1], t.num_vertices, rows), rows)

    for label, pil_exact, name in (
            ("image64 AA=1", True, "packed_raster"),
            ("image64 AA=1 fast", False,
             "packed_raster[centroid+identity]")):
        tables = entry(
            name, "spriteworld_tpu/ops/rasterize_pallas.py:761",
            "spriteworld_torch/csrc/packed_raster.cu",
            (label, "packed_raster", rc.mode_name(pil_exact,
                                                  rc.DS_IDENTITY)),
            workloads[label][1], (64, 64), 1, pil_exact,
            lambda t: rc.packed_raster(t, (64, 64)), 200, 2, lambda b: 0,
            blocks_of=packed_blocks)
        scene_ms = [event_ms(torch,
                             lambda: rc.scene_raster(tables, (64, 64)), 50,
                             spin) for spin in (False, True)]
        print(f"scene_raster at image64/AA=1 on the same tables "
              f"({entries[-1]['name']}), B={BATCH}: {scene_ms[0]:.4f} ms, "
              f"device {scene_ms[1]:.4f} ms (packed_raster "
              f"{entries[-1]['ms']:.4f} ms, device "
              f"{entries[-1]['device_ms']:.4f} ms)")

    def scene_blocks(t):
        return scene_lib.scene_raster_blocks_per_sm(
            rc.scene_smem_bytes(t.tab.shape[1], t.num_vertices, t.hc, t.wc,
                                64, 64, rc.DS_BOX), 0)

    entry("scene_raster[centroid+box]",
          "spriteworld_tpu/ops/rasterize_pallas.py:312",
          "spriteworld_torch/csrc/scene_raster.cu",
          ("image64 AA=5 fast", "scene_raster", "centroid+box"),
          workloads["image64 AA=5 fast"][1], (64, 64), 5, False,
          lambda t: rc.scene_raster(t, (64, 64)), 20, 2,
          lambda b: b * 64 * 64 * 3 * 25, box_rows=5, blocks_of=scene_blocks)
    hc = DEMO_SIZE * DEMO_AA
    rows = rc.default_strip_rows(hc, rc._round16(hc), DEMO_AA)

    def strip_blocks(t):
        return strip_lib.strip_raster_blocks_per_sm(
            rc.strip_smem_bytes(t.tab.shape[1], rows, t.wc), 0)

    entry("strip_raster[centroid+box]",
          "spriteworld_tpu/ops/rasterize_pallas.py:761",
          "spriteworld_torch/csrc/strip_raster.cu",
          ("demo256 fast", "strip_raster", "centroid+box"),
          workloads["demo256 fast"][1], (DEMO_SIZE, DEMO_SIZE), DEMO_AA,
          False, lambda t: rc.strip_raster(t, (DEMO_SIZE, DEMO_SIZE)), 10, 1,
          lambda b: b * DEMO_SIZE * DEMO_SIZE * 3 * DEMO_AA * DEMO_AA,
          box_rows=rows, blocks_of=strip_blocks)
    return entries


# Phase 8, the split: (fill, downsample) modes of each Lanczos kernel. The
# difference exact+lanczos - exact+box is the Lanczos passes' cost, exact+box
# - centroid+box mostly the exact fill's.
SPLIT_MODES = (("exact+lanczos", True, "lanczos"), ("exact+box", True, "box"),
               ("centroid+box", False, "box"))


def path_states(torch, bench_torch, steps=2, demo=True):
    """(image64 AA=5 state over BATCH lanes, demo256 state over DEMO_BATCH
    lanes unless not `demo`), each after a reset and `steps` eager steps:
    the scenes the kernels render on their paths (packed_raster's image64
    scenes at AA=1 are the same). Only `Environment.reset_batch`,
    `step_batch` and `sample_action`, which every tree of the port has
    (`random_actions`)."""
    envs = [(bench_torch.build_env(anti_aliasing=5, device="cuda", seed=1),
             BATCH)]
    if demo:
        envs.append((bench_torch.build_demo_env(
            anti_aliasing=DEMO_AA, render_size=DEMO_SIZE, device="cuda",
            seed=1), DEMO_BATCH))
    out = []
    for env, lanes in envs:
        state, _ = env.reset_batch(lanes)
        for t in range(steps):
            state, _ = env.step_batch(state, random_actions(env, lanes, t))
        out.append(state)
    torch.cuda.synchronize()
    return out


def random_actions(env, lanes, seed):
    """`lanes` random actions of `env`: from the lane keys of `seed` where
    the tree's actions draw from keys, else from the env's generator (a
    tree before per-lane keys)."""
    if hasattr(env, "lane_keys"):
        return env.sample_action(lane_keys(seed, lanes, env.device))
    return env.sample_action(lanes)


def time_split(torch, rasterize_cuda, colors, scene_state, demo_state):
    """Phase 8: scene_raster at image64/AA=5 (B=2048) and strip_raster +
    strip_vpass at demo256 (B=256), each in the three SPLIT_MODES on its
    path's scenes (a kernel whose state is None is left out). Returns
    {kernel: {mode: ms}}."""
    rc = rasterize_cuda
    runs = (
        ("scene_raster", scene_state, (64, 64), 5, 20,
         lambda t, ds: rc.scene_raster(t, (64, 64), None, ds)),
        ("strip_raster+strip_vpass", demo_state, (DEMO_SIZE, DEMO_SIZE),
         DEMO_AA, 5,
         lambda t, ds: rc.render_strips(t, (DEMO_SIZE, DEMO_SIZE), None,
                                        None, ds)),
    )
    split = {}
    for kernel, state, (h, w), aa, reps, run in runs:
        if state is None:
            continue
        split[kernel] = {}
        for mode, pil_exact, ds in SPLIT_MODES:
            tables = rc.prepare(state.factors, state.num_sprites, h * aa,
                                w * aa, colors.hsv_to_rgb, pil_exact)
            split[kernel][mode] = event_ms(torch, lambda: run(tables, ds),
                                           reps)
        print(f"{kernel} split, B={state.factors.shape[0]}: "
              + ", ".join(f"{m} {ms:.4f} ms"
                          for m, ms in split[kernel].items()))
    return split


def many_sprites(torch, rasterize_cuda):
    """Phase 3: batches of up to 16 sprites (K + 1 = 17 slots: the h-pass
    resolves slots through the shared colour table, not the registers)
    through the scene kernel and the strip kernels, against the plain
    version. Returns the largest difference."""
    rc = rasterize_cuda
    worst = 0
    for label, seed, b, size, aa, run in (
            ("scene kernel, 64x64/AA=5", 51, 256, (64, 64), 5,
             lambda t: rc.scene_raster(t, (64, 64))),
            ("strip kernels, 128x128/AA=5", 52, 32, (128, 128), 5,
             lambda t: rc.render_strips(t, (128, 128))),
            ("strip kernels, 64x64/AA=5, 13-row strips", 53, 64, (64, 64), 5,
             lambda t: rc.render_strips(t, (64, 64), None, 13))):
        f, n = scene_batch(seed, b, kmax=16)
        n[0] = 16
        t = rc.prepare(torch.from_numpy(f).cuda(), torch.from_numpy(n).cuda(),
                       size[0] * aa, size[1] * aa, None)
        err, count = compare(run(t), rc.render_rgb_batch_plain(t, size))
        print(f"{label}, 16 sprites, B={b}: max |diff| {err}, {count} "
              "differing values")
        check(count == 0, f"{label} with 16 sprites differs from plain")
        worst = max(worst, err)
    return worst


# The scene kernel's live units: image sizes of the edge cases (square,
# and a non-square image at another anti_aliasing).
LIVE_SIZES = (((64, 64), 5), ((32, 48), 3))
# The benchmark's configurations of the scene kernel's cells, the scenes
# that phase 8 renders with and without the live-unit test's help.
RASTER_CONFIGS = ("cobra.goal_finding_new_position", "cobra.sorting",
                 "examples.goal_finding_embodied",
                 "examples.goal_finding_clustering")


def _square_scenes(xs, ys, scale):
    """One axis-aligned square of `scale` a scene at (xs[i], ys[i])."""
    from spriteworld_torch.core import state as state_lib

    f = np.tile(state_lib.DEFAULT_FACTORS, (len(xs), 1, 1)).astype(
        np.float32)
    f[:, 0, state_lib.X] = xs
    f[:, 0, state_lib.Y] = ys
    f[:, 0, state_lib.SCALE] = scale
    f[:, 0, 5:8] = (200, 90, 40)
    return f, np.ones(len(xs), np.int32)


def live_unit_cases(image_size, aa, seed=0):
    """[(name, factors f32[b, K, 10], live counts i32[b])]: scenes at the
    edges of the scene kernel's live-unit test with the Lanczos filter: no
    live sprite; a sprite across each border of the canvas and each
    corner; squares whose bounds end one pixel short of a unit's span of
    Lanczos support, or on its first pixel, in columns and in rows; all 12
    slots live. Plain numpy and the CPU's tables: the CPU tests hold the
    twin's masks on them, the card holds the kernel."""
    from spriteworld_torch.core import state as state_lib
    from spriteworld_torch.ops import rasterize_cuda as rc

    import torch

    h, w = image_size
    rng = np.random.default_rng(seed)
    cases = []
    f, _ = scene_batch(seed, 4, kmax=3)
    cases.append(("no live sprite", f, np.zeros(4, np.int32)))
    edge = np.array([0.0, 1.0, 0.5, 0.5, 0.0, 1.0, 0.0, 1.0])
    other = np.array([0.5, 0.5, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0])
    f, n = _square_scenes(edge, other, 0.2)
    cases.append(("across each border and corner", f, n))
    # Squares swept a quarter canvas pixel at a time across the image;
    # keep those whose bounds stop one pixel before a unit's span or
    # start on its last pixel (either way, one pixel of Lanczos support
    # from meeting it or not).
    sweep = np.arange(0.02, 0.98, 1.0 / (4 * aa * max(h, w)))
    spans = ((rc.lanczos_tiles(w * aa, w).span8, rc.T_COL0, rc.T_COL1, 0),
             (rc.lanczos_tiles(h * aa, h).span8, rc.T_ROW0, rc.T_ROW1, 1))
    for span, lo_f, hi_f, axis in spans:
        middle = np.full(len(sweep), 0.5)
        f, n = _square_scenes(*((middle, sweep) if axis else
                                (sweep, middle)), 0.07)
        t = rc.prepare(torch.from_numpy(f), torch.from_numpy(n), h * aa,
                       w * aa, None).tab[:, 0].numpy()
        a, b = t[:, lo_f], t[:, hi_f]
        short = np.isin(b + 1, span[:, 0]) | np.isin(a, span[:, 1])
        on = np.isin(b, span[:, 0]) | np.isin(a + 1, span[:, 1])
        for label, mask in (("one pixel short of", short),
                            ("one pixel into", on)):
            idx = np.flatnonzero(mask)
            check(len(idx) > 0, f"no square {label} a unit's span "
                                f"({'rows' if axis else 'columns'})")
            pick = idx[np.linspace(0, len(idx) - 1, min(8, len(idx)))
                       .astype(int)]
            cases.append((f"{label} a unit's span in "
                          f"{'rows' if axis else 'columns'}", f[pick],
                          n[pick]))
    f, n = scene_batch(seed + 1, 8, kmax=12)
    f[..., state_lib.SCALE] = rng.uniform(0.03, 0.1, f.shape[:2])
    cases.append(("all 12 slots live", f, np.full(8, 12, np.int32)))
    return cases


def live_units_vs_plain(torch, rasterize_cuda):
    """Phase 3: the scene kernel with the Lanczos filter against its plain
    version on `live_unit_cases` at each of LIVE_SIZES, with a background
    colour, and its count of live v-pass units against the twin's masks
    (`scene_live_units`). Returns the largest difference."""
    rc = rasterize_cuda
    worst = 0
    for size, aa in LIVE_SIZES:
        for name, f, n in live_unit_cases(size, aa):
            t = rc.prepare(torch.from_numpy(f).cuda(),
                           torch.from_numpy(n).cuda(), size[0] * aa,
                           size[1] * aa, None)
            got = rc.scene_raster(t, size, (10, 20, 30))
            err, count = compare(got, rc.render_rgb_batch_plain(
                t, size, (10, 20, 30)))
            _, vmask = rc.scene_live_units(t, size, aa)
            live, units = rc.scene_raster.live_units()
            print(f"live units, {size[0]}x{size[1]}/AA={aa}, {name}, "
                  f"B={len(n)}: max |diff| {err}, {count} differing "
                  f"values; {live} of {units} v-pass units live (twin "
                  f"{int(vmask.sum())})")
            check(count == 0, f"scene kernel differs from plain ({name}, "
                              f"{size}, AA={aa})")
            check((live, units) == (int(vmask.sum()), vmask.numel()),
                  f"the kernel's live units differ from the twin's "
                  f"({name})")
            worst = max(worst, err)
    return worst


def scene_path_tables(torch, colors, lanes=BATCH, steps=2, seed=3,
                      dev="cuda", names=RASTER_CONFIGS):
    """{config: (tables, image size)} of the `names` configs' scenes over
    `lanes` lanes, each after a reset and `steps` eager steps, prepared as
    the config's image renderer prepares them
    (perfbench/configs/<config>.json)."""
    from perfbench import harness
    from spriteworld_torch.core import environment as env_lib
    from spriteworld_torch.ops import rasterize_cuda as rc

    layout = harness.Layout()
    out = {}
    for name in names:
        config = layout.config(name)
        env = env_lib.Environment(**harness.env_kwargs(config),
                                  device=dev, seed=seed)
        state, _ = env.reset_batch(lanes)
        for t in range(steps):
            state, _ = env.step_batch(state, random_actions(env, lanes, t))
        h, w = config["image_size"]
        aa = config["anti_aliasing"]
        cmap = colors.hsv_to_rgb if config["color_to_rgb"] == "hsv" else None
        out[name] = (rc.prepare(state.factors, state.num_sprites, h * aa,
                                w * aa, cmap), (h, w))
    return out


def time_scene_paths(torch, rasterize_cuda, tables, reps=20, checked=True):
    """Phase 8's row 1 beside its main path: scene_raster on each of
    RASTER_CONFIGS' scenes (`scene_path_tables`) at their lanes and at
    B=1 (the first lane), held to the plain version at the lanes (where
    `checked`), timed on
    the device (`event_ms` with the spin), with the live v-pass units of
    the launch where the tree counts them. {config: {"B=<b>": {...}}}."""
    rc = rasterize_cuda
    out = {}
    for name, (t, size) in tables.items():
        if checked:
            _, count = compare(rc.scene_raster(t, size),
                               rc.render_rgb_batch_plain(t, size))
            check(count == 0, f"scene_raster differs from plain on "
                              f"{name}'s scenes")
        row = {}
        for b in (t.tab.shape[0], 1):
            sub = dataclasses.replace(t, tab=t.tab[:b].contiguous())
            ms = event_ms(torch, lambda: rc.scene_raster(sub, size), reps,
                          True)
            counted = getattr(rc.scene_raster, "live_units",
                              lambda: None)()
            row[f"B={b}"] = {"device_ms": ms,
                             "live_units": None if counted is None
                             else list(counted)}
        out[name] = row
        print(f"scene_raster on {name}'s scenes: "
              + ", ".join(f"{k} {v['device_ms']:.4f} ms (live units "
                          f"{v['live_units']})" for k, v in row.items()))
    return out


def float32_trig_vertices(factors):
    """`geometry.centered_vertices` with sine and cosine taken in float32,
    the port's trig before it rounded a float64 sine and cosine once. The
    card and the CPU round these differently; `vertex_trig` measures what
    that moves."""
    import torch

    from spriteworld_torch.core import state as state_lib
    from spriteworld_torch.ops import geometry

    base = geometry.vertex_bank(factors.device)[
        factors[..., state_lib.SHAPE].to(torch.int64)]
    scaled = base * factors[..., state_lib.SCALE][..., None, None]
    rad = factors[..., state_lib.ANGLE] * geometry._DEG2RAD
    c = torch.cos(rad)[..., None]
    s = torch.sin(rad)[..., None]
    vx, vy = scaled[..., 0], scaled[..., 1]
    return torch.stack([c * vx - s * vy, s * vx + c * vy], dim=-1)


def edge_clicks(torch, f, n, seed):
    """Clicks on the CPU's sprite edges: for each lane a sprite below its
    last live one and one of its edges, the edge's float32 midpoint and the
    points one float32 ulp from it along x and along y: f32[5, B, 2]."""
    from spriteworld_torch import constants
    from spriteworld_torch.core import state as state_lib
    from spriteworld_torch.ops import geometry

    rng = np.random.default_rng(seed)
    b = len(f)
    k = (rng.random(b) * (n - 1)).astype(np.int64)  # below the body
    lanes = np.arange(b)
    counts = constants.VERTEX_COUNTS[f[lanes, k, state_lib.SHAPE].astype(int)]
    e = (rng.random(b) * counts).astype(np.int64)
    v = geometry.world_vertices(torch.from_numpy(f)).numpy()[lanes, k]
    mid = ((v[lanes, e] + v[lanes, (e + 1) % counts])
           * np.float32(0.5)).astype(np.float32)
    pts = [mid]
    for axis in (0, 1):
        for to in (np.inf, -np.inf):
            p = mid.copy()
            p[:, axis] = np.nextafter(p[:, axis], np.float32(to))
            pts.append(p)
    return np.stack(pts)


def trig_counts(torch, rasterize_cuda):
    """Card against CPU with `geometry.centered_vertices` as it stands: the
    differing world-vertex values at random angles; the lanes whose
    SelectMove pick or Embodied carry differs on clicks placed on the CPU's
    edges (`edge_clicks`: the sprite at the click, or the body placed there,
    moves on one side and not on the other); the differing values of the
    anti_aliasing=1 renders at 64x64 (packed_raster), 128x128 (the scene
    kernel) and 256x256 (as kernel_mode="auto" decides)."""
    from spriteworld_torch.core import actions
    from spriteworld_torch.core import state as state_lib
    from spriteworld_torch.ops import geometry

    out = {}
    f, n = scene_batch(61, BATCH)
    fc = torch.from_numpy(f)
    v_cpu = geometry.world_vertices(fc)
    out["world_vertices"] = [
        int((geometry.world_vertices(fc.cuda()).cpu() != v_cpu).sum()),
        v_cpu.numel()]
    n = np.maximum(n, 2)
    pts = edge_clicks(torch, f, n, 62)
    lanes = np.arange(BATCH)
    select = actions.SelectMove(scale=0.25)
    embodied = actions.Embodied()
    picks = carries = 0
    for p in pts:
        act = np.concatenate([p, np.full((BATCH, 2), 0.9, np.float32)], -1)
        fb = f.copy()  # the body (the last live sprite) at the click
        fb[lanes, n - 1, state_lib.X] = p[:, 0]
        fb[lanes, n - 1, state_lib.Y] = p[:, 1]
        carry = np.zeros((BATCH, 2), np.int32)
        carry[:, 0] = 1
        res = []
        for dev in ("cuda", "cpu"):
            g = torch.Generator(device=dev)
            nd = torch.from_numpy(n).to(dev)
            moved = select.step(torch.from_numpy(act).to(dev),
                                torch.from_numpy(f).to(dev), nd, False, g)[0]
            carried = embodied.step(torch.from_numpy(carry).to(dev),
                                    torch.from_numpy(fb).to(dev), nd, False,
                                    g)[0]
            res.append((moved.cpu(), carried.cpu()))
        picks += int((res[0][0] != res[1][0]).flatten(1).any(-1).sum())
        carries += int((res[0][1] != res[1][1]).flatten(1).any(-1).sum())
    out["picks"] = [picks, len(pts) * BATCH]
    out["carries"] = [carries, len(pts) * BATCH]
    for size, b in ((64, BATCH), (128, BATCH // 4), (256, BATCH // 16)):
        fs, ns = torch.from_numpy(f[:b]), torch.from_numpy(n[:b])
        kw = dict(image_size=(size, size), anti_aliasing=1)
        _, count = compare(
            rasterize_cuda.render_rgb_batch(fs.cuda(), ns.cuda(), **kw),
            rasterize_cuda.render_rgb_batch(fs, ns, **kw))
        out[f"pixels {size}x{size}"] = [count, b * size * size * 3]
    return out


def vertex_trig(torch, rasterize_cuda):
    """Phase 3: the card's vertices against the CPU's (`trig_counts`), with
    float32 sine and cosine (`float32_trig_vertices`: printed) and with the
    port's float64 ones rounded once (checked: nothing may differ).
    Returns the two count dicts."""
    from spriteworld_torch.ops import geometry

    tree = geometry.centered_vertices
    geometry.centered_vertices = float32_trig_vertices
    try:
        before = trig_counts(torch, rasterize_cuda)
    finally:
        geometry.centered_vertices = tree
    after = trig_counts(torch, rasterize_cuda)
    for key in after:
        print(f"vertex trig, card vs CPU, {key}: {after[key][0]} of "
              f"{after[key][1]} differ ({before[key][0]} with float32 trig)")
        check(after[key][0] == 0, f"card and CPU differ in {key}")
    return before, after


def imma_counts(_build):
    """{library: {kernel function: IMMA instructions}} from `cuobjdump
    -sass` of the built libraries, or None where the toolkit has no
    cuobjdump."""
    import os
    import re
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    counts = {}
    for name in _build.KERNELS:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True).stdout
        per = {}
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                per[fn] = 0
            elif fn is not None and re.search(r"\bIMMA\b", line):
                per[fn] += 1
        counts[name] = per
    return counts


def time_packed(torch, rasterize_cuda, colors, state, reps=200):
    """packed_raster at image64/AA=1 on `state`'s scenes in both fills,
    each checked against the plain version first: {mode: {"ms": ...,
    "device_ms": ...}} (`event_ms` without and with the spin)."""
    rc = rasterize_cuda
    out = {}
    for pil_exact in (True, False):
        tables = rc.prepare(state.factors, state.num_sprites, 64, 64,
                            colors.hsv_to_rgb, pil_exact)
        mode = rc.mode_name(pil_exact, rc.DS_IDENTITY)
        _, count = compare(rc.packed_raster(tables, (64, 64)),
                           rc.render_rgb_batch_plain(tables, (64, 64)))
        check(count == 0, f"packed_raster differs from plain ({mode})")
        out[mode] = {
            key: event_ms(torch, lambda: rc.packed_raster(tables, (64, 64)),
                          reps, spin)
            for key, spin in (("ms", False), ("device_ms", True))}
    return out


def fresh_scenes(tree=".", reps=10):
    """Device ms of fresh scenes for every lane of each RUNNER_PATHS path
    (`Environment.initial_state`, as every step samples them), in a CUDA
    graph of `reps` calls, for the tree at `tree` (this one, or an older
    one unpacked with `git archive`; its package is imported from there):
    from lane keys where its scenes draw from keys, else from the env's
    generator, which the graph then registers. Prints one JSON line. Run
    one tree a process: python3 -c 'import chip_smoke as c;
    c.fresh_scenes("archive/parent")'."""
    import os

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import bench_torch

    card = bench_torch.card_name_and_power_limit()
    out = {}
    for label, name, aa, lanes, _ in RUNNER_PATHS:
        env, _, _ = bench_torch.build(name, aa, True, device="cuda", seed=0)
        if hasattr(env, "lane_keys"):
            keys = lane_keys(3, lanes, env.device)

            def fresh():
                env.initial_state(keys)
            generator = None
        else:
            def fresh():
                env.initial_state(lanes)
            generator = env.generator
        fresh()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fresh()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out[label] = start.elapsed_time(end) / reps
    print(json.dumps({"fresh_scene_ms": out, "tree": tree, "card": card}))


def packed_only():
    """packed_raster alone at image64/AA=1 (B=2048) in both fills, on
    freshly built kernels:
    python3 -c 'import chip_smoke; chip_smoke.packed_only()'. It calls
    only rasterize_cuda.prepare, packed_raster and render_rgb_batch_plain,
    so it can time an older tree too."""
    import torch

    import bench_torch
    from spriteworld_torch.ops import _build
    from spriteworld_torch.ops import rasterize_cuda
    from spriteworld_torch.utils import colors

    check(torch.cuda.is_available(), "no CUDA device")
    card = bench_torch.card_name_and_power_limit()
    print(card)
    _build.build_all()
    state, = path_states(torch, bench_torch, demo=False)
    times = time_packed(torch, rasterize_cuda, colors, state)
    print(json.dumps({"packed": times, "card": card}))


def split_only():
    """The phase-8 split alone, on freshly built kernels:
    python3 -c 'import chip_smoke; chip_smoke.split_only()'."""
    import torch

    import bench_torch
    from spriteworld_torch.ops import _build
    from spriteworld_torch.ops import rasterize_cuda
    from spriteworld_torch.utils import colors

    check(torch.cuda.is_available(), "no CUDA device")
    card = bench_torch.card_name_and_power_limit()
    print(card)
    _build.build_all()
    scene_state, demo_state = path_states(torch, bench_torch)
    split = time_split(torch, rasterize_cuda, colors, scene_state,
                       demo_state)
    print(json.dumps({"split": split, "card": card}))


def scene_only():
    """The scene kernel alone, on freshly built kernels: the layouts, every
    phase-3 check of the scene kernel (the live-unit cases too), and its
    device time and live units on RASTER_CONFIGS' scenes:
    python3 -c 'import chip_smoke; chip_smoke.scene_only()'."""
    import torch

    import bench_torch
    from spriteworld_torch.ops import _build
    from spriteworld_torch.ops import rasterize_cuda
    from spriteworld_torch.utils import colors

    check(torch.cuda.is_available(), "no CUDA device")
    card = bench_torch.card_name_and_power_limit()
    print(card)
    logs = _build.build_all()
    for line in logs.get("scene_raster", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  scene_raster: {line.strip()}")
    check_layouts(rasterize_cuda)
    kernel_vs_plain(torch, rasterize_cuda, colors)
    live_units_vs_plain(torch, rasterize_cuda)
    many_sprites(torch, rasterize_cuda)
    paths = time_scene_paths(torch, rasterize_cuda,
                             scene_path_tables(torch, colors))
    print(json.dumps({"scene_paths": paths, "card": card}))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    import bench_torch
    from spriteworld_torch.core import environment as env_lib
    from spriteworld_torch.ops import _build
    from spriteworld_torch.ops import rasterize_cuda
    from spriteworld_torch.ops import task_eval
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
    check_layouts(rasterize_cuda)

    worst = kernel_vs_plain(torch, rasterize_cuda, colors)
    worst_strip, worst_v = strips_vs_plain(torch, rasterize_cuda, colors)
    worst_modes = modes_vs_plain(torch, rasterize_cuda, colors)
    worst_cases = check_cases(torch, rasterize_cuda)
    worst_many = many_sprites(torch, rasterize_cuda)
    worst_many = max(worst_many, live_units_vs_plain(torch, rasterize_cuda))
    vertex_trig(torch, rasterize_cuda)
    imma = imma_counts(_build)
    print("IMMA instructions by kernel function (cuobjdump -sass): "
          + ("not measured (no cuobjdump)" if imma is None
             else json.dumps(imma)))

    task_eval.reset_launch_counts()
    (steps_per_sec, state, scene_launches, draws, scenes,
     trees) = drive_main_path(torch, bench_torch, env_lib, rasterize_cuda)
    task_launches = task_eval.task_eval.launches
    print(f"task_eval launches {task_launches} "
          f"{json.dumps(task_eval.task_eval.by_site)}")
    check(task_launches > 0, "no task evaluation went through the "
          "task_eval kernel")
    table_launches = rasterize_cuda.scene_tables.launches
    print(f"env_steps_per_sec {steps_per_sec:.1f} (image64, AA=5, "
          f"{BATCH} lanes) on {card}")
    demo_rate, demo_state, demo_launches = drive_demo_path(
        torch, bench_torch, env_lib, rasterize_cuda)
    print(f"env_steps_per_sec {demo_rate:.1f} (demo256 clustering, "
          f"AA={DEMO_AA}, {DEMO_BATCH} lanes) on {card}")

    workloads = drive_workloads(torch, bench_torch, env_lib, rasterize_cuda,
                                card)
    runner_rates = drive_runner(torch, bench_torch, env_lib, rasterize_cuda,
                                card)
    print(json.dumps({"runner_env_steps_per_sec": {
        label: {"graph": g, "eager": e}
        for label, (g, e) in runner_rates.items()}, "card": card}))
    worst_single, graph_launches = single_env(
        torch, bench_torch, rasterize_cuda, colors, card)
    trainer_launches = trainer_mesh_sweep(torch, bench_torch, rasterize_cuda,
                                          card)
    contract_launches, worst_contract = renderer_contract(
        torch, bench_torch, rasterize_cuda, card)
    worst_keys = lane_keys_phase(torch, bench_torch, env_lib, card)

    split = time_split(torch, rasterize_cuda, colors, state, demo_state)
    print(json.dumps({"split": split}))
    entry = time_kernel(torch, rasterize_cuda, colors, state)
    entry["paths"] = time_scene_paths(torch, rasterize_cuda,
                                      scene_path_tables(torch, colors))
    entry["launches"] = scene_launches
    entry["max_abs_err"] = max(entry["max_abs_err"], worst, worst_many)
    strip_entries = time_strips(torch, rasterize_cuda, colors, demo_state)
    for e, err in zip(strip_entries, (worst_strip, worst_v)):
        e["launches"] = demo_launches[e["name"]]
        e["max_abs_err"] = max(e["max_abs_err"], err, worst_many)
    mode_entries = time_modes(torch, rasterize_cuda, colors, workloads)
    for e in mode_entries:
        kernel, _, mode = e["name"].rstrip("]").partition("[")
        mode = mode or "exact+identity"
        if kernel == "packed_raster":  # the trainer's image path (phase 10)
            e["launches"] += trainer_launches.get(mode, 0)
        e["max_abs_err"] = max(e["max_abs_err"], worst_cases,
                               worst_modes.get((kernel, mode), 0))
    entries = [entry] + strip_entries + mode_entries
    for e in entries:
        kernel, _, mode = e["name"].rstrip("]").partition("[")
        mode = mode or DEFAULT_MODES[kernel]
        # The single env's graph paths (phase 9.6): warm-up and capture;
        # the renderer contract's renders and steps (phase 11).
        e["launches"] += graph_launches.get(kernel, {}).get(mode, 0)
        e["launches"] += contract_launches.get(kernel, {}).get(mode, 0)
        e["max_abs_err"] = max(e["max_abs_err"], worst_single,
                               worst_contract)
        print(f"{e['name']}: kernel {e['ms']:.4f} ms ({e['graph_ms']:.4f} "
              f"ms in a graph), plain "
              f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.6f} ms "
              f"({e['bound_by']}), tensor-core bound "
              f"{e['bound_tc_ms']:.6f} ms ({e['bound_tc_by']}), "
              f"{e['launches']} launches on its path, on {card}")
    lane_entry = time_lane_random(torch, bench_torch, env_lib, card, draws,
                                  WARMUP_STEPS + CHUNKS * STEPS)
    lane_entry["max_abs_err"] = max(lane_entry["max_abs_err"], worst_keys)
    entries.append(lane_entry)
    entries.append(time_lane_random_scene(
        torch, card, scenes, WARMUP_STEPS + CHUNKS * STEPS))
    entries.append(time_lane_random_tree(
        torch, card, trees, scenes, WARMUP_STEPS + CHUNKS * STEPS))
    tables_entry = time_scene_tables(torch, rasterize_cuda, colors, state,
                                     card)
    tables_entry["launches"] = table_launches
    entries.append(tables_entry)
    entries.append(time_task_eval(torch, card, task_launches,
                                  WARMUP_STEPS + CHUNKS * STEPS))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
