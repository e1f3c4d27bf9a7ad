"""Times the raster kernels with one of their fast paths, or one phase,
taken out.

Each variant is a copy of spriteworld_torch whose CUDA sources differ from
the tree's by textual edits. A variant runs only the kernels whose sources
it edits (an edited header reaches all three; the base run takes the
kernels of every chosen variant). VARIANTS take one fast path out each, so
their output stays bit-exact: every such copy builds its kernels anew and,
in its own process, checks its kernels against the plain version on the
paths' scenes (scene_raster at image64/AA=5, B=2048 and the strip kernels
at demo256, B=256, in exact+lanczos and centroid+box; packed_raster at
image64/AA=1, B=2048, in both fills) and on seeded batches of more sprites
(8 for the scene and strip kernels, K + 1 = 9 slots; 16 for
packed_raster), then times them: chip_smoke.time_split on the paths'
scenes (exact+lanczos, exact+box and centroid+box), packed_raster in both
fills (queued behind a spin of the card: chip_smoke.event_ms's
`device_ms`), and the larger batches. SPLIT cuts one phase of the fill-only
(identity and box) instantiations of the scene and strip kernels, or of
packed_raster, so its copies are timed on the paths' scenes and not
checked. The runs go base, the variants, the variants in reverse, base, so
that drift across the call shows. The base run also prints, on each
Lanczos path's scenes, the share of h-pass units (16 outputs by 8 canvas
rows) whose window holds one slot and the share of box blocks (aa x aa
canvas pixels) that do.

Usage: python3 ablate_kernels.py [--out PATH] [--only NAME,NAME...]
(default spriteworld_torch/build/ablation.json, every variant)
(needs one CUDA card)

`chunk_graphs()` times the runner's graph of one step, replayed per step of
a chunk, against one graph of the whole chunk:
python3 -c 'import ablate_kernels; ablate_kernels.chunk_graphs()'.
`eager_steps()` times the eager environment step of this tree or of an
older one, driven the same way (see its docstring).
"""

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

_GROUPS = """\
    for (int y = warp; y < h; y += kWarps) {
      uint8_t* group = canvas + size_t(aa == 1 ? y : warp * aa) * cp;
      const unsigned on =
          sprites_on_rows(s_tab, K, NT, y * aa, y * aa + aa - 1, lane);
      if (on != 0u) {  // else the row is background: no canvas is read
        zero(group, size_t(aa) * cp, lane, 32);
        __syncwarp();
        fill_rows(s_tab, K, V, NT, y * aa, aa, wc, centroid, group, cp, wx,
                  ww, 0, 1, lane);
        __syncwarp();
      }
      uint8_t* orow = img + size_t(h - 1 - y) * w * 3;
"""
_BANDS = """\
    for (int row0 = 0; row0 < hc; row0 += kWarps * aa) {
      const int rows = min(kWarps * aa, hc - row0);
      zero(canvas, size_t(rows) * cp, tid, kThreads);
      __syncthreads();
      fill_rows(s_tab, K, V, NT, row0, rows, wc, centroid, canvas, cp, wx,
                ww, warp, kWarps, lane);
      __syncthreads();
      for (int y = row0 / aa + warp; y < (row0 + rows) / aa; y += kWarps) {
      const uint8_t* group = canvas + size_t(y * aa - row0) * cp;
      const unsigned on =
          sprites_on_rows(s_tab, K, NT, y * aa, y * aa + aa - 1, lane);
      uint8_t* orow = img + size_t(h - 1 - y) * w * 3;
"""


# Fast paths: (name, [(file under csrc, text, replacement, occurrences)]).
# Each variant takes one fast path out; its output stays bit-exact, and
# the run checks it against the plain version.
VARIANTS = [
    ("route16", [("lanczos_mma.cuh",
      "return K + 1 <= 8 ? kRoute8 : (K + 1 <= 16 ? kRoute16 : kRouteTable);",
      "return K + 1 <= 16 ? kRoute16 : kRouteTable;", 1)]),
    ("table_route", [("lanczos_mma.cuh",
      "return K + 1 <= 8 ? kRoute8 : (K + 1 <= 16 ? kRoute16 : kRouteTable);",
      "return kRouteTable;", 1)]),
    ("shared_crossings", [("raster_fill.cuh", "if (n <= kRegCrossings) {",
                           "if (false) {", 2)]),
    ("no_uniform_skip", [("lanczos_mma.cuh", "if (__all_sync(kFull, same)) {",
                          "if (false && __all_sync(kFull, same)) {", 1)]),
    # The box filter sums every block, one-slot blocks too.
    ("no_one_slot_box", [
        ("raster_fill.cuh", "rest = __ballot_sync(kFull, diff != 0u);",
         "rest = __ballot_sync(kFull, active);", 1),
        ("raster_fill.cuh", "if (diff == 0u) {", "if (false) {", 1)]),
    # Every output reads the canvas, every row is zeroed and filled, also
    # where no sprite's bounds reach.
    ("no_bounds_skip", [
        ("raster_fill.cuh", "  if (on == kFull) return true;",
         "  if (true) return true;", 1),
        ("scene_raster.cu", "if (on != 0u) {", "if (true) {", 1),
        ("strip_raster.cu", "if (kLanczos || on != 0u)", "if (true)", 1)]),
    # The scene kernel's box mode in bands of 16 output rows, zeroed,
    # filled and filtered by the whole block between barriers, not each
    # warp rendering its own output rows.
    ("block_bands", [
        ("scene_raster.cu", _GROUPS, _BANDS, 1),
        ("scene_raster.cu",
         "      __syncwarp();  // the group read before it is zeroed again\n"
         "    }\n",
         "      }\n      __syncthreads();  // the band read before it is "
         "zeroed again\n    }\n", 1)]),
    # The strip kernel's box mode without its 64-register cap (three
    # blocks an SM instead of four).
    ("strip_three_blocks", [
        ("strip_raster.cu", "__launch_bounds__(kThreads, kLanczos ? 3 : 4)",
         "__launch_bounds__(kThreads, kLanczos ? 3 : 1)", 1)]),
    # The scene kernel's box mode held to 64 registers (two blocks an SM,
    # no spill) instead of 40 (three blocks).
    ("scene_two_blocks", [("scene_raster.cu", "kLanczos ? 2 : 3)",
                           "kLanczos ? 2 : 2)", 1)]),
    # The box's mixed blocks: the byte-permute route for K + 1 <= 8 in the
    # scene kernel, the shared table for every K in the strip kernel (the
    # other way round from the tree).
    ("scene_box_route8", [
        ("scene_raster.cu",
         "      group_row<kRouteTable>(group, cp, aa, ds, w, s_tab, NT, on, "
         "s_ctab,\n                             chan, kc, orow, lane);",
         "      if (K + 1 <= 8)\n"
         "        group_row<kRoute8>(group, cp, aa, ds, w, s_tab, NT, on, "
         "s_ctab, chan, kc, orow, lane);\n"
         "      else\n"
         "        group_row<kRouteTable>(group, cp, aa, ds, w, s_tab, NT, on, "
         "s_ctab, chan, kc, orow, lane);", 1)]),
    ("strip_box_table", [
        ("strip_raster.cu", "    if (K + 1 <= 8)\n      strip_output<kRoute8>",
         "    if (false)\n      strip_output<kRoute8>", 1)]),
    # packed_raster: every sprite walked by every warp, also where no row of
    # the warp lies in its bounds.
    ("packed_no_sprite_vote", [
        ("packed_raster.cu", "if (!__any_sync(kFull, in)) continue;",
         "if (false) continue;", 1)]),
    # packed_raster: the warp's buffer stored out in bytes, not in 16-byte
    # chunks.
    ("packed_byte_stores", [
        ("packed_raster.cu", "    if (row_bytes % 16 == 0)\n",
         "    if (false)\n", 1)]),
    # packed_raster: each lane stores its own row (16-byte stores 3w bytes
    # apart across the warp), not through the warp's buffer.
    ("packed_direct_out", [
        ("packed_raster.cu",
         "  __syncthreads();\n  uint8_t* buf = ",
         "  if (active)\n"
         "    write_row(slots, w, rgb,\n"
         "              out + (size_t(scene) * h + (h - 1 - r)) * w * 3);\n"
         "  return;\n"
         "  __syncthreads();\n  uint8_t* buf = ", 1)]),
    # packed_raster: every sprite painted into all 16 slot words of a row,
    # also the groups of 16 columns its mask misses.
    ("packed_paint_all", [("packed_raster.cu", "if (bits == 0u) continue;",
                           "if (false) continue;", 1)]),
    # packed_raster: no register cap (the compiler takes 94 registers, and
    # 10 blocks an SM).
    ("packed_no_register_cap", [
        ("packed_raster.cu", "__launch_bounds__(kMaxThreads, kMinBlocks)",
         "__launch_bounds__(kMaxThreads)", 1)]),
    # packed_raster: tiles of at most 32 rows, a warp a block (two blocks a
    # 64x64 scene, each staging its sprites).
    ("packed_warp_tiles", [
        ("packed_raster.cu",
         "    return static_cast<int>(cudaErrorInvalidValue);\n",
         "    return static_cast<int>(cudaErrorInvalidValue);\n"
         "  tile_rows = tile_rows < 32 ? tile_rows : 32;\n", 1)]),
]

# The phase split of the fill-only (identity and box) instantiations of the
# two kernels: each variant cuts one phase out, or runs it twice, so its
# output differs and the run times it without a check. Base minus variant
# (variant minus base for zero_twice) is that phase's time, as far as the
# phases do not overlap. (Zeroing cannot be cut alone: the box's one-slot
# test reads the zeroes.)
_CUT_ZERO = [
    ("scene_raster.cu", "zero(group, size_t(aa) * cp, lane, 32);", "", 1),
    ("strip_raster.cu", "if (kLanczos || on != 0u)", "if (kLanczos)", 1)]
_CUT_FILL = [
    ("scene_raster.cu",
     "fill_rows(s_tab, K, V, NT, y * aa, aa, wc, centroid, group, cp, wx,",
     "if (false) fill_rows(s_tab, K, V, NT, y * aa, aa, wc, centroid, "
     "group, cp, wx,", 1),
    ("strip_raster.cu", "for (int k = 0; k < K; ++k) {",
     "for (int k = 0; k < (kLanczos ? K : 0); ++k) {", 1)]
_CUT_OUTPUT = [
    ("scene_raster.cu", "for (int x0 = 0; x0 < w; x0 += 32) {",
     "for (int x0 = 0; x0 < 0; x0 += 32) {", 1),
    ("strip_raster.cu",
     "for (int u = warp; u < (rows / aa) * xt; u += kWarps) {",
     "for (int u = warp; u < 0; u += kWarps) {", 1)]
# packed_raster's phases at image64/AA=1: the fill (its masks become all
# columns; painting stays), the output (the row's slots are folded to one
# word that decides a store no run makes, so the fill stays live), and
# setup alone (colour table, culling, plan, staging).
_PACKED_CUT_FILL = [
    ("packed_raster.cu",
     "      u64 m = centroid ? centroid_row(head, R, rf)\n"
     "                       : exact_row(head, R, rf, r);",
     "      u64 m = ~0ull;", 1)]
_PACKED_CUT_OUTPUT = [
    ("packed_raster.cu", "  // Each warp writes its rows through its buffer",
     "  {\n"
     "    unsigned x = 0u;\n"
     "    for (int i = 0; i < kWords; ++i) x ^= slots[i];\n"
     "    if (x == 0x9e3779b9u) out[tid] = 1;\n"
     "    return;\n"
     "  }\n"
     "  // Each warp writes its rows through its buffer", 1)]
_PACKED_CUT_SPRITES = [
    ("packed_raster.cu",
     "    for (int i = s_chunk[c]; i < s_chunk[c + 1]; ++i) {",
     "    for (int i = s_chunk[c]; i < 0; ++i) {", 1)]
# The Lanczos instantiation's phases: the fill of the live groups, the
# h-pass of the live units, the v-pass of the live units.
_LANCZOS_CUT_FILL = [
    ("scene_raster.cu",
     "        fill_rows(s_tab, K, V, NT, 8 * g0, min(8 * run, hc - 8 * g0), wc,",
     "        if (false)\n"
     "        fill_rows(s_tab, K, V, NT, 8 * g0, min(8 * run, hc - 8 * g0), wc,",
     1)]
_LANCZOS_CUT_HPASS = [
    ("scene_raster.cu", "  for (int base = 0; base < mt * nb; base += 32) {",
     "  for (int base = 0; base < 0; base += 32) {", 1)]
_LANCZOS_CUT_VPASS = [
    ("scene_raster.cu",
     "        vpass_unit(hpT, plane, hp, vt, u / nt_v, 8 * (u % nt_v), h, w,",
     "        if (false)\n"
     "        vpass_unit(hpT, plane, hp, vt, u / nt_v, 8 * (u % nt_v), h, w,",
     1)]
SPLIT = [
    # The canvas is first set to ones: a second zeroing's worth of stores.
    ("zero_twice", [
        ("scene_raster.cu", "zero(group, size_t(aa) * cp, lane, 32);",
         "for (int i = lane; i < aa * cp / 16; i += 32)\n"
         "          reinterpret_cast<uint4*>(group)[i] = "
         "make_uint4(kFull, kFull, kFull, kFull);\n"
         "        zero(group, size_t(aa) * cp, lane, 32);", 1),
        ("strip_raster.cu",
         "    for (int i = tid; i < zero_rows * cp / 16; i += kThreads)\n"
         "      canvas16[i] = make_uint4(0u, 0u, 0u, 0u);",
         "    for (int i = tid; i < zero_rows * cp / 16; i += kThreads)\n"
         "      canvas16[i] = make_uint4(kFull, kFull, kFull, kFull);\n"
         "  if (kLanczos || on != 0u)\n"
         "    for (int i = tid; i < zero_rows * cp / 16; i += kThreads)\n"
         "      canvas16[i] = make_uint4(0u, 0u, 0u, 0u);", 1)]),
    ("cut_fill", _CUT_FILL),
    # Each output reads one canvas byte instead of its block.
    ("one_sample_box", [
        ("raster_fill.cuh",
         "box_words<kRoute>(canvas, cp, aa, by, x * aa, met, ctab, regs, "
         "chan, kc,\n                      o, lane);",
         "{ if (met) slot_pixel(ctab[canvas[size_t(by) * cp + x * aa]], o); }",
         1)]),
    ("cut_output", _CUT_OUTPUT),
    # Setup alone: zeroing, fill and output cut.
    ("setup_only", _CUT_ZERO + _CUT_FILL + _CUT_OUTPUT),
    ("lanczos_cut_fill", _LANCZOS_CUT_FILL),
    ("lanczos_cut_hpass", _LANCZOS_CUT_HPASS),
    ("lanczos_cut_vpass", _LANCZOS_CUT_VPASS),
    # The background's h-values in hpT and the dead v-pass units' pixels.
    ("lanczos_cut_background", [
        ("scene_raster.cu",
         "for (; dead; dead &= dead - 1u) row[32 * k + __ffs(dead) - 1] = v8;",
         "", 1),
        ("scene_raster.cu",
         "for (int i = tid; i < (nv - nvl) * 16; i += kThreads) {",
         "for (int i = tid; i < 0; i += kThreads) {", 1)]),
    # Setup alone: the tables, the plan and the background; zeroing, fill
    # and both passes cut.
    ("lanczos_setup_only", [
        ("scene_raster.cu",
         "      zero(canvas, size_t(8 * nb) * cp, tid, kThreads);\n", "", 1)]
     + _LANCZOS_CUT_FILL + _LANCZOS_CUT_HPASS + _LANCZOS_CUT_VPASS),
    ("packed_cut_fill", _PACKED_CUT_FILL),
    ("packed_cut_output", _PACKED_CUT_OUTPUT),
    ("packed_setup_only", _PACKED_CUT_SPRITES + _PACKED_CUT_OUTPUT),
]


def make_copy(work, name, edits):
    """A copy of the package under `work`/`name` with `edits` applied."""
    dest = work / name
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "spriteworld_torch", dest / "spriteworld_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for fname, old, new, times in edits:
        path = dest / "spriteworld_torch" / "csrc" / fname
        text = path.read_text()
        if text.count(old) != times:
            raise RuntimeError(f"variant {name}: {old!r} occurs "
                               f"{text.count(old)} times in {fname}, not "
                               f"{times}")
        path.write_text(text.replace(old, new))
    return dest


# The kernels a source feeds: an edit of a header reaches all three.
KERNELS = ("scene", "strips", "packed")
_SOURCE_KERNELS = {"scene_raster.cu": ("scene",),
                   "strip_raster.cu": ("strips",),
                   "packed_raster.cu": ("packed",),
                   "lanczos_mma.cuh": ("scene", "strips")}


def kernels_of(edits):
    """The kernels whose sources `edits` touch, in KERNELS order."""
    hit = {k for fname, *_ in edits
           for k in _SOURCE_KERNELS.get(fname, KERNELS)}
    return [k for k in KERNELS if k in hit]


def child(share, checked, kernels=KERNELS):
    """One variant's run, in the copy's directory: prints one JSON line.
    A `checked` variant's renders on the paths (and on batches of more
    sprites) must equal the plain version's. Only `kernels` are run."""
    import torch

    import bench_torch
    import chip_smoke as cs
    from spriteworld_torch.ops import _build
    from spriteworld_torch.ops import rasterize_cuda as rc
    from spriteworld_torch.utils import colors

    cs.check(pathlib.Path(rc.__file__).is_relative_to(pathlib.Path.cwd()),
             f"{rc.__file__} is not the variant's copy")
    _build.build_all()
    states = cs.path_states(torch, bench_torch, demo="strips" in kernels)
    scene_state = states[0]
    demo_state = states[1] if "strips" in kernels else None
    out = {}
    paths = []
    if "scene" in kernels:
        paths.append(("scene_raster", scene_state, (64, 64), 5,
                      lambda t, ds: rc.scene_raster(t, (64, 64), None, ds)))
    if "strips" in kernels:
        paths.append(("strip_raster+strip_vpass", demo_state, (256, 256), 10,
                      lambda t, ds: rc.render_strips(t, (256, 256), None,
                                                     None, ds)))
    for label, state, size, aa, run in paths:
        for pil_exact, ds in ((True, "lanczos"), (False, "box")):
            t = rc.prepare(state.factors, state.num_sprites, size[0] * aa,
                           size[1] * aa, colors.hsv_to_rgb, pil_exact)
            if checked:
                _, count = cs.compare(run(t, ds),
                                      rc.render_rgb_batch_plain(t, size,
                                                                None, ds))
                cs.check(count == 0, f"{label} differs from plain on its "
                                     f"path ({ds})")
            if share and ds == "lanczos":
                u, n = cs.uniform_units(torch, t, size[1])
                out[f"{label} one-slot units"] = [u, n, u / n]
            if share and ds == "box":
                _, u, n = cs.word_box_ops(torch, t, aa, aa)
                out[f"{label} one-slot box blocks"] = [u, n, u / n]
    if paths:
        out.update(cs.time_split(
            torch, rc, colors, scene_state if "scene" in kernels else None,
            demo_state))
    if "scene" in kernels:  # exact+lanczos on two cells' scenes
        out["scene paths"] = cs.time_scene_paths(
            torch, rc, cs.scene_path_tables(torch, colors, names=(
                "cobra.goal_finding_new_position",
                "examples.goal_finding_clustering")), checked=checked)
    if "packed" in kernels:
        out["packed_raster"] = {}
        for pil_exact in (True, False):
            t = rc.prepare(scene_state.factors, scene_state.num_sprites, 64,
                           64, colors.hsv_to_rgb, pil_exact)
            mode = rc.mode_name(pil_exact, rc.DS_IDENTITY)
            if checked:
                _, count = cs.compare(rc.packed_raster(t, (64, 64)),
                                      rc.render_rgb_batch_plain(t, (64, 64)))
                cs.check(count == 0, f"packed_raster differs from plain on "
                                     f"its path ({mode})")
            out["packed_raster"][mode] = cs.event_ms(
                torch, lambda: rc.packed_raster(t, (64, 64)), 200, True)
    if not checked:
        print(json.dumps(out))
        return
    many = []
    if "scene" in kernels:
        many.append(("scene_raster, 8 sprites", 71, 2048, (64, 64), 5, 8,
                     20, lambda t: rc.scene_raster(t, (64, 64))))
    if "strips" in kernels:
        many.append(("strip_raster+strip_vpass, 8 sprites", 72, 64,
                     (256, 256), 10, 8, 5,
                     lambda t: rc.render_strips(t, (256, 256))))
    if "packed" in kernels:  # K + 1 = 17 slots: the table route
        many.append(("packed_raster, 16 sprites", 73, 2048, (64, 64), 1, 16,
                     200, lambda t: rc.packed_raster(t, (64, 64))))
    for label, seed, b, size, aa, kmax, reps, run in many:
        f, n = cs.scene_batch(seed, b, kmax=kmax, hsv=True)
        t = rc.prepare(torch.from_numpy(f).cuda(), torch.from_numpy(n).cuda(),
                       size[0] * aa, size[1] * aa, colors.hsv_to_rgb)
        _, count = cs.compare(run(t), rc.render_rgb_batch_plain(t, size))
        cs.check(count == 0, f"{label} differs from plain")
        out[label] = {rc.mode_name(True, rc.DS_LANCZOS if aa > 1
                                   else rc.DS_IDENTITY):
                      cs.event_ms(torch, lambda: run(t), reps, aa == 1)}
    print(json.dumps(out))


def chunk_graphs(steps=20, chunks=6):
    """A rollout chunk of `steps` steps replayed from the runner's graph of
    one step against one graph that captures all `steps` steps, on
    chip_smoke.RUNNER_PATHS, in alternating chunks (each: load the start
    state, replay, read the metrics):
    python3 -c 'import ablate_kernels; ablate_kernels.chunk_graphs()'.
    Prints one JSON line a path with each chunk's seconds."""
    import torch

    import bench_torch
    import chip_smoke as cs
    from spriteworld_torch.core.distributions import defer_rejection
    from spriteworld_torch.ops import _build
    from spriteworld_torch.parallel import ShardedRunner
    from spriteworld_torch.parallel import runner as runner_lib

    cs.check(torch.cuda.is_available(), "no CUDA device")
    card = bench_torch.card_name_and_power_limit()
    print(card)
    _build.build_all()
    for label, name, aa, lanes, _ in cs.RUNNER_PATHS:
        env, _, _ = bench_torch.build(name, aa, True, device="cuda", seed=0)
        runner = ShardedRunner(env, lanes)
        state, _ = runner.reset(0)
        sig = (steps, False, None)
        state, _ = runner.rollout(state, steps)  # captures the step graph
        carry, program = runner._programs[sig + (True,)]
        step_graph = program.graph
        whole = torch.cuda.CUDAGraph()
        with torch.cuda.graph(whole), defer_rejection(carry.pending):
            for _ in range(steps):
                runner._step(carry, *sig)

        def chunk(graph, replays):
            carry.load(state, runner.episode_returns, runner.action_key)
            for _ in range(replays):
                graph.replay()
            return runner_lib._to_host(carry.counts)

        times = {"step graph": [], "chunk graph": []}
        for c in range(chunks):
            runs = [("step graph", step_graph, steps),
                    ("chunk graph", whole, 1)]
            for key, graph, replays in (runs if c % 2 == 0 else runs[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chunk(graph, replays)
                times[key].append(time.perf_counter() - t0)
        print(json.dumps({"path": label, "lanes": lanes, "steps": steps,
                          "seconds": times, "card": card}))


def eager_steps(tree=".", workload="image64", aa=None, lanes=None,
                steps=20, chunks=4, device="cuda"):
    """The eager environment step of the repo's tree at `tree` (this one,
    or an older commit unpacked with `git archive`), driven the same way
    for every tree: `Environment.step_batch` on `sample_action(lanes)` from
    one `reset_batch`, no observation read (what `BatchedEnvironment.step`
    ran before it replayed graphs). Prints one JSON line: wall ms a step
    and env-steps/s of `chunks` timed chunks of `steps` steps (after one
    warm-up chunk), and on the card the device busy ms, idle share and
    launches a step of one more chunk under torch.profiler. Run one tree
    a process:
    python3 -c 'import ablate_kernels as a; a.eager_steps("archive/parent",
    "sorting")'."""
    sys.path.insert(0, os.path.abspath(tree))
    import statistics

    import torch

    import bench_torch

    (name, aa, exact), = bench_torch.todo_list(workload, aa, False)
    lanes = lanes or (256 if name == "demo256" else 2048)
    env, _, _ = bench_torch.build(name, aa, exact, device=device, seed=0)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    if hasattr(env, "lane_keys"):
        # A tree whose actions draw from lane keys: a step's keys split
        # from a carried key, as BatchedEnvironment.sample_actions does.
        from spriteworld_torch.ops import lane_random

        carried = [lane_random.key(0, env.device)]

        def sample():
            carried[0], step_key = lane_random.split(carried[0], 2)
            return env.sample_action(lane_random.split(step_key, lanes))
    else:
        def sample():
            return env.sample_action(lanes)

    def chunk(state):
        for _ in range(steps):
            state, _ = env.step_batch(state, sample())
        return state

    state = chunk(env.reset_batch(lanes)[0])
    times = []
    for _ in range(chunks):
        sync()
        t0 = time.perf_counter()
        state = chunk(state)
        sync()
        times.append(time.perf_counter() - t0)
    out = {"tree": tree, "workload": name, "anti_aliasing": aa,
           "lanes": lanes, "device": device, "steps": steps,
           "chunk_seconds": times,
           "wall_ms_per_step_best": min(times) * 1e3 / steps,
           "wall_ms_per_step_median":
               statistics.median(times) * 1e3 / steps,
           "env_steps_per_sec_best": lanes * steps / min(times),
           "env_steps_per_sec_median":
               lanes * steps / statistics.median(times)}
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chunk(state)
            sync()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        busy_us = sum(e.self_device_time_total for e in kernels)
        out.update({
            "profiled_wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernel_launches_per_step":
                sum(e.count for e in kernels) / steps,
            "card": bench_torch.card_name_and_power_limit()})
    else:
        out["host_cpus"] = os.cpu_count()
    print(json.dumps(out), flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(ROOT / "spriteworld_torch" / "build"
                                        / "ablation.json"))
    p.add_argument("--only", default=None,
                   help="comma-separated variant names (default: all of "
                        "VARIANTS and SPLIT)")
    args = p.parse_args()
    import bench_torch

    card = bench_torch.card_name_and_power_limit()
    print(card)
    chosen = dict(VARIANTS + SPLIT)
    if args.only:
        chosen = {n: chosen[n] for n in args.only.split(",")}
    work = ROOT / "spriteworld_torch" / "build" / "ablate"
    copies = {"base": make_copy(work, "base", [])}
    for name, edits in chosen.items():
        copies[name] = make_copy(work, name, edits)
    checked = {"base"} | {n for n, _ in VARIANTS}
    kernels = {n: kernels_of(e) for n, e in chosen.items()}
    kernels["base"] = [k for k in KERNELS
                       if any(k in ks for ks in kernels.values())]
    names = list(copies)
    order = names + names[::-1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    runs = []
    for i, name in enumerate(order):
        code = (f"import ablate_kernels; "
                f"ablate_kernels.child({i == 0}, {name in checked}, "
                f"{kernels[name]!r})")
        proc = subprocess.run([sys.executable, "-c", code], cwd=copies[name],
                              env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"variant {name} failed")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"variant": name, **result})
        print(json.dumps(runs[-1]), flush=True)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps({"card": card,
                                                  "runs": runs}) + "\n")


if __name__ == "__main__":
    main()
