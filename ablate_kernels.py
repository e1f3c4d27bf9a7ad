"""Times the two Lanczos kernels with one of their fast paths taken out.

Each variant is a copy of spriteworld_torch whose CUDA sources differ from
the tree's by one textual edit (VARIANTS). Every copy builds its kernels
anew and, in its own process, checks scene_raster and the strip kernels
against the plain version at the two paths' inputs and times them:
chip_smoke.time_split on the paths' scenes (image64/AA=5, B=2048 and
demo256, B=256, each in exact+lanczos, exact+box and centroid+box) and
exact+lanczos on seeded 8-sprite batches (K + 1 = 9 slots; the paths have
K + 1 <= 8). The runs go base, the variants, the variants in reverse, base,
so that drift across the call shows. The base run also prints the share of
h-pass units (16 outputs by 8 canvas rows) whose window holds one slot
throughout, on each path's scenes.

Usage: python3 ablate_kernels.py [--out PATH]
(default spriteworld_torch/build/ablation.json)
(needs one CUDA card)
"""

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent

# (name, file under csrc, text, replacement, occurrences)
VARIANTS = [
    ("route16", "lanczos_mma.cuh",
     "return K + 1 <= 8 ? kRoute8 : (K + 1 <= 16 ? kRoute16 : kRouteTable);",
     "return K + 1 <= 16 ? kRoute16 : kRouteTable;", 1),
    ("table_route", "lanczos_mma.cuh",
     "return K + 1 <= 8 ? kRoute8 : (K + 1 <= 16 ? kRoute16 : kRouteTable);",
     "return kRouteTable;", 1),
    ("shared_crossings", "raster_fill.cuh", "if (n <= kRegCrossings) {",
     "if (false) {", 2),
    ("no_uniform_skip", "lanczos_mma.cuh", "if (__all_sync(kFull, same)) {",
     "if (false && __all_sync(kFull, same)) {", 1),
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


def child(share):
    """One variant's run, in the copy's directory: prints one JSON line."""
    import torch

    import bench_torch
    import chip_smoke as cs
    from spriteworld_torch.core import environment as env_lib
    from spriteworld_torch.ops import _build
    from spriteworld_torch.ops import rasterize_cuda as rc
    from spriteworld_torch.utils import colors

    cs.check(pathlib.Path(rc.__file__).is_relative_to(pathlib.Path.cwd()),
             f"{rc.__file__} is not the variant's copy")
    _build.build_all()
    scene_state, demo_state = cs.path_states(torch, bench_torch, env_lib)
    out = {}
    for label, state, size, aa, run in (
            ("scene_raster", scene_state, (64, 64), 5,
             lambda t: rc.scene_raster(t, (64, 64))),
            ("strip_raster+strip_vpass", demo_state, (256, 256), 10,
             lambda t: rc.render_strips(t, (256, 256)))):
        t = rc.prepare(state.factors, state.num_sprites, size[0] * aa,
                       size[1] * aa, colors.hsv_to_rgb)
        _, count = cs.compare(run(t), rc.render_rgb_batch_plain(t, size))
        cs.check(count == 0, f"{label} differs from plain on its path")
        if share:
            u, n = cs.uniform_units(torch, t, size[1])
            out[f"{label} one-slot units"] = [u, n, u / n]
    out.update(cs.time_split(torch, rc, colors, scene_state, demo_state))
    for label, seed, b, size, aa, reps, run in (
            ("scene_raster, 8 sprites", 71, 2048, (64, 64), 5, 20,
             lambda t: rc.scene_raster(t, (64, 64))),
            ("strip_raster+strip_vpass, 8 sprites", 72, 64, (256, 256), 10,
             5, lambda t: rc.render_strips(t, (256, 256)))):
        f, n = cs.scene_batch(seed, b, kmax=8, hsv=True)
        t = rc.prepare(torch.from_numpy(f).cuda(), torch.from_numpy(n).cuda(),
                       size[0] * aa, size[1] * aa, colors.hsv_to_rgb)
        _, count = cs.compare(run(t), rc.render_rgb_batch_plain(t, size))
        cs.check(count == 0, f"{label} differs from plain")
        out[label] = {"exact+lanczos": cs.event_ms(torch, lambda: run(t),
                                                   reps)}
    print(json.dumps(out))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(ROOT / "spriteworld_torch" / "build"
                                        / "ablation.json"))
    args = p.parse_args()
    import bench_torch

    card = bench_torch.card_name_and_power_limit()
    print(card)
    work = ROOT / "spriteworld_torch" / "build" / "ablate"
    copies = {"base": make_copy(work, "base", [])}
    for name, *edit in VARIANTS:
        copies[name] = make_copy(work, name, [edit])
    names = list(copies)
    order = names + names[::-1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    runs = []
    for i, name in enumerate(order):
        code = (f"import ablate_kernels; "
                f"ablate_kernels.child({i == 0})")
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
