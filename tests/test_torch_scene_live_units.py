"""The scene kernel's live units with the Lanczos filter, on the CPU: the
twin masks of the units it computes (`rasterize_cuda.scene_live_units`)
and the background it writes everywhere else (`scene_background`), held
against the plain render; the plan's shared memory against the H100's;
and the census and summary readings of the kernel's count (the card holds
the kernel itself to the twins: chip_smoke.py's `live_units_vs_plain`)."""

import numpy as np
import pytest
import torch

import chip_smoke

from spriteworld_torch.ops import rasterize_cuda as tcuda
from spriteworld_torch.utils import colors
from spriteworld_torch.utils import profiling

BG = (10, 20, 30)


def _taps(size, aa):
    h, w = size
    return tcuda.lanczos_tiles(w * aa, w), tcuda.lanczos_tiles(h * aa, h)


def _uniform(v, qsum):
    return ((v * qsum + (1 << 21)) >> 22).clamp(0, 255)


def assert_dead_units_are_background(tables, size, aa, bg_color):
    """Every v-pass unit the mask calls dead renders as the background
    image there, and every dead h-pass unit h-passes to the background's
    h-values; returns the masks."""
    h, w = size
    hmask, vmask = tcuda.scene_live_units(tables, size, aa)
    img = torch.flip(tcuda.render_rgb_batch_plain(tables, size, bg_color),
                     dims=(1,))  # Pillow's row order, as the units count
    bg = torch.flip(tcuda.scene_background(_taps(size, aa), bg_color, size),
                    dims=(0,))
    rows = torch.arange(h) // 16
    cols = torch.arange(w) // 8
    dead = ~vmask[:, rows][:, :, cols]  # [B, H, W]
    assert torch.equal(img[dead], bg.expand_as(img)[dead])
    hp = tcuda.hpass_plain(tables, w, bg_color).long()  # [B, hc, w, 3]
    qsum = torch.from_numpy(_taps(size, aa)[0].qsum[:w].astype(np.int64))
    bgh = _uniform(torch.tensor(bg_color or (0, 0, 0))[None], qsum[:, None])
    hdead = ~hmask[:, torch.arange(h * aa) // 8][:, :, torch.arange(w) // 16]
    assert torch.equal(hp[hdead], bgh.expand_as(hp)[hdead])
    return hmask, vmask


@pytest.mark.parametrize("config", chip_smoke.RASTER_CONFIGS)
def test_dead_units_render_the_background_on_the_cells_scenes(config):
    """Over seeded scenes of the four scene-kernel cells' generators, a
    step after a reset, the units the mask calls dead render the
    background pixel for pixel, and sprites leave some dead."""
    (tables, size), = chip_smoke.scene_path_tables(
        torch, colors, lanes=6, steps=1, seed=11, dev="cpu",
        names=(config,)).values()
    aa = tables.hc // size[0]
    hmask, vmask = assert_dead_units_are_background(tables, size, aa, None)
    assert 0 < vmask.float().mean() < 1 and 0 < hmask.float().mean() < 1


@pytest.mark.parametrize("size,aa", chip_smoke.LIVE_SIZES)
@pytest.mark.parametrize("case", range(7))
def test_dead_units_render_the_background_on_edge_cases(case, size, aa):
    """No live sprite, sprites across each border and corner, squares one
    pixel short of a unit's span of Lanczos support and one pixel into it
    (in columns and in rows), all 12 slots live; square and non-square."""
    name, f, n = chip_smoke.live_unit_cases(size, aa)[case]
    tables = tcuda.prepare(torch.from_numpy(f), torch.from_numpy(n),
                           size[0] * aa, size[1] * aa, None)
    hmask, vmask = assert_dead_units_are_background(tables, size, aa, BG)
    if name == "no live sprite":
        assert not hmask.any() and not vmask.any()
    if name == "all 12 slots live":
        assert vmask.float().mean() > 0.5


def test_edge_cases_stop_one_pixel_from_a_span():
    """The squares of the sweep end one pixel short of a unit's span (the
    unit stays dead for them) or one pixel into it (live)."""
    size, aa = (64, 64), 5
    span = tcuda.lanczos_tiles(320, 64).span8
    cases = dict((name, (f, n)) for name, f, n
                 in chip_smoke.live_unit_cases(size, aa))
    for label, meet in (("one pixel short of", False),
                        ("one pixel into", True)):
        f, n = cases[f"{label} a unit's span in columns"]
        t = tcuda.prepare(torch.from_numpy(f), torch.from_numpy(n), 320,
                          320, None).tab[:, 0].numpy()
        c0, c1 = t[:, tcuda.T_COL0], t[:, tcuda.T_COL1]
        gap = np.minimum.reduce([np.abs(c1[:, None] + 1 - span[None, :, 0]),
                                 np.abs(c0[:, None] - span[None, :, 1])])
        edge = np.minimum.reduce([np.abs(c1[:, None] - span[None, :, 0]),
                                  np.abs(c0[:, None] + 1 - span[None, :, 1])])
        assert ((edge if meet else gap).min(1) == 0).all()


@pytest.mark.parametrize("size,aa,bg_color", [
    ((64, 64), 5, None), ((64, 64), 5, BG), ((32, 48), 3, (255, 0, 128)),
    ((40, 24), 2, (1, 2, 3))])
def test_background_is_the_plain_render_of_an_empty_scene(size, aa,
                                                          bg_color):
    f, _ = chip_smoke.scene_batch(3, 2, kmax=2)
    tables = tcuda.prepare(torch.from_numpy(f),
                           torch.zeros(2, dtype=torch.int32),
                           size[0] * aa, size[1] * aa, None)
    plain = tcuda.render_rgb_batch_plain(tables, size, bg_color)
    bg = tcuda.scene_background(_taps(size, aa), bg_color, size)
    assert bg.shape == (size[0], size[1], 3) and bg.dtype == torch.uint8
    assert torch.equal(plain, bg.expand_as(plain))


def test_spans_cover_each_block_of_taps():
    """span8 holds each 8-output block's inputs: every nonzero tap of its
    outputs lies inside, and the blocks' spans cover the input."""
    from spriteworld_torch.ops import resample

    for in_size, out_size in ((320, 64), (144, 48), (96, 32)):
        span = tcuda.lanczos_tiles(in_size, out_size).span8
        assert span.shape == (-(-out_size // 8), 2)
        xmins, taps = resample.pil_lanczos_fixed(in_size, out_size)
        for o in range(out_size):
            lo, hi = span[o // 8]
            assert lo <= xmins[o] and xmins[o] + len(taps[o]) <= hi
        assert span[0, 0] == 0 and span[-1, 1] == in_size


@pytest.mark.parametrize("k", [2, 7, 12])
def test_plan_keeps_two_blocks_an_sm_at_64x64(k):
    """The plan of the live units sits beside the band and the h-pass
    buffer: at 64x64/AA=5 two blocks still share an H100 SM (228 KiB of
    shared memory, 1 KiB reserved a block) up to the 12 slots of 30
    vertices of the compositional example."""
    v = 30
    total = tcuda.scene_smem_bytes(k, v, 320, 320, 64, 64, tcuda.DS_LANCZOS)
    plan = tcuda.plan_bytes(k, 320, 64, 64)
    assert plan % 16 == 0 and plan < 2048
    assert 2 * (total + 1024) <= 228 * 1024


def test_census_and_summary_read_the_kernel_count(monkeypatch):
    """A launch that counts on the card leaves a reading in the census of
    the capture, read when the census is taken; `summary` reads every
    registered counter under its root entry."""
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    counts = [(3, 32)]
    with profiling.capture("step") as rec:
        profiling.count("scene_raster", "exact+lanczos", slots=2,
                        reading=lambda: counts[-1])
    counts.append((5, 32))  # a later replay's count
    row = rec.census_table()["scene_raster"]["exact+lanczos"]
    assert row == {"launches": 1, "blocks": 0, "slots": [2],
                   "live_units": [5, 32]}
    monkeypatch.setattr(profiling, "_READINGS", {})
    profiling.reading("scene_raster.live_units", lambda: counts[-1])
    assert profiling.summary([])[""]["readings"] == {
        "scene_raster.live_units": (5, 32)}
    assert tcuda.scene_raster.live_units() is None  # no launch on the CPU


def test_live_share_reads_the_runner_census(monkeypatch):
    """scene_raster.live_share.rollout: the census's live units over all
    units, in %; None without the counter (a program that keeps none)."""
    from perfbench import harness

    read = harness.Layout().reader("scene_raster.live_share.rollout").read
    rec = profiling.GraphRecord("runner.step")
    rec.census = {("scene_raster", "exact+lanczos"): [1, 0]}
    monkeypatch.setattr(profiling, "graphs", lambda: [rec])
    assert read(None) is None
    rec.readings[("scene_raster", "exact+lanczos")] = lambda: (20438, 65536)
    assert read(None) == pytest.approx(100 * 20438 / 65536)
    monkeypatch.setattr(profiling, "graphs", lambda: [])
    assert read(None) is None
