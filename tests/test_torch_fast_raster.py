"""The word arithmetic of the kernels' fast (pil_exact=False) path, on the
CPU: the box filter's word compare and masked sums, the counts of the work
the kernels do behind `bound_tc_ms`, and the shared-memory layouts of the
box instantiations.

The CUDA kernels do not run here; their arithmetic does, through the torch
twin `rasterize_cuda.box_words`, held against `ops.rasterize.box_filter`'s
sums and the definition of a one-slot block. Inputs come from numpy seeds.
Exact throughout: every value is an integer.
"""

import numpy as np
import pytest
import torch

import chip_smoke

from spriteworld_torch.ops import rasterize as trasterize
from spriteworld_torch.ops import rasterize_cuda as tcuda

H100_SMEM_PER_BLOCK = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin
H100_SMEM_PER_SM = 228 * 1024  # of which 1 KiB is reserved per block


def _slot_canvases(rng, b, hc, wc, pitch, slots):
    """u8[b, hc, pitch]: rectangles of random slots painted over slot 0 in
    the first wc columns, random bytes in the padding."""
    s = np.zeros((b, hc, pitch), np.uint8)
    for i in range(b):
        for _ in range(8):
            y, x = rng.integers(0, hc), rng.integers(0, wc)
            s[i, y:y + rng.integers(1, hc), x:x + rng.integers(1, wc)] = \
                rng.integers(0, slots)
    s[:, :, wc:] = rng.integers(0, 256, (b, hc, pitch - wc))
    return torch.from_numpy(s)


@pytest.mark.parametrize("aa", [2, 3, 5, 10])
def test_box_words_equal_the_box_filter(aa):
    """The word-wise one-slot test holds exactly for the blocks whose
    aa x aa slots are all equal, and the output equals box_filter's on the
    slots' colours, with 17 slots (past both register routes) and garbage
    in the row padding the masks must ignore."""
    rng = np.random.default_rng(aa)
    b, h, w, slots = 3, 6, 7, 17
    hc, wc = h * aa, w * aa
    canvas = _slot_canvases(rng, b, hc, wc, tcuda._round16(wc), slots)
    colors = torch.from_numpy(rng.integers(0, 1 << 24, (b, slots)))
    got, one_slot = tcuda.box_words(canvas, colors, aa, w)
    packed = colors.gather(1, canvas[..., :wc].reshape(b, -1).long())
    packed = packed.reshape(b, hc, wc)
    pix = torch.stack([packed >> 16, (packed >> 8) & 255, packed & 255], -1)
    assert torch.equal(got, trasterize.box_filter(pix, h, w))
    blocks = canvas[..., :wc].reshape(b, h, aa, w, aa).transpose(2, 3)
    blocks = blocks.reshape(b, h, w, aa * aa)
    assert torch.equal(one_slot, (blocks == blocks[..., :1]).all(-1))
    assert 0 < int(one_slot.sum()) < one_slot.numel()


def test_box_words_on_rendered_scenes_equal_the_plain_render():
    """On the centroid fill of seeded scenes at 32x32/AA=5 the word-wise box
    gives the plain render (before its flip), its one-slot blocks are those
    whose slots are all equal, and word_box_ops counts them."""
    f, n = chip_smoke.scene_batch(91, 4)
    size, aa = 32, 5
    hc = size * aa
    tables = tcuda.prepare(torch.from_numpy(f), torch.from_numpy(n), hc, hc,
                           None, pil_exact=False)
    (slots,) = list(chip_smoke.slot_canvas(torch, tables))
    pitch = tcuda._round16(hc)
    canvas = torch.zeros((4, hc, pitch), dtype=torch.uint8)
    canvas[..., :hc] = slots
    colors = torch.cat([torch.zeros((4, 1)), tables.tab[..., tcuda.T_COLOR]],
                       -1).to(torch.int64)
    got, one_slot = tcuda.box_words(canvas, colors, aa, size)
    want = tcuda.render_rgb_batch_plain(tables, (size, size))
    assert torch.equal(got, torch.flip(want, dims=(1,)))
    blocks = slots.reshape(4, size, aa, size, aa).transpose(2, 3)
    blocks = blocks.reshape(4, size, size, aa * aa)
    assert torch.equal(one_slot, (blocks == blocks[..., :1]).all(-1))
    assert chip_smoke.word_box_ops(torch, tables, aa, aa)[1:] == (
        int(one_slot.sum()), one_slot.numel())


def test_one_slot_blocks_of_empty_and_filled_scenes():
    f, n = chip_smoke.scene_batch(92, 3)
    for live, whole in ((0 * n, True), (n, False)):
        tables = tcuda.prepare(torch.from_numpy(f), torch.from_numpy(live),
                               160, 160, None, pil_exact=False)
        _, u, total = chip_smoke.word_box_ops(torch, tables, 5, 5)
        assert total == 3 * 32 * 32
        assert (u == total) == whole and u > total // 2


def test_box_layouts_fit_the_h100_at_the_paths_shapes():
    """The box instantiations' layouts at the two fast paths' shapes
    (image64/AA=5 with K = 6, demo256 with K = 4; V = 30).

    Scene kernel: 16 warps a block, each with its own group of 5 canvas
    rows of 320 bytes: 25,600 bytes of canvas beside the tables and scratch.
    Three such blocks fit an SM's 228 KiB (1 KiB reserved a block), where
    the parent's whole 320x320 canvas (114,640 bytes) fitted two. At
    256x256/AA=10 sixteen groups of 10 rows of 2,560 bytes exceed the 227
    KiB a block may have, so the demo's canvas still takes the strips.

    Strip kernel: 20 canvas rows of 2,560 bytes (the default 64 KiB,
    rounded down to whole 10-row groups), the tables, scratch and channel
    tables: four blocks' shared memory fits an SM."""
    k, v = 6, 30
    scene = tcuda.scene_smem_bytes(k, v, 320, 320, 64, 64, tcuda.DS_BOX)
    head = (k * tcuda.table_width(v) + k + 1 + 2 * 16 * 32) * 4
    assert scene == tcuda._round16(head) + 16 * 5 * 320 + 48
    assert 3 * (scene + 1024) <= H100_SMEM_PER_SM
    assert tcuda.resolve_kernel_mode("auto", scene,
                                     H100_SMEM_PER_BLOCK) == "scene"
    demo = tcuda.scene_smem_bytes(4, v, 2560, 2560, 256, 256, tcuda.DS_BOX)
    assert demo > H100_SMEM_PER_BLOCK
    assert tcuda.resolve_kernel_mode("auto", demo,
                                     H100_SMEM_PER_BLOCK) == "strips"
    rows = tcuda.default_strip_rows(2560, tcuda._round16(2560), 10)
    assert rows == 20
    strip = tcuda.strip_smem_bytes(4, rows, 2560)
    assert strip == (5 + 2 * 8 * 32) * 4 + 12 + 20 * 2560 + 48
    assert 4 * (strip + 1024) <= H100_SMEM_PER_SM


def test_word_box_ops_count_the_work_of_the_word_box():
    """An empty scene reads no canvas; with one sprite the outputs that read
    it are those whose columns meet its bounds on their rows: 2 operations
    a word of the block, 6 more for a block of more than one slot."""
    f, n = chip_smoke.scene_batch(93, 2)
    aa, size = 5, 32
    hc = size * aa
    empty = tcuda.prepare(torch.from_numpy(f), torch.from_numpy(0 * n), hc,
                          hc, None, pil_exact=False)
    assert chip_smoke.word_box_ops(torch, empty, aa, aa) == (
        0.0, 2 * size * size, 2 * size * size)
    one = tcuda.prepare(torch.from_numpy(f[:1, :1]),
                        torch.tensor([1], dtype=torch.int32), hc, hc, None,
                        pil_exact=False)
    box, uniform, total = chip_smoke.word_box_ops(torch, one, aa, aa)
    t = one.tab[0, 0]
    _, one_slot = tcuda.box_words(
        torch.nn.functional.pad(next(chip_smoke.slot_canvas(torch, one)),
                                (0, tcuda._round16(hc) - hc)),
        torch.cat([torch.zeros(1, 1), t[None, None, tcuda.T_COLOR]],
                  -1).long(), aa, size)
    want = 0
    for y in range(size):
        lo, hi = y * aa, y * aa + aa - 1
        if not (t[tcuda.T_ROW0] <= hi and t[tcuda.T_ROW1] >= lo):
            continue
        for x in range(size):
            a, b = x * aa, x * aa + aa - 1
            if t[tcuda.T_COL0] <= b and t[tcuda.T_COL1] >= a:
                nw = (a % 4 + aa + 3) // 4
                want += aa * nw * (2 if one_slot[0, y, x] else 8)
    assert box == want > 0
    assert (uniform, total) == (int(one_slot.sum()), size * size)
    # Strips of 20 rows read more outputs than 5-row groups.
    assert chip_smoke.word_box_ops(torch, one, aa, 20)[0] >= box
