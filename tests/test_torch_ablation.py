"""The measurement helpers behind the kernels' bounds and the fast-path
ablation: ablate_kernels.py's variants still apply to the CUDA sources, and
chip_smoke.py's counts of the work the kernels do hold on small scenes."""

import pytest
import torch

import ablate_kernels
import chip_smoke

from spriteworld_torch.ops import rasterize_cuda as tcuda


@pytest.mark.parametrize("variant",
                         ablate_kernels.VARIANTS + ablate_kernels.SPLIT,
                         ids=lambda v: v[0])
def test_ablation_variant_applies_to_the_sources(variant, tmp_path):
    name, edits = variant
    copy = ablate_kernels.make_copy(tmp_path, name, edits)
    for fname, old, new, times in edits:
        text = (copy / "spriteworld_torch" / "csrc" / fname).read_text()
        # Where the edit wraps the text (new holds old), it stays wrapped.
        assert text.count(old) == times * new.count(old)
        assert text.count(new) >= times


def _tables(seed, b, n=None, pil_exact=True, size=64, aa=5):
    f, live = chip_smoke.scene_batch(seed, b)
    if n is not None:
        live[:] = n
    return tcuda.prepare(torch.from_numpy(f), torch.from_numpy(live),
                         size * aa, size * aa, None, pil_exact)


def test_compacted_fill_counts_the_crossings_each_row_keeps():
    """Per row of a sprite's bounds, 5 operations an edge and 2 a pixel for
    each crossing with a weight; a row crosses a simple polygon at a few
    edges, so the count falls well under the every-edge count."""
    tables = _tables(1, 4)
    compacted = chip_smoke.compacted_fill_ops(torch, tables)
    assert 0 < compacted < chip_smoke.fill_ops(tables) / 2
    # By hand for one sprite: the same sums over its bounds' rows.
    one = tcuda.SceneTables(tab=tables.tab[:1, :1].contiguous(),
                            num_vertices=tables.num_vertices, hc=tables.hc,
                            wc=tables.wc, pil_exact=True)
    t = one.tab[0, 0].numpy()
    wgt = tcuda.exact_crossings(one, 0)[1][0].numpy()  # [hc, V]
    r0, r1 = max(int(t[tcuda.T_ROW0]), 0), min(int(t[tcuda.T_ROW1]),
                                               one.hc - 1)
    cols = min(t[tcuda.T_COL1], one.wc - 1) - max(t[tcuda.T_COL0], 0) + 1
    count = t[tcuda.T_COUNT]
    want = sum(5 * count + 2 * (wgt[r] > 0).sum() * cols
               for r in range(r0, r1 + 1))
    assert chip_smoke.compacted_fill_ops(torch, one) == pytest.approx(want)


def test_uniform_units_of_empty_and_filled_scenes():
    """A scene with no live sprite holds one slot in every h-pass unit;
    sprites make some units hold more."""
    empty = _tables(2, 3, n=0)
    u, total = chip_smoke.uniform_units(torch, empty, 64)
    assert u == total == 3 * (320 // 8) * 4
    u, total = chip_smoke.uniform_units(torch, _tables(2, 3), 64)
    assert total == 3 * (320 // 8) * 4 and 0 < u < total


@pytest.mark.parametrize("pil_exact", [True, False])
def test_table_bytes_count_only_what_the_kernels_read(pil_exact):
    """Every sprite's count; the other scalars, `count` edges and `nf`
    features of each live sprite whose rows meet the canvas; never the
    padding to V edges and 2V features."""
    tables = _tables(3, 6, pil_exact=pil_exact, aa=1)
    tab = tables.tab.numpy()
    want = tab.shape[0] * tab.shape[1]
    for t in tab.reshape(-1, tab.shape[-1]):
        count, nf = int(t[tcuda.T_COUNT]), int(t[tcuda.T_NF])
        if count and t[tcuda.T_ROW0] <= tables.hc - 1 and t[tcuda.T_ROW1] >= 0:
            want += tcuda.NUM_SCALARS - 1 + 5 * count + 3 * nf
    got = chip_smoke.table_bytes(tables)
    assert got == 4 * want
    assert got < tables.tab.numel() * 4
    if not pil_exact:  # the centroid fill has no features
        assert (tab[..., tcuda.T_NF] == 0).all()
    # A sprite moved off the canvas costs only its count.
    off = tcuda.SceneTables(tab=tables.tab.clone(),
                            num_vertices=tables.num_vertices, hc=tables.hc,
                            wc=tables.wc, pil_exact=pil_exact)
    off.tab[..., tcuda.T_ROW0] = tables.hc + 5
    assert chip_smoke.table_bytes(off) == 4 * tab.shape[0] * tab.shape[1]
