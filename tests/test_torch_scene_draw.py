"""A generator's whole scene in one launch: the `lane_random` kernel's scene
mode (`lane_random.draw_scene`) against the generator's plain body
(`GenerateSprites._sample_plain`).

A `GenerateSprites` whose factor distribution is a tree of `Product`s over
`Continuous` and `Discrete` leaves takes the scene mode on CUDA keys. The
`cuda` cases hold it bit for bit (`torch.equal`) against the plain body on
the card, over every leaf kind and cast, nested `Product`s, constant and
`RandInt` counts, 1 to 12 slots, 1, 7 and 2,048 lanes, keys read through a
stride, the whole `init_sprites` of the benchmarked configurations and a
captured graph. They skip without a card; on the card's machine run them
with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_scene_draw.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks).
The CPU cases check which generators take the route, the descriptor table
(read here by `table_twin`, a second reading of its layout, against the
plain body), that CPU keys take the plain body, and the counters.
"""

import numpy as np
import pytest
import torch

from spriteworld_torch import constants
from spriteworld_torch.configs.cobra import goal_finding_new_position
from spriteworld_torch.configs.cobra import sorting
from spriteworld_torch.configs.examples import goal_finding_clustering
from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import generators
from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import lane_random as lr
from spriteworld_torch.utils import profiling

CONFIGS = {"cobra.sorting": sorting,
           "cobra.goal_finding_new_position": goal_finding_new_position,
           "examples.goal_finding_clustering": goal_finding_clustering}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the lane_random kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def generate_sprites_of(gen, out=None):
    """Every `GenerateSprites` node under `gen`, depth first, as often as
    the tree evaluates it."""
    out = [] if out is None else out
    if isinstance(gen, generators.GenerateSprites):
        out.append(gen)
    for child in getattr(gen, "gens", ()):
        generate_sprites_of(child, out)
    if hasattr(gen, "gen"):
        generate_sprites_of(gen.gen, out)
    return out


def leaf_trees():
    """{name: (factor distribution, count)}: every leaf kind and cast,
    nested Products, constant and random counts."""
    shape = distribs.Discrete("shape", ["square", "triangle", "circle"])
    return {
        "floats": (distribs.Product([
            distribs.Continuous("x", 0.1, 0.9),
            distribs.Continuous("y", -1.5, 2.25, dtype="float64")]), 3),
        "casts": (distribs.Product([
            distribs.Continuous("angle", 0, 360, dtype="int32"),
            distribs.Continuous("c0", 64, 256, dtype="uint8"),
            distribs.Continuous("c1", -300.0, 300.0, dtype="uint8"),
            distribs.Continuous("c2", -1e4, 1e4, dtype="int64"),
            distribs.Continuous("x_vel", -7.5, 7.5, dtype="int32")]), 4),
        "discrete": (distribs.Product([
            shape,
            distribs.Discrete("scale", [0.13]),
            distribs.Discrete("c0", [0.1, 0.5, 0.9, 0.7],
                              probs=[0.1, 0.2, 0.3, 0.4]),
            distribs.Discrete("c1", [3.0, 4.0, 5.0], probs=[0.5, 0.0, 0.5]),
            distribs.Discrete("c2", [1.0], probs=[1.0])]), 1),
        "nested": (distribs.Product([
            distribs.Continuous("x", 0.1, 0.9),
            distribs.Product([
                distribs.Continuous("y", 0.1, 0.9),
                distribs.Product([
                    distribs.Continuous("c0", 0.0, 1.0),
                    shape]),
                distribs.Continuous("c1", 128, 256, dtype="int32")]),
            distribs.Continuous("scale", 0.08, 0.12)]), 2),
        "randint": (distribs.Product([
            distribs.Continuous("x", 0.0, 1.0),
            shape]), generators.RandInt(1, 6)),
        "randint_from_0": (distribs.Product([
            distribs.Continuous("x", 0.0, 1.0),
            distribs.Continuous("c0", 64, 256, dtype="uint8")]),
            generators.RandInt(0, 3)),
        "twelve": (distribs.Product([
            distribs.Continuous("x", 0.1, 0.9),
            distribs.Continuous("y", 0.1, 0.9),
            shape]), 12),
        "empty": (distribs.Product([]), 2),
    }


def lane_keys(seed, batch, stride=1, device="cpu"):
    """int32[batch, 2] lane keys from `seed`; with `stride` > 1 a view
    whose lanes lie `stride` keys apart (a slice of a split)."""
    keys = lr.split(lr.key(seed, device), (batch, stride))
    return keys[:, stride - 1]


def table_twin(keys, table, kmax):
    """The scene that `table` describes, read from its words with the
    plain draws of `lane_random` on CPU keys: (factors, num, ok)."""
    words = table.words
    f32 = words.view(np.float32)
    leaves, count_lo, count_span, unwritten, width = (
        int(w) for w in words[:lr.SCENE_HEADER])
    assert (leaves, width) == (table.leaves, table.width)
    batch = keys.shape[0]
    k = lr.split(keys, 2)
    if count_span:
        num = lr.randint(k[:, 0], 1, count_lo,
                         count_lo + (count_span & lr.MASK))[:, 0]
    else:
        num = torch.full((batch,), count_lo, dtype=torch.int32)
    slot_keys = lr.split(k[:, 1], kmax)
    head = lr.SCENE_HEADER + width
    default = torch.from_numpy(f32[lr.SCENE_HEADER:head].copy())
    factors = default.expand(batch, kmax, width).clone()
    casts = {1: torch.int32, 2: torch.int64, 3: torch.uint8}
    written = 0
    for r in range(leaves):
        rec = words[head + r * lr.SCENE_RECORD:][:lr.SCENE_RECORD]
        op, column, depth, a, b, c = (int(w) for w in rec[:6])
        key = slot_keys
        for index in rec[8:8 + depth]:
            key = lr.fold_in(key, int(index))
        if op == lr.SCENE_UNIFORM:
            lo, span = (float(x) for x in rec[3:5].view(np.float32))
            bits = lr.bits(key, 1)[..., 0].to(torch.int64) & lr.MASK
            f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
                torch.float32) - 1.0
            v = lr._fma_f32(f, span, lo).clamp_min(lo)
            if c:
                v = v.to(casts[c]).to(torch.float32)
        else:
            cands = torch.from_numpy(f32[b:b + a].copy())
            if op == lr.SCENE_RANDINT:
                i = lr.randint(key, 1, 0, a)[..., 0].long()
            else:
                cum = torch.from_numpy(f32[c:c + a].copy())
                u = lr.uniform(key, 1)[..., 0]
                i = torch.searchsorted(cum, (1.0 - u) * float(cum[-1]))
            v = cands[i]
        factors[..., column] = v
        written |= 1 << column
    assert unwritten == ~written & (1 << width) - 1
    alive = torch.arange(kmax) < num[:, None]
    factors = torch.where(alive[..., None], factors, default)
    return factors, num, torch.ones(batch, dtype=torch.bool)


def assert_same_scene(got, want):
    for g, w, what in zip(got, want, ("factors", "num", "ok")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g.cpu(), w.cpu()), what


# ---------------------------------------------------------------------- #
# CPU: the route, the table, the counters.

@pytest.mark.parametrize("config,mode,scene,total", [
    ("cobra.sorting", "train", 18, 18),
    ("cobra.sorting", "test", 2, 2),
    ("cobra.goal_finding_new_position", "train", 1, 2),
    ("cobra.goal_finding_new_position", "test", 2, 2),
    ("examples.goal_finding_clustering", "train", 4, 6),
    ("examples.goal_finding_clustering", "test", 6, 6)])
def test_which_generators_take_the_scene_mode(config, mode, scene, total):
    """Leaf trees take the route; goal finding's SetMinus target and the
    compositional example's two goal groups (a SetMinus scale) do not in
    train mode, and do in test mode, where both are leaf trees."""
    gens = generate_sprites_of(CONFIGS[config].get_config(mode)[
        "init_sprites"])
    assert len(gens) == total
    assert sum(g._scene is not None for g in gens) == scene


@pytest.mark.parametrize("dist", [
    distribs.Product([distribs.SetMinus(
        distribs.Continuous("x", 0.0, 1.0),
        distribs.Continuous("x", 0.4, 0.6))]),
    distribs.Product([distribs.Selection(
        distribs.Continuous("x", 0.0, 1.0),
        distribs.Continuous("x", 0.2, 0.8))]),
    distribs.Product([distribs.Intersection([
        distribs.Continuous("x", 0.0, 1.0),
        distribs.Continuous("x", 0.2, 0.8)])]),
    distribs.Product([distribs.Mixture([
        distribs.Continuous("x", 0.0, 0.5),
        distribs.Continuous("x", 0.5, 1.0)])]),
    distribs.Product([distribs.Product([distribs.Mixture([
        distribs.Discrete("shape", ["square"]),
        distribs.Discrete("shape", ["circle"])])])]),
    distribs.Continuous("x", 0.0, 1.0),
    distribs.Product([distribs.Continuous("x", 0.0, 1.0,
                                          dtype="float16")]),
    distribs.Product([distribs.Continuous("x", 0.0, 1.0, dtype="int8")]),
    distribs.Product([distribs.Continuous("not_a_factor", 0.0, 1.0)]),
], ids=["setminus", "selection", "intersection", "mixture",
        "nested_mixture", "bare_leaf", "float16", "int8", "not_a_factor"])
def test_other_trees_take_the_plain_body(dist):
    assert generators.GenerateSprites(dist, 2)._scene is None


def test_deep_trees_counts_and_empty_scenes_take_the_plain_body():
    deep = distribs.Continuous("x", 0.0, 1.0)
    for _ in range(lr.SCENE_MAX_DEPTH + 1):  # the leaf one too deep
        deep = distribs.Product([deep])
    assert generators.GenerateSprites(deep, 1)._scene is None
    assert generators.GenerateSprites(deep.components[0], 1)._scene \
        is not None

    class Count(generators.RandInt):
        pass

    leaf = distribs.Product([distribs.Continuous("x", 0.0, 1.0)])
    assert generators.GenerateSprites(leaf, Count(0, 3))._scene is None
    assert generators.GenerateSprites(leaf, 0)._scene is None
    assert generators.GenerateSprites(leaf, (1, 4))._scene is not None


def test_the_table_holds_the_draws_bounds_and_the_key_paths():
    """lo and span as `threefry_launch` takes them (float32 lo, the
    float32 difference of the float32 bounds), randint's spans, and each
    leaf's path of component indices through the nested Products."""
    dist = distribs.Product([
        distribs.Continuous("x", 0.1, 0.9),
        distribs.Product([
            distribs.Discrete("shape", ["square", "circle", "star_4"]),
            distribs.Product([
                distribs.Continuous("angle", 0, 360, dtype="int32"),
                distribs.Discrete("scale", [0.1, 0.2], probs=[0.25, 0.75])]),
            distribs.Continuous("c0", 64, 256, dtype="uint8")]),
        distribs.Continuous("y", 0.3, 0.7, dtype="float64")])
    table = generators.GenerateSprites(dist, generators.RandInt(2, 9))._scene
    words, f32 = table.words, table.words.view(np.float32)
    written = sum(1 << c for c in (state_lib.X, state_lib.SHAPE,
                                   state_lib.ANGLE, state_lib.SCALE,
                                   state_lib.C0, state_lib.Y))
    assert list(words[:5]) == [6, 2, 7, 1023 & ~written,
                               state_lib.NUM_FACTORS]
    assert (table.leaves, table.width) == (6, state_lib.NUM_FACTORS)
    assert np.array_equal(f32[5:15], state_lib.DEFAULT_FACTORS)
    recs = words[15:15 + 6 * 16].reshape(6, 16)
    assert [(tuple(r[:3]), tuple(r[8:8 + r[2]])) for r in recs] == [
        ((lr.SCENE_UNIFORM, state_lib.X, 1), (0,)),
        ((lr.SCENE_RANDINT, state_lib.SHAPE, 2), (1, 0)),
        ((lr.SCENE_UNIFORM, state_lib.ANGLE, 3), (1, 1, 0)),
        ((lr.SCENE_CHOICE, state_lib.SCALE, 3), (1, 1, 1)),
        ((lr.SCENE_UNIFORM, state_lib.C0, 2), (1, 2)),
        ((lr.SCENE_UNIFORM, state_lib.Y, 1), (2,))]
    assert not recs[:, 6:8].any() and not any(
        r[8 + r[2]:].any() for r in recs)
    for r, (lo, hi, cast) in zip((0, 2, 4, 5), ((0.1, 0.9, 0), (0, 360, 1),
                                                (64, 256, 3),
                                                (0.3, 0.7, 0))):
        rec = recs[r].view(np.float32)
        want_lo = np.float32(lo)
        want_span = np.float32(np.float64(np.float32(hi)) - np.float64(
            want_lo))
        assert rec[3] == want_lo and rec[4] == want_span, r
        assert (rec[3], rec[4]) == lr.uniform_range(lo, hi)
        assert recs[r][5] == cast
    shape, scale = recs[1], recs[3]
    assert shape[3] == 3 and scale[3] == 2
    assert np.array_equal(f32[shape[4]:shape[4] + 3], [
        constants.ShapeType[n].value for n in ("square", "circle",
                                               "star_4")])
    assert np.array_equal(f32[scale[4]:scale[4] + 2],
                          np.float32([0.1, 0.2]))
    assert np.array_equal(f32[scale[5]:scale[5] + 2],
                          lr.cumulative([0.25, 0.75]))
    assert words.size == 15 + 6 * 16 + 3 + 2 + 2
    # Each leaf's thread: the count's key and randint, T(key, 1), the
    # slot's key, one key a component on its path, its draw.
    assert table.blocks == 6 * 5 + 6 * 2 + (1 + 2 + 3 + 3 + 2 + 1) + (
        1 + 4 + 1 + 1 + 1 + 1)
    # The scene needs the count and T(key, 1) once a lane; the slot's key,
    # the keys of the eight components on the paths ((0), (1), (2), (1,
    # 0), (1, 1), (1, 2), (1, 1, 0), (1, 1, 1)) and the draws once a slot.
    assert (table.lane_blocks, table.slot_blocks) == (5 + 1, 1 + 8 + 9)
    assert table.needed_blocks(2048, 8) == 2048 * (6 + 8 * 18)


def test_the_table_takes_its_row_width_from_the_default_row():
    leaves = [((0,), 2, ("uniform", 0.0, 1.0, "float32")),
              ((1,), 0, ("randint", [1.0, 2.0, 3.0]))]
    table = lr.scene_table((0, 4), leaves, [9.0, 8.0, 7.0, 6.0])
    assert table.width == 4 and table.words[4] == 4
    assert table.words[3] == 0b1010
    assert np.array_equal(table.words.view(np.float32)[5:9],
                          [9.0, 8.0, 7.0, 6.0])
    assert table.words[9 + 16 + 4] == 9 + 2 * 16  # the candidates' word
    keys = lane_keys(4, 6)
    factors, num, ok = table_twin(keys, table, 3)
    assert factors.shape == (6, 3, 4)
    with pytest.raises(ValueError, match="not a factor"):
        lr.scene_table(2, leaves, [0.0, 0.0])
    for row in ([], np.zeros(32), np.zeros((2, 5))):
        with pytest.raises(ValueError, match="1 to 31 factors"):
            lr.scene_table(2, leaves, row)


@pytest.mark.parametrize("name", sorted(leaf_trees()))
@pytest.mark.parametrize("batch,stride", [(1, 1), (7, 3), (64, 2)])
def test_the_table_describes_what_the_plain_body_draws(name, batch, stride):
    dist, count = leaf_trees()[name]
    gen = generators.GenerateSprites(dist, count)
    keys = lane_keys(batch * 31 + stride, batch, stride)
    assert_same_scene(table_twin(keys, gen._scene, gen.max_sprites),
                      gen._sample_plain(keys))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_the_configs_tables_describe_what_their_plain_bodies_draw(config):
    keys = lane_keys(11, 16, 2)
    for gen in generate_sprites_of(CONFIGS[config].get_config("train")[
            "init_sprites"]):
        if gen._scene is not None:
            assert_same_scene(table_twin(keys, gen._scene, gen.max_sprites),
                              gen._sample_plain(keys))


def test_cpu_keys_take_the_plain_body(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the scene mode ran on CPU keys")

    monkeypatch.setattr(lr, "draw_scene", refuse)
    dist, count = leaf_trees()["nested"]
    gen = generators.GenerateSprites(dist, count)
    keys = lane_keys(3, 5)
    assert_same_scene(gen.sample_with_status(keys), gen._sample_plain(keys))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        lr.draw_scene(keys, gen._scene, gen.max_sprites)


def test_a_capture_counts_generate_sprites_by_route(monkeypatch):
    """Sorting's fresh scene evaluates 18 GenerateSprites nodes; on CPU
    keys all take the plain body. A capture starts its census at zero and
    nothing counts off a capture."""
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    gen = sorting.get_config("train")["init_sprites"]
    keys = lane_keys(5, 4)
    for _ in range(2):
        with profiling.capture("fresh") as record:
            gen.sample_with_status(keys)
        assert record.census_table()["generator.GenerateSprites"] == {
            "plain": {"evaluations": 18}}
    gen.sample_with_status(keys)
    assert record.routes == {("GenerateSprites", "plain"): 18,
                             ("Shuffle", "plain"): 1,
                             ("SampleGenerator", "plain"): 1,
                             ("ChainGenerators", "plain"): 9}
    with profiling.capture("two") as record:
        profiling.route("GenerateSprites", "scene")
        profiling.route("GenerateSprites", "scene")
        profiling.route("GenerateSprites", "plain")
    assert record.census_table()["generator.GenerateSprites"] == {
        "plain": {"evaluations": 1}, "scene": {"evaluations": 2}}


def test_the_scene_launch_counts_by_mode_and_census_and_resets(
        monkeypatch):
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    lr.reset_launch_counts()
    with profiling.capture("scene") as record:
        lr._count_launch("scene", 2048 * 22)
        lr._count_launch("scene", 4 * 23)
    assert lr.threefry_launch.launches == 2
    assert lr.threefry_launch.by_mode == {"scene": 2}
    assert record.census_table()["lane_random"] == {
        "scene": {"launches": 2, "blocks": 2048 * 22 + 4 * 23}}
    lr.reset_launch_counts()
    assert lr.threefry_launch.launches == 0
    assert lr.threefry_launch.by_mode == {}


def test_chip_smokes_scene_entry_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's `lane_random_scene` entry, with the table's reading
    standing in for the kernel and the timers doing one call: each
    config's leaf-tree generators held 0 words apart, the bound counted
    from the blocks the scenes need, fewer than the threads compute; a
    scene one bit off fails the check."""
    import chip_smoke

    def once(torch_, fn, reps, spin=False):
        fn()
        return 0.0

    monkeypatch.setattr(chip_smoke, "event_ms", once)
    monkeypatch.setattr(chip_smoke, "graph_ms", once)
    monkeypatch.setattr(lr, "draw_scene", table_twin)
    entry = chip_smoke.time_lane_random_scene(torch, "cpu", 36, 12, lanes=8,
                                              dev="cpu")
    assert entry["name"] == "lane_random_scene"
    assert entry["max_abs_err"] == 0 and entry["launches_per_step"] == 3
    assert {c: (r["scene"], r["generators"], r["words_apart"])
            for c, r in entry["by_config"].items()} == {
        "cobra.sorting": (18, 18, 0),
        "examples.goal_finding_clustering": (4, 6, 0),
        "cobra.goal_finding_new_position": (1, 2, 0)}
    for row in entry["by_config"].values():
        assert 0 < row["blocks_needed"] < row["blocks_computed"]
        assert row["bound_ms"] > 0
    gens = generate_sprites_of(sorting.get_config("train")["init_sprites"])
    assert entry["blocks_needed"] == sum(
        g._scene.needed_blocks(8, g.max_sprites) for g in gens)
    assert entry["bound_ms"] == pytest.approx(1e3 * max(
        110.0 * entry["blocks_needed"] / chip_smoke.FP32_OPS_PER_S,
        sum(8 * (8 + 4 * g.max_sprites * 10 + 5) for g in gens)
        / chip_smoke.HBM_BYTES_PER_S))

    def one_bit_off(keys, table, kmax):
        factors, num, ok = table_twin(keys, table, kmax)
        factors.view(torch.int32)[0, 0, 0] ^= 1
        return factors, num, ok

    monkeypatch.setattr(lr, "draw_scene", one_bit_off)
    with pytest.raises(chip_smoke.SmokeFailure, match="scene mode"):
        chip_smoke.time_lane_random_scene(torch, "cpu", 36, 12, lanes=4,
                                          dev="cpu")


def test_chip_smoke_reads_registers_by_entry_function(monkeypatch,
                                                      tmp_path):
    import chip_smoke
    from spriteworld_torch.ops import _build

    log = tmp_path / "liblane_random.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118"
        "lane_random_kernelEPKjxxiijff' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 26 registers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124"
        "lane_random_scene_kernelEPKjxxiiPKiPfPiPb' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers\n")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: tmp_path / f"lib{name}.so")
    assert chip_smoke.ptxas_lines(_build, "lane_random",
                                  "lane_random_scene_kernel") == (40, 4)
    assert chip_smoke.ptxas_lines(_build, "lane_random",
                                  "lane_random_kernel") == (26, 0)
    assert chip_smoke.ptxas_lines(_build, "lane_random") == (40, 4)
    assert chip_smoke.ptxas_lines(_build, "lane_random", "none") == (
        None, None)


# ---------------------------------------------------------------------- #
# The card: the scene mode against the plain body, bit for bit.

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(leaf_trees()))
@pytest.mark.parametrize("batch,stride", [(1, 1), (7, 3), (2048, 2)])
def test_the_scene_mode_equals_the_plain_body(card, name, batch, stride):
    dist, count = leaf_trees()[name]
    gen = generators.GenerateSprites(dist, count)
    keys = lane_keys(batch * 31 + stride, batch, stride, card)
    assert keys.stride(0) == 2 * stride
    lr.reset_launch_counts()
    got = gen.sample_with_status(keys)
    assert lr.threefry_launch.by_mode == {"scene": 1}
    assert_same_scene(got, gen._sample_plain(keys))


@pytest.mark.cuda
@pytest.mark.parametrize("kmax", range(1, 13))
def test_the_scene_mode_equals_the_plain_body_at_every_slot_count(card,
                                                                  kmax):
    dist, _ = leaf_trees()["nested"]
    keys = lane_keys(kmax, 2048, 1, card)
    for count in (kmax, generators.RandInt(0, kmax + 1)):
        gen = generators.GenerateSprites(dist, count)
        assert gen.max_sprites == kmax
        assert_same_scene(gen.sample_with_status(keys),
                          gen._sample_plain(keys))


@pytest.mark.cuda
def test_the_scene_mode_takes_the_row_width_from_its_table(card):
    leaves = [((0,), 2, ("uniform", 0.25, 0.75, "int32")),
              ((1, 0), 0, ("choice", [1.0, 2.0, 3.0],
                           lr.cumulative([0.5, 0.25, 0.25]))),
              ((1, 1), 3, ("uniform", -2.0, 2.0, "float32"))]
    table = lr.scene_table((0, 4), leaves, [9.0, 8.0, 7.0, 6.0, 5.0])
    keys = lane_keys(21, 2048, 2, card)
    got = lr.draw_scene(keys, table, 3)
    assert got[0].shape == (2048, 3, 5)
    assert_same_scene(got, table_twin(keys.cpu(), table, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("mode", ["train", "test"])
def test_a_configs_init_sprites_equals_its_plain_bodies(card, config, mode):
    import chip_smoke

    fused = CONFIGS[config].get_config(mode)["init_sprites"]
    plain = CONFIGS[config].get_config(mode)["init_sprites"]
    for gen in generate_sprites_of(plain):
        gen._scene = None
    keys = lane_keys(2**31 + 17, 2048, 2, card)
    lr.reset_launch_counts()
    # The composites' plain bodies over the leaves (the tree mode, which
    # draws a whole leaf tree, is held in tests/test_torch_tree_draw.py).
    with chip_smoke.plain_routes(fused), chip_smoke.plain_routes(plain):
        got = fused.sample_with_status(keys)
        scenes = sum(g._scene is not None
                     for g in generate_sprites_of(fused))
        assert lr.threefry_launch.by_mode.get("scene", 0) == scenes
        assert_same_scene(got, plain.sample_with_status(keys))


@pytest.mark.cuda
def test_a_captured_scene_is_one_census_launch(card):
    """In a CUDA graph the scene is one node of the kernel, counted once in
    the census with its blocks and its route; a replay draws what the
    plain body draws from the keys it finds."""
    dist, count = leaf_trees()["randint"]
    gen = generators.GenerateSprites(dist, count)
    keys = lane_keys(9, 256, 1, card).clone()
    gen.sample_with_status(keys)  # loads the library, uploads the table
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with profiling.capture("scene_draw_test") as rec:
            out = gen.sample_with_status(keys)
    census = rec.census_table()
    assert census["lane_random"] == {"scene": {
        "launches": 1, "blocks": 256 * gen.max_sprites * gen._scene.blocks}}
    assert census["generator.GenerateSprites"] == {
        "scene": {"evaluations": 1}}
    if rec.nodes is not None:
        names = [fn for kind, _, fn in rec.nodes if kind == "kernel"]
        assert len(names) == 1 and "lane_random" in (names[0] or "")
    for seed in (1, 2):
        keys.copy_(lane_keys(seed, 256, 1, card))
        graph.replay()
        torch.cuda.synchronize()
        assert_same_scene(out, gen._sample_plain(keys))
