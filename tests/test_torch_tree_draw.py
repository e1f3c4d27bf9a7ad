"""A generator tree's whole scene in one launch: the `lane_random` kernel's
tree mode (`lane_random.draw_tree`) against the composites' plain bodies
(`_sample_plain` of `Shuffle`, `SampleGenerator` and `ChainGenerators`).

A composite whose whole tree holds only those three classes over
`GenerateSprites` leaves that the scene mode draws takes the tree mode on
CUDA keys. The `cuda` cases hold it bit for bit (`torch.equal`) against the
plain bodies on the card, for every configuration whose root takes it and
for hand-built trees (choices with and without probabilities, dead slots,
nested shuffles, the deepest nesting, ties in a shuffle's uniforms), at 1,
7 and 2,048 lanes with keys read through a stride, and check captured steps'
censuses. They skip without a card; on the card's machine run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tree_draw.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks).
The CPU cases check which roots take the route, the table's layout and
limits, a second reading of the table (`tree_twin`, scalar threefry in
Python over the table's words) against the plain bodies, that CPU keys take
the plain bodies, and the counters.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import chip_smoke
from spriteworld_torch import demo_ui
from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import environment as env_lib
from spriteworld_torch.core import generators
from spriteworld_torch.core import state as state_lib
from spriteworld_torch.ops import lane_random as lr
from spriteworld_torch.utils import profiling

# Every config in each of its modes ("demo": cobra.clustering under the
# interactive demo's overrides), and whether its root takes the tree mode.
CONFIG_MODES = {
    ("cobra.exploration", None): False,
    ("cobra.goal_finding_new_position", "train"): False,
    ("cobra.goal_finding_new_position", "test"): True,
    ("cobra.goal_finding_new_shape", "train"): True,
    ("cobra.goal_finding_new_shape", "test"): True,
    ("cobra.goal_finding_more_targets", "train"): True,
    ("cobra.goal_finding_more_targets", "test"): True,
    ("cobra.goal_finding_more_distractors", "train"): True,
    ("cobra.goal_finding_more_distractors", "test"): True,
    ("cobra.clustering", "train"): True,
    ("cobra.clustering", "test"): True,
    ("cobra.clustering", "demo"): True,
    ("cobra.sorting", "train"): True,
    ("cobra.sorting", "test"): True,
    ("examples.goal_finding_embodied", None): True,
    ("examples.goal_finding_clustering", "train"): False,
    ("examples.goal_finding_clustering", "test"): True,
}
ROUTED = sorted((c, m) for (c, m), routed in CONFIG_MODES.items() if routed)
# A root key whose Shuffle over 12 constant slots draws equal uniforms at
# positions 7 and 9 (found by a search over the keys of seeds 0..2**21).
TIE_SEED = 44513


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the lane_random kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def config_of(config, mode):
    mod = importlib.import_module(f"spriteworld_torch.configs.{config}")
    if mode == "demo":
        return demo_ui.demo_overrides(mod.get_config("train"), 64)
    return mod.get_config(mode) if mode else mod.get_config()


def init_sprites(config, mode):
    return config_of(config, mode)["init_sprites"]


def lane_keys(seed, batch, stride=1, device="cpu"):
    """int32[batch, 2] lane keys from `seed`; with `stride` > 1 a view
    whose lanes lie `stride` keys apart (a slice of a split)."""
    keys = lr.split(lr.key(seed, device), (batch, stride))
    return keys[:, stride - 1]


def assert_same_scene(got, want):
    for g, w, what in zip(got, want, ("factors", "num", "ok")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g.cpu(), w.cpu()), what


# ---------------------------------------------------------------------- #
# A second reading of the table: scalar threefry over its words.

MASK = lr.MASK


def block(k, j):
    """T(k, j) = threefry2x32-20 of the key k = (k0, k1) on (0, j)."""
    k0, k1 = k
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = k0, (j + k1) & MASK
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def bits(k, j):
    x0, x1 = block(k, j)
    return x0 ^ x1


def uniform(b, lo, span):
    """JAX's float32 uniform on [lo, lo + span) of the bits b."""
    f = np.array([(b >> 9) | 0x3F800000], np.uint32).view(np.float32) - 1
    v = lr._fma_f32(torch.from_numpy(f), float(span), float(lo))
    return max(np.float32(lo), np.float32(v.item()))


def randint_offset(k, span):
    """JAX's randint offset in [0, span) of the key k at counter 0."""
    a, b = bits(block(k, 0), 0), bits(block(k, 1), 0)
    m = (1 << 16) % span
    m = ((m * m) & MASK) % span
    return ((((a % span) * m) & MASK) + b % span & MASK) % span


def choice(k, cum):
    """JAX's choice over the float32 cumulative sums `cum`."""
    u = uniform(bits(k, 0), 0.0, 1.0)
    target = (np.float32(1) - u) * cum[-1]
    i = 0
    while i < len(cum) - 1 and cum[i] < target:
        i += 1
    return i


CASTS = {1: torch.int32, 2: torch.int64, 3: torch.uint8}


def leaf_rows(words, at, key):
    """The live rows of the leaf whose scene table starts at word `at`."""
    f32 = words.view(np.float32)
    records, lo, span, _, width = (int(w) for w in words[at:at + 5])
    count = lo + (randint_offset(block(key, 0), span & MASK) if span else 0)
    sprites = block(key, 1)
    rows = []
    for slot in range(count):
        row = f32[at + 5:at + 5 + width].copy()
        for r in range(records):
            rec = words[at + 5 + width + r * lr.SCENE_RECORD:][
                :lr.SCENE_RECORD]
            op, column, depth, a, b, c = (int(w) for w in rec[:6])
            k = block(sprites, slot)
            for index in rec[8:8 + depth]:
                k = block(k, int(index))
            if op == lr.SCENE_UNIFORM:
                v = uniform(bits(k, 0), *rec[3:5].view(np.float32))
                if c:
                    v = torch.tensor([v]).to(CASTS[c]).float().item()
            elif op == lr.SCENE_RANDINT:
                v = f32[at + b + randint_offset(k, a)]
            else:
                v = f32[at + b + choice(k, f32[at + c:at + c + a])]
            row[column] = v
        rows.append(row)
    return rows


def tree_twin(keys, table):
    """The scenes that `table` describes, read from its words lane by lane:
    (factors, num, ok) as `draw_tree` returns them."""
    words, f32 = table.words, table.words.view(np.float32)
    nodes, kmax, width, _ = (int(w) for w in words[:lr.TREE_HEADER])
    default = f32[lr.TREE_HEADER:lr.TREE_HEADER + width]
    first = lr.TREE_HEADER + width

    def rows_of(node, key):
        kind, n, at, cum = (int(w) for w in words[
            first + node * lr.TREE_RECORD:][:lr.TREE_RECORD])
        if kind == lr.TREE_LEAF:
            return leaf_rows(words, at, key)
        children = [int(c) for c in words[at:at + n]]
        if kind == lr.TREE_CHAIN:
            return [row for i, c in enumerate(children)
                    for row in rows_of(c, block(key, i))]
        if kind == lr.TREE_SAMPLE:
            k = block(key, 0)
            c = randint_offset(k, n) if cum < 0 else choice(
                k, f32[cum:cum + n])
            return rows_of(children[c], block(key, 1))
        assert kind == lr.TREE_SHUFFLE
        rows = rows_of(children[0], block(key, 0))
        order = block(key, 1)
        u = [uniform(bits(order, j), 0.0, 1.0) for j in range(len(rows))]
        return [rows[j] for j in sorted(range(len(rows)),
                                        key=lambda j: (u[j], j))]

    assert 0 < nodes and words.size > first + nodes * lr.TREE_RECORD
    factors = np.tile(default, (keys.shape[0], kmax, 1))
    num = []
    for lane, k in enumerate(lr.key_data(keys)):
        rows = rows_of(0, (int(k[0]), int(k[1])))
        if rows:
            factors[lane, :len(rows)] = rows
        num.append(len(rows))
    return (torch.from_numpy(factors), torch.tensor(num, dtype=torch.int32),
            torch.ones(keys.shape[0], dtype=torch.bool))


# ---------------------------------------------------------------------- #
# Hand-built trees.

def leaf(count, hue=(0.0, 1.0), nested=False):
    """A GenerateSprites whose Product draws every leaf kind."""
    parts = [distribs.Continuous("x", 0.1, 0.9),
             distribs.Continuous("c0", *hue),
             distribs.Discrete("shape", ["square", "triangle", "circle"]),
             distribs.Discrete("scale", [0.1, 0.2, 0.3],
                               probs=[0.2, 0.5, 0.3]),
             distribs.Continuous("angle", 0, 360, dtype="int32")]
    if nested:
        parts = [distribs.Product(parts[:2]),
                 distribs.Product([distribs.Product(parts[2:4]),
                                   parts[4]])]
    return generators.GenerateSprites(distribs.Product(parts), count)


def hand_trees():
    """{name: root}: choices with and without probabilities, branches of
    different slots, RandInt counts that leave dead slots, nested shuffles,
    a choice inside a chain, an empty Product, and the deepest nesting."""
    a, b = leaf(1, (0.0, 0.3)), leaf(generators.RandInt(0, 3), (0.5, 0.9))
    c = leaf(2, nested=True)
    deep = leaf(generators.RandInt(1, 4))
    for i in range(lr.TREE_MAX_DEPTH):
        deep = (generators.Shuffle(deep) if i % 2 else
                generators.ChainGenerators(deep, leaf(1)))
    return {
        "p_given": generators.Shuffle(generators.SampleGenerator([
            generators.ChainGenerators(a, b), c,
            generators.ChainGenerators(
                c, generators.Shuffle(leaf(generators.RandInt(1, 4))))],
            p=[0.3, 0.2, 0.5])),
        "p_none": generators.SampleGenerator([
            generators.ChainGenerators(a, b, a), c, b]),
        "p_zero": generators.SampleGenerator([a, c, b], p=[0.0, 1.0, 0.0]),
        "choice_in_chain": generators.ChainGenerators(
            generators.SampleGenerator([a, b]),
            generators.Shuffle(generators.ChainGenerators(c, b)),
            generators.GenerateSprites(distribs.Product([]), 2)),
        "deepest": deep,
        "ties": generators.Shuffle(generators.ChainGenerators(
            leaf(5), leaf(7, (0.5, 0.6)))),
    }


# ---------------------------------------------------------------------- #
# CPU: the route, the table, the twin, the counters.

@pytest.mark.parametrize("config,mode", sorted(
    CONFIG_MODES, key=lambda cm: (cm[0], str(cm[1]))))
def test_which_roots_take_the_tree_mode(config, mode):
    """Roots of leaf trees take the tree mode; goal finding's and the
    compositional example's train modes hold a SetMinus leaf and keep the
    plain bodies; exploration's root is a lone GenerateSprites, which keeps
    the scene mode."""
    root = init_sprites(config, mode)
    if config == "cobra.exploration":
        assert type(root) is generators.GenerateSprites
        assert not hasattr(root, "_tree") and root._scene is not None
        return
    assert (root._tree is not None) == CONFIG_MODES[(config, mode)]
    if root._tree is None:
        assert any(g._scene is None
                   for g in chip_smoke.generate_sprites_of(root))


def rejection_leaf():
    return generators.GenerateSprites(distribs.Product([distribs.SetMinus(
        distribs.Continuous("x", 0.0, 1.0),
        distribs.Continuous("x", 0.4, 0.6))]), 1)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_a_rejection_leaf_at_any_depth_refuses_the_tree(depth):
    node = rejection_leaf()
    for i in range(depth):
        node = (generators.ChainGenerators(leaf(1), node) if i % 2 == 0
                else generators.SampleGenerator([leaf(2), node]))
    root = generators.Shuffle(node)
    assert root._tree is None
    inner = generators.Shuffle(generators.ChainGenerators(leaf(1), leaf(2)))
    assert generators.ChainGenerators(inner, node)._tree is None
    assert inner._tree is not None


def test_more_than_32_slots_refuse_the_tree():
    assert generators.ChainGenerators(leaf(20), leaf(12))._tree is not None
    assert generators.ChainGenerators(leaf(20), leaf(13))._tree is None
    assert generators.ChainGenerators(
        leaf(generators.RandInt(0, 33)), leaf(1))._tree is None
    assert generators.Shuffle(generators.SampleGenerator(
        [leaf(32), leaf(33)]))._tree is None
    assert generators.Shuffle(generators.SampleGenerator(
        [leaf(32), leaf(3)]))._tree.kmax == 32


def test_subclasses_of_composites_refuse_the_tree():
    class Chain(generators.ChainGenerators):
        pass

    class Shuffled(generators.Shuffle):
        pass

    class Sample(generators.SampleGenerator):
        pass

    assert Chain(leaf(1), leaf(2))._tree is None
    assert Shuffled(leaf(2))._tree is None
    assert Sample([leaf(2)])._tree is None
    assert generators.Shuffle(Chain(leaf(1), leaf(2)))._tree is None
    assert generators.Shuffle(generators.ChainGenerators(leaf(1), leaf(2))
                              )._tree is not None


def test_nesting_and_children_past_the_limits_refuse_the_tree():
    node = leaf(1)
    for _ in range(lr.TREE_MAX_DEPTH):
        node = generators.Shuffle(node)
    assert node._tree is not None
    assert generators.Shuffle(node)._tree is None
    many = [leaf(1) for _ in range(lr.TREE_MAX_CHILDREN)]
    assert generators.SampleGenerator(many)._tree is not None
    assert generators.SampleGenerator(many + [leaf(1)])._tree is None
    assert generators.ChainGenerators(*many)._tree is not None


def test_tree_table_raises_past_the_kernels_limits():
    one = ("leaf", leaf(1)._scene, 1)
    deep = one
    for _ in range(lr.TREE_MAX_DEPTH + 1):
        deep = ("shuffle", deep)
    with pytest.raises(ValueError, match="nest past"):
        lr.tree_table(deep, state_lib.DEFAULT_FACTORS)
    with pytest.raises(ValueError, match="children"):
        lr.tree_table(("chain", []), state_lib.DEFAULT_FACTORS)
    with pytest.raises(ValueError, match="slots"):
        lr.tree_table(("chain", [("leaf", leaf(20)._scene, 20)] * 2),
                      state_lib.DEFAULT_FACTORS)
    with pytest.raises(ValueError, match="rows differ"):
        lr.tree_table(("shuffle", one), np.zeros(10, np.float32))
    with pytest.raises(ValueError, match="rows differ"):
        lr.tree_table(("shuffle", one), state_lib.DEFAULT_FACTORS[:9])
    with pytest.raises(ValueError, match="2 probabilities for 3"):
        lr.tree_table(("sample", [one] * 3, lr.cumulative([0.5, 0.5])),
                      state_lib.DEFAULT_FACTORS)
    assert generators.SampleGenerator([leaf(1)] * 3,
                                      p=[0.5, 0.5])._tree is None


def test_the_table_holds_the_nodes_in_preorder():
    a, b = leaf(1), leaf(generators.RandInt(0, 3), nested=True)
    root = generators.Shuffle(generators.SampleGenerator(
        [generators.ChainGenerators(a, b), a], p=[0.25, 0.75]))
    table = root._tree
    words, f32 = table.words, table.words.view(np.float32)
    width = state_lib.NUM_FACTORS
    assert list(words[:4]) == [6, 3, width, 5]
    assert (table.kmax, table.width) == (3, width)
    assert np.array_equal(f32[4:4 + width], state_lib.DEFAULT_FACTORS)
    base = 4 + width + 6 * lr.TREE_RECORD
    recs = words[4 + width:base].reshape(6, lr.TREE_RECORD)
    at_a, at_b = base + 7, base + 7 + a._scene.words.size
    assert recs.tolist() == [
        [lr.TREE_SHUFFLE, 1, base, -1],
        [lr.TREE_SAMPLE, 2, base + 1, base + 3],
        [lr.TREE_CHAIN, 2, base + 5, -1],
        [lr.TREE_LEAF, 0, at_a, -1],
        [lr.TREE_LEAF, 0, at_b, -1],
        [lr.TREE_LEAF, 0, at_a, -1]]
    assert list(words[base:base + 3]) == [1, 2, 5]
    assert np.array_equal(f32[base + 3:base + 5], lr.cumulative([0.25, 0.75]))
    assert list(words[base + 5:base + 7]) == [3, 4]
    # One copy of a leaf's scene table however many nodes hold it.
    assert np.array_equal(words[at_a:at_b], a._scene.words)
    assert np.array_equal(words[at_b:], b._scene.words)


def test_the_table_counts_the_blocks_of_the_chosen_branch():
    """Sorting (train): the Shuffle's child key, its order key and two
    uniforms; the choice (T(key, 0), randint's four) and the chosen
    child's key; the chain's two part keys; each leaf's sprites' key and
    its one slot's seven records (1 + path + draw each: 3, 3, 3, 6, 6, 3,
    3). A scene needs the slot's key and its seven components' keys once:
    1 + 7 + 13 draws a slot."""
    table = init_sprites("cobra.sorting", "train")._tree
    leaf_blocks = 1 + (3 + 3 + 3 + 6 + 6 + 3 + 3)
    assert table.blocks == pytest.approx(4 + 6 + 2 * (1 + leaf_blocks))
    assert table.lane_needed == pytest.approx(4 + 6 + 2 * (1 + 1 + 21))
    assert table.needed_blocks(2048) == 2048 * table.lane_needed
    # A RandInt(0, 3) count draws its count (5 blocks) and 1 live slot on
    # average; a uniform choice over two branches takes half of each.
    b = leaf(generators.RandInt(0, 3))
    per_slot = 3 + 3 + 6 + 3 + 3
    assert generators.ChainGenerators(b)._tree.blocks == 1 + 5 + 1 + per_slot
    a = leaf(2)
    assert generators.SampleGenerator([a, b])._tree.blocks == pytest.approx(
        6 + 0.5 * (1 + 2 * per_slot) + 0.5 * (5 + 1 + per_slot))


def test_the_twins_threefry_is_jaxs():
    keys = lane_keys(7, 5)
    for k, want in zip(lr.key_data(keys), lr.key_data(lr.fold_in(keys, 3))):
        assert block((int(k[0]), int(k[1])), 3) == tuple(int(w)
                                                        for w in want)


@pytest.mark.parametrize("config,mode", ROUTED)
def test_the_table_describes_what_the_plain_bodies_draw(config, mode):
    root = init_sprites(config, mode)
    keys = lane_keys(len(config) * 7 + 2**31 + 3, 12, 2)
    assert_same_scene(tree_twin(keys, root._tree), root._sample_plain(keys))


@pytest.mark.parametrize("name", sorted(hand_trees()))
def test_hand_built_tables_describe_what_the_plain_bodies_draw(name):
    root = hand_trees()[name]
    keys = lane_keys(len(name) * 101, 16, 3)
    if name == "ties":
        keys = torch.cat([keys, lr.key(TIE_SEED)[None]])
    assert_same_scene(tree_twin(keys, root._tree), root._sample_plain(keys))


def test_the_tie_key_ties_and_the_lower_position_goes_first():
    key = (0, TIE_SEED)
    order = block(key, 1)
    u = [uniform(bits(order, j), 0.0, 1.0) for j in range(12)]
    assert u[7] == u[9] and len(set(u)) == 11
    root = hand_trees()["ties"]
    factors, _, _ = root._sample_plain(lr.key(TIE_SEED)[None])
    inner, _, _ = root.gen.sample_with_status(
        lr.split(lr.key(TIE_SEED)[None], 2)[:, 0])
    rank = sorted(range(12), key=lambda j: (u[j], j))
    assert rank.index(7) + 1 == rank.index(9)
    assert torch.equal(factors[0], inner[0, rank])


def test_dead_slots_and_choices_show_in_the_hand_built_scenes():
    keys = lane_keys(5, 64)
    _, num, _ = hand_trees()["p_given"]._sample_plain(keys)
    assert num.min() < 5 and num.max() == 5
    _, num, _ = hand_trees()["p_zero"]._sample_plain(keys)
    assert (num == 2).all()


def test_cpu_keys_take_the_plain_bodies(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the tree mode ran on CPU keys")

    monkeypatch.setattr(lr, "draw_tree", refuse)
    root = init_sprites("cobra.sorting", "train")
    keys = lane_keys(3, 5)
    assert_same_scene(root.sample_with_status(keys), root._sample_plain(keys))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        lr.draw_tree(keys, root._tree)


def test_a_capture_counts_the_composites_by_route(monkeypatch):
    """On CPU keys sorting's composites take their plain bodies: one
    Shuffle, one SampleGenerator, nine ChainGenerators; the tree route is
    counted where the root launches."""
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    root = init_sprites("cobra.sorting", "train")
    with profiling.capture("fresh") as record:
        root.sample_with_status(lane_keys(5, 4))
    census = record.census_table()
    assert census["generator.Shuffle"] == {"plain": {"evaluations": 1}}
    assert census["generator.SampleGenerator"] == {
        "plain": {"evaluations": 1}}
    assert census["generator.ChainGenerators"] == {
        "plain": {"evaluations": 9}}
    monkeypatch.setattr(lr, "draw_tree", lambda keys, table: None)
    with profiling.capture("tree") as record:
        generators._tree_or_plain(root, types.SimpleNamespace(is_cuda=True))
    assert record.routes == {("Shuffle", "tree"): 1}


def test_the_tree_launch_counts_by_mode_and_census_and_resets(monkeypatch):
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    lr.reset_launch_counts()
    with profiling.capture("tree") as record:
        lr._count_launch("tree", 2048 * 68)
    assert lr.threefry_launch.launches == 1
    assert lr.threefry_launch.by_mode == {"tree": 1}
    assert record.census_table()["lane_random"] == {
        "tree": {"launches": 1, "blocks": 2048 * 68}}
    lr.reset_launch_counts()
    assert lr.threefry_launch.by_mode == {}


def test_chip_smokes_tree_entry_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's `lane_random_tree` entry, with the table's reading
    standing in for the kernel and the timers doing one call: every routed
    config's tree held 0 words apart from the plain bodies, the bound from
    the blocks the chosen branches need; a scene one bit off fails."""
    def once(torch_, fn, reps, spin=False):
        fn()
        return 0.0

    monkeypatch.setattr(chip_smoke, "event_ms", once)
    monkeypatch.setattr(chip_smoke, "graph_ms", once)
    monkeypatch.setattr(lr, "draw_tree", tree_twin)
    entry = chip_smoke.time_lane_random_tree(torch, "cpu", 2, 36, 12,
                                             lanes=4, dev="cpu")
    assert entry["name"] == "lane_random_tree"
    assert entry["max_abs_err"] == 0 and entry["launches_per_step"] == 2 / 12
    assert entry["scene_launches_per_step"] == 3
    assert set(entry["by_config"]) == {
        f"{c}.{m}" if m else c for c, m in chip_smoke.TREE_CONFIGS}
    for row in entry["by_config"].values():
        assert row["words_apart"] == 0 and row["bound_ms"] > 0
        assert 0 < row["blocks_needed"] <= row["blocks_computed"]
    head = init_sprites(*chip_smoke.TREE_CONFIGS[0])._tree
    assert entry["blocks_needed"] == head.needed_blocks(4)

    def one_bit_off(keys, table):
        factors, num, ok = tree_twin(keys, table)
        factors.view(torch.int32)[0, 0, 0] ^= 1
        return factors, num, ok

    monkeypatch.setattr(lr, "draw_tree", one_bit_off)
    with pytest.raises(chip_smoke.SmokeFailure, match="tree mode"):
        chip_smoke.time_lane_random_tree(torch, "cpu", 0, 0, 1, lanes=2,
                                         dev="cpu")


# ---------------------------------------------------------------------- #
# The card: the tree mode against the plain bodies, bit for bit.

@pytest.mark.cuda
@pytest.mark.parametrize("config,mode", ROUTED)
@pytest.mark.parametrize("batch,stride", [(1, 1), (7, 3), (2048, 2)])
def test_the_tree_mode_equals_the_plain_bodies(card, config, mode, batch,
                                               stride):
    root = init_sprites(config, mode)
    keys = lane_keys(batch * 31 + stride + 2**31, batch, stride, card)
    assert keys.stride(0) == 2 * stride
    lr.reset_launch_counts()
    got = root.sample_with_status(keys)
    assert lr.threefry_launch.by_mode == {"tree": 1}
    with chip_smoke.plain_routes(root):
        assert_same_scene(got, root.sample_with_status(keys))
    with chip_smoke.plain_routes(root, leaves=True):
        assert_same_scene(got, root.sample_with_status(keys))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(hand_trees()))
@pytest.mark.parametrize("batch,stride", [(1, 1), (7, 3), (2048, 2)])
def test_hand_built_trees_equal_their_plain_bodies(card, name, batch,
                                                   stride):
    root = hand_trees()[name]
    keys = lane_keys(batch * 17 + stride, batch, stride, card)
    if name == "ties":
        keys = torch.cat([lr.key(TIE_SEED, card)[None], keys])
    got = lr.draw_tree(keys, root._tree)
    with chip_smoke.plain_routes(root, leaves=True):
        assert_same_scene(got, root.sample_with_status(keys))
    if batch < 2048:
        assert_same_scene(got, tree_twin(keys.cpu(), root._tree))


def captured_step(card, config, lanes=64):
    """The census of one captured `step_batch` of `config` (train mode)."""
    env = env_lib.Environment(**config_of(config, "train"), device=card)
    state, _ = env.reset_batch(lanes)
    actions = env.sample_action(env.lane_keys(lanes))
    env.step_batch(state, actions)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    pending = torch.zeros((), dtype=torch.bool, device=card)
    with torch.cuda.graph(graph), distribs.defer_rejection(pending):
        with profiling.capture("tree_draw_test") as rec:
            new, _ = env.step_batch(state, actions)
    graph.replay()
    torch.cuda.synchronize()
    return rec, env, new


@pytest.mark.cuda
def test_a_captured_sorting_step_draws_its_scene_in_one_tree_launch(card):
    rec, env, new = captured_step(card, "cobra.sorting")
    census = rec.census_table()
    assert census["lane_random"]["tree"]["launches"] == 1
    assert "scene" not in census["lane_random"]
    assert census["generator.Shuffle"] == {"tree": {"evaluations": 1}}
    assert not any(k in census for k in (
        "generator.SampleGenerator", "generator.ChainGenerators",
        "generator.GenerateSprites"))
    if rec.nodes is not None:
        names = [fn or "" for kind, _, fn in rec.nodes if kind == "kernel"]
        assert sum("lane_random_tree" in n for n in names) == 1
        assert not any("lane_random_scene" in n for n in names)


@pytest.mark.cuda
def test_goal_findings_captured_step_keeps_its_routes(card):
    """Goal finding's root holds a SetMinus leaf: its composites keep their
    plain bodies, its distractor the scene mode, and nothing launches the
    tree mode."""
    rec, _, _ = captured_step(card, "cobra.goal_finding_new_position")
    census = rec.census_table()
    assert "tree" not in census["lane_random"]
    assert census["lane_random"]["scene"]["launches"] == 1
    assert census["generator.Shuffle"] == {"plain": {"evaluations": 1}}
    assert census["generator.ChainGenerators"] == {
        "plain": {"evaluations": 1}}
    assert census["generator.GenerateSprites"] == {
        "plain": {"evaluations": 1}, "scene": {"evaluations": 1}}
