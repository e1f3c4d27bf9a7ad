"""Port parity, clustering slice: Davies-Bouldin, the Clustering task,
DragAndDrop, Shuffle, the cobra clustering config, and a trajectory with
the interactive demo's overrides, against the JAX package.

Inputs are made with numpy from a seed and fed to both packages. Positions
on the 1/256 grid with two members per cluster keep every distance exact in
float32 whatever the operation order, so those comparisons are exact; other
memberships and positions are compared within rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spriteworld_tpu.configs.cobra import clustering as jclustering
from spriteworld_tpu.core import actions as jactions
from spriteworld_tpu.core import distributions as jdistribs
from spriteworld_tpu.core import environment as jenvironment
from spriteworld_tpu.core import generators as jgenerators
from spriteworld_tpu.core import renderers as jrenderers
from spriteworld_tpu.core import tasks as jtasks
from spriteworld_tpu.ops import clustering as jclustering_ops

from spriteworld_torch.configs.cobra import clustering as tclustering
from spriteworld_torch.core import actions as tactions
from spriteworld_torch.core import distributions as tdistribs
from spriteworld_torch.core import environment as tenvironment
from spriteworld_torch.core import generators as tgenerators
from spriteworld_torch.core import state as tstate
from spriteworld_torch.core import tasks as ttasks
from spriteworld_torch.core.state import StepType
from spriteworld_torch.ops import clustering as tclustering_ops
from spriteworld_torch.ops import lane_random

import bench_torch

_jax_db = jax.jit(jax.vmap(jclustering_ops.davies_bouldin_index))


def _db_both(pos, member):
    want = np.asarray(_jax_db(jnp.asarray(pos), jnp.asarray(member)))
    got = tclustering_ops.davies_bouldin_index(
        torch.from_numpy(pos), torch.from_numpy(member)).numpy()
    return got, want


def _random_membership(rng, b, k, c):
    """bool[b, k, c]: each point in at most one cluster, some in none."""
    label = rng.integers(-1, c, (b, k))
    return label[..., None] == np.arange(c)


def test_davies_bouldin_random_memberships_equal_jax():
    """Any member counts. Grid positions make every centroid one correctly
    rounded division on both sides; what is left is the order of float32
    sums and XLA's FMA contraction of the squared norms."""
    rng = np.random.default_rng(0)
    b, k, c = 512, 8, 3
    pos = (rng.integers(0, 257, (b, k, 2)) / 256).astype(np.float32)
    member = _random_membership(rng, b, k, c)
    got, want = _db_both(pos, member)
    np.testing.assert_allclose(got, want, rtol=1e-6)  # NaN where JAX's is
    present = member.any(1).sum(-1)
    assert np.isnan(got[present < 2]).all()
    assert np.isfinite(got[present >= 2]).all() and (present >= 2).any()


def test_davies_bouldin_grid_two_per_cluster_exact():
    rng = np.random.default_rng(1)
    b, c = 256, 3
    pos = (rng.integers(0, 257, (b, 2 * c, 2)) / 256).astype(np.float32)
    member = (np.arange(2 * c)[:, None] // 2 == np.arange(c))[None]
    member = np.broadcast_to(member, (b, 2 * c, c)).copy()
    got, want = _db_both(pos, member)
    np.testing.assert_array_equal(got, want)


def _degenerate(case):
    """(positions f32[1, 4, 2], member bool[1, 4, 2], expected DB)."""
    pos = np.array([[[0.1, 0.2], [0.3, 0.4], [0.6, 0.6], [0.9, 0.1]]],
                   np.float32)
    two = np.array([[[1, 0], [1, 0], [0, 1], [0, 1]]], bool)
    if case == "one_cluster":
        return pos, np.array([[[1, 0], [1, 0], [1, 0], [0, 0]]], bool), np.nan
    if case == "no_members":
        return pos, np.zeros((1, 4, 2), bool), np.nan
    if case == "singletons":  # every intra-cluster distance is 0
        return pos, np.array([[[1, 0], [0, 1], [0, 0], [0, 0]]], bool), 0.0
    if case == "zero_intra":  # members of each cluster coincide
        pos = pos.copy()
        pos[0, 1] = pos[0, 0]
        pos[0, 3] = pos[0, 2]
        return pos, two, 0.0
    if case == "same_centroids":  # all centroid distances are 0
        pos = np.array([[[0.2, 0.5], [0.8, 0.5], [0.5, 0.2], [0.5, 0.8]]],
                       np.float32)
        return pos, two, 0.0
    raise ValueError(case)


@pytest.mark.parametrize("case", ["one_cluster", "no_members", "singletons",
                                  "zero_intra", "same_centroids"])
def test_davies_bouldin_degenerate_cases_equal_jax(case):
    pos, member, expected = _degenerate(case)
    got, want = _db_both(pos, member)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.float32([expected]))


def _cluster_dists(d):
    return [d.Continuous(*jclustering.CLUSTERS_DISTS[name])
            for name in ("blue", "green", "red")]


def _clustering_tasks(d, t):
    return {
        "dense": t.Clustering(_cluster_dists(d)[:2], reward_range=10.0),
        "sparse_bonus": t.Clustering(_cluster_dists(d), sparse_reward=True,
                                     terminate_bonus=2.0,
                                     termination_threshold=1.5),
    }


def _cluster_scenes(rng, b, k, grid_pairs):
    """Factors f32[b, k, 10] with hues in, between and on the edges of the
    cluster ranges. With `grid_pairs`, two sprites per blue/green cluster on
    the 1/256 grid (exact distances); else any hues and positions."""
    f = np.tile(tstate.DEFAULT_FACTORS, (b, k, 1)).astype(np.float32)
    if grid_pairs:
        f[..., tstate.X] = rng.integers(26, 231, (b, k)) / 256
        f[..., tstate.Y] = rng.integers(26, 231, (b, k)) / 256
        hues = np.array([0.6, 0.6, 0.3, 0.3], np.float32)
        f[..., tstate.C0] = hues[rng.permuted(np.tile(np.arange(4), (b, 1)),
                                             axis=1)]
    else:
        f[..., tstate.X] = rng.uniform(0.1, 0.9, (b, k))
        f[..., tstate.Y] = rng.uniform(0.1, 0.9, (b, k))
        edges = np.array([0.27, 0.37, 0.55, 0.65, 0.9, 0.95, 0.5],
                         np.float32)
        f[..., tstate.C0] = np.where(rng.uniform(size=(b, k)) < 0.3,
                                     rng.choice(edges, (b, k)),
                                     rng.uniform(0.2, 1.0, (b, k)))
    return f


@pytest.mark.parametrize("name", ["dense", "sparse_bonus"])
@pytest.mark.parametrize("grid_pairs", [True, False])
def test_clustering_task_equals_jax(name, grid_pairs):
    jt = _clustering_tasks(jdistribs, jtasks)[name]
    tt = _clustering_tasks(tdistribs, ttasks)[name]
    rng = np.random.default_rng(len(name) + 2 * grid_pairs)
    b = 512
    k = 4 if grid_pairs else 6
    f = _cluster_scenes(rng, b, k, grid_pairs)
    n = (np.full(b, k, np.int32) if grid_pairs
         else rng.integers(0, k + 1, b).astype(np.int32))
    ft, nt = torch.from_numpy(f), torch.from_numpy(n)
    want_r = np.asarray(jax.vmap(jt.reward)(f, n))
    want_s = np.asarray(jax.vmap(jt.success)(f, n))
    want_v = np.asarray(jax.vmap(jt.valid)(f, n))
    got_r = tt.reward(ft, nt).numpy()
    got_s = tt.success(ft, nt).numpy()
    got_v = ttasks.task_valid(tt, ft, nt).numpy()
    np.testing.assert_array_equal(got_v, want_v)
    if grid_pairs:
        np.testing.assert_array_equal(got_r, want_r)
        np.testing.assert_array_equal(got_s, want_s)
        assert got_v.all()
    else:
        np.testing.assert_allclose(got_r, want_r, rtol=1e-6, atol=1e-5)
        # Success flips only within float error of the threshold.
        assert (got_s != want_s).sum() <= 1
        assert got_v.any() and not got_v.all()
        # Rewards are finite wherever the task is valid.
        assert np.isfinite(got_r[got_v]).all()
    assert got_s.any() or name == "dense"


_jit_drag = {}


def _jax_drag_and_drop(keep_in_frame):
    if keep_in_frame not in _jit_drag:
        space = jactions.DragAndDrop(scale=0.5, motion_cost=0.5)
        _jit_drag[keep_in_frame] = jax.jit(jax.vmap(
            lambda a, f, n: space.step(a, f, n, keep_in_frame, None)))
    return _jit_drag[keep_in_frame]


@pytest.mark.parametrize("keep_in_frame", [True, False])
def test_drag_and_drop_equals_jax(keep_in_frame):
    """Clicks on sprite centres (any angle) or anywhere (angle 0), targets
    on the 1/64 grid: moved factors exactly equal, the cost within an
    ulp."""
    rng = np.random.default_rng(3 + keep_in_frame)
    b, k = 256, 4
    f = _cluster_scenes(rng, b, k, grid_pairs=True)
    f[..., tstate.SHAPE] = rng.integers(1, 4, (b, k))
    f[..., tstate.SCALE] = 0.13
    n = rng.integers(0, k + 1, b).astype(np.int32)
    a = (rng.integers(0, 65, (b, 4)) / 64).astype(np.float32)
    centre = rng.uniform(size=b) < 0.7
    pick = rng.integers(0, k, b)
    a[centre, :2] = f[np.arange(b), pick][centre, :2]
    want_f, want_c = _jax_drag_and_drop(keep_in_frame)(a, f, n)
    got_f, got_c = tactions.DragAndDrop(scale=0.5, motion_cost=0.5).step(
        torch.from_numpy(a), torch.from_numpy(f), torch.from_numpy(n),
        keep_in_frame, None)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=2e-7)
    moved = (got_f.numpy() != f).any(-1).any(-1)
    assert 0 < moved.sum() < b


class _RaggedRows(tgenerators.SpriteGenerator):
    """Rows numbered 1..k in column x; lane b has b % (k + 1) live rows."""

    def __init__(self, k):
        self.max_sprites = k

    def sample_with_status(self, key):
        k, batch = self.max_sprites, key.shape[0]
        f = tstate.default_factors((batch, k), key.device)
        num = (torch.arange(batch, device=key.device) % (k + 1)).to(
            torch.int32)
        live = torch.arange(k) < num[:, None]
        f[..., tstate.X] = torch.where(
            live, torch.arange(1, k + 1, dtype=torch.float32), f[..., 0])
        return f, num, torch.ones(batch, dtype=torch.bool)


def test_shuffle_permutes_the_live_prefix_uniformly():
    k, b = 3, 4000
    gen = tgenerators.shuffle(_RaggedRows(k))
    assert gen.max_sprites == k
    f, num, ok = gen.sample_with_status(
        lane_random.split(lane_random.key(0), b))
    assert ok.all() and num.tolist() == [i % (k + 1) for i in range(b)]
    x = f[..., tstate.X]
    live = torch.arange(k) < num[:, None]
    for lane in range(b):
        m = int(num[lane])
        # A permutation of the live rows; dead rows stay default and last.
        assert sorted(x[lane, :m].tolist()) == list(range(1, m + 1))
        assert (f[lane, m:] == torch.from_numpy(tstate.DEFAULT_FACTORS)).all()
    assert (x[~live] == tstate.DEFAULT_FACTORS[tstate.X]).all()
    # Every order of three live rows appears about b / 4 / 6 times.
    full = x[num == k]
    orders, counts = torch.unique(full, dim=0, return_counts=True)
    assert len(orders) == 6
    expect = len(full) / 6
    assert (counts - expect).abs().max() < 5 * np.sqrt(expect)


def _factor_table(rng, n):
    f = np.tile(tstate.DEFAULT_FACTORS, (n, 1)).astype(np.float32)
    edges = np.array([0.1, 0.13, 0.2, 0.27, 0.3, 0.37, 0.55, 0.65, 0.9, 1.0],
                     np.float32)
    for c in range(10):
        f[:, c] = np.where(rng.uniform(size=n) < 0.3, rng.choice(edges, n),
                           rng.uniform(-0.1, 1.1, n))
    f[:, tstate.SHAPE] = rng.integers(0, 13, n)
    return f


@pytest.mark.parametrize("mode", ["train", "test"])
def test_cobra_clustering_config_equals_jax(mode):
    jc = jclustering.get_config(mode)
    tc = tclustering.get_config(mode)
    assert set(tc) == set(jc)
    assert tc["metadata"] == jc["metadata"]
    assert tc["max_episode_length"] == jc["max_episode_length"] == 50
    assert type(tc["action_space"]) is tactions.SelectMove
    assert tc["action_space"]._scale == jc["action_space"]._scale == 0.25
    img_t, img_j = tc["renderers"]["image"], jc["renderers"]["image"]
    assert img_t.image_size == img_j.image_size == (64, 64)
    assert img_t._anti_aliasing == img_j._anti_aliasing == 5
    tt, jt = tc["task"], jc["task"]
    assert isinstance(tt, ttasks.Clustering)
    for attr in ("_num_clusters", "_termination_threshold",
                 "_terminate_bonus", "_sparse_reward", "_reward_range"):
        assert getattr(tt, attr) == getattr(jt, attr), attr
    # Every distribution of the config: the same contains-masks.
    tg, jg = tc["init_sprites"], jc["init_sprites"]
    assert isinstance(tg, tgenerators.Shuffle)
    assert tg.max_sprites == jg.max_sprites == 4
    dists = [(td.factor_dist, jd.factor_dist)
             for td, jd in zip(tg.gen.gens, jg.gen.gens)]
    dists += list(zip(tt._cluster_distribs, jt._cluster_distribs))
    f = _factor_table(np.random.default_rng(len(mode)), 4096)
    spec_t = tstate.factors_to_dict(torch.from_numpy(f))
    spec_j = {n: jnp.asarray(f[:, i])
              for i, n in enumerate(tstate.FACTOR_NAMES)}
    for td, jd in dists:
        assert td.keys == jd.keys
        np.testing.assert_array_equal(td.contains(spec_t).numpy(),
                                      np.asarray(jd.contains(spec_j)))
    # Sampled scenes: two sprites of each cluster, in a shuffled z-order.
    factors, num, ok = tg.sample_with_status(
        lane_random.split(lane_random.key(0), 2048))
    assert ok.all() and (num == 4).all()
    member = tt.membership(factors, num)
    assert (member.sum(1) == 2).all()
    first = member[:, 0].int().argmax(-1)
    assert 0.4 < float(first.float().mean()) < 0.6
    spec = tstate.factors_to_dict(factors)
    assert (spec["scale"] == np.float32(0.13)).all()
    assert set(spec["shape"].unique().tolist()) == {1.0, 2.0, 6.0}
    assert ttasks.task_valid(tt, factors, num).all()


class _JaxFixed(jgenerators.SpriteGenerator):
    def __init__(self, factors):
        self._factors = np.asarray(factors, np.float32)
        self.max_sprites = self._factors.shape[0]

    def sample(self, key):
        del key
        return jnp.asarray(self._factors), jnp.int32(self.max_sprites)


class _TorchFixed(tgenerators.SpriteGenerator):
    def __init__(self, factors):
        self._factors = torch.from_numpy(np.asarray(factors, np.float32))
        self.max_sprites = self._factors.shape[0]

    def sample(self, key):
        batch = key.shape[0]
        f = self._factors.to(key.device).expand(batch, -1, -1).clone()
        return f, torch.full((batch,), self.max_sprites, dtype=torch.int32,
                             device=key.device)


def _demo_envs(scene, render_size, anti_aliasing, max_episode_length):
    """Both engines on the cobra clustering config with the demo's
    overrides (demo_ui.setup_run_ui), the scene injected."""
    jc = jclustering.get_config("train")
    jc["action_space"] = jactions.DragAndDrop(scale=0.5)
    jc["renderers"] = {
        "image": jrenderers.ImageRenderer(
            image_size=(render_size, render_size),
            anti_aliasing=anti_aliasing, color_to_rgb="hsv"),
        "success": jrenderers.Success(),
    }
    tc = bench_torch.demo_config("train", render_size, anti_aliasing)
    for c, gen in ((jc, _JaxFixed), (tc, _TorchFixed)):
        c["init_sprites"] = gen(scene)
        c["max_episode_length"] = max_episode_length
    return (jenvironment.Environment(**jc),
            tenvironment.Environment(**tc, device="cpu"))


def test_demo_clustering_trajectory_equals_jax():
    """The same injected scene and numpy actions through both engines over
    several episodes: step types, discounts, rewards, success, task_valid
    and factors exactly equal; images within +-1 (the JAX Lanczos sums in
    float32)."""
    rng = np.random.default_rng(9)
    b, k = 4, 4
    scene = _cluster_scenes(rng, 1, k, grid_pairs=True)[0]
    scene[:, tstate.SHAPE] = [1, 2, 6, 2]
    scene[:, tstate.SCALE] = 0.13
    scene[:, tstate.C1] = 0.8
    scene[:, tstate.C2] = 0.95
    jenv, tenv = _demo_envs(scene, 24, 3, max_episode_length=4)
    jstep = jax.jit(jenv.step_batch)
    jst, jts = jax.jit(jenv.reset_batch)(jax.random.split(jax.random.key(0),
                                                          b))
    tst, tts = tenv.reset_batch(b)
    seen_first = 0
    for t in range(11):
        a = (rng.integers(0, 65, (b, 4)) / 64).astype(np.float32)
        pick = rng.integers(0, k, b)
        hit = rng.uniform(size=b) < 0.8
        a[hit, :2] = np.asarray(jst.factors)[hit, pick[hit], :2]
        jst, jts = jstep(jst, jnp.asarray(a))
        tst, tts = tenv.step_batch(tst, torch.from_numpy(a))
        for name in ("step_type", "discount", "reward"):
            np.testing.assert_array_equal(getattr(tts, name).numpy(),
                                          np.asarray(getattr(jts, name)),
                                          f"{name}, t={t}")
        for name in ("factors", "step_count", "reset_next", "task_valid"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)),
                                          f"{name}, t={t}")
        np.testing.assert_array_equal(tts.observation["success"].numpy(),
                                      np.asarray(jts.observation["success"]))
        img_t = tts.observation["image"].numpy().astype(int)
        img_j = np.asarray(jts.observation["image"]).astype(int)
        assert img_t.shape == (b, 24, 24, 3)
        assert np.abs(img_t - img_j).max() <= 1
        seen_first += int((tts.step_type == StepType.FIRST).sum())
    assert seen_first >= b
    assert np.isfinite(tts.reward.numpy()).all()
