"""Port parity, engine: distributions, generators, SelectMove, tasks, state,
and whole trajectories against the JAX package.

Both packages key every lane with threefry keys that split alike and draw
the same values from them (`ops.lane_random`; seeded runs of every config
are in tests/test_torch_seeded_parity.py). Here parity runs on injected
scenes and actions made with numpy (where the lanes' keys agree bit for
bit too), which reach cases a seed rarely draws; samplers are checked
through exact contains-masks and statistics too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spriteworld_tpu.core import actions as jactions
from spriteworld_tpu.core import distributions as jdistribs
from spriteworld_tpu.core import environment as jenvironment
from spriteworld_tpu.core import generators as jgenerators
from spriteworld_tpu.core import renderers as jrenderers
from spriteworld_tpu.core import tasks as jtasks
from spriteworld_tpu.core.state import EnvState as JaxEnvState

from spriteworld_torch.core import actions as tactions
from spriteworld_torch.core import distributions as tdistribs
from spriteworld_torch.core import environment as tenvironment
from spriteworld_torch.core import generators as tgenerators
from spriteworld_torch.core import renderers as trenderers
from spriteworld_torch.core import state as tstate
from spriteworld_torch.core import tasks as ttasks
from spriteworld_torch.core.state import StepType
from spriteworld_torch.ops import lane_random

import bench_torch


def _both(make):
    """The same distribution tree built from each package's module."""
    return make(jdistribs), make(tdistribs)


def _goal_finding_dists(d):
    common = d.Product([
        d.Continuous("x", 0.1, 0.9),
        d.Continuous("y", 0.1, 0.9),
        d.Discrete("shape", ["square", "triangle", "circle", "pentagon",
                             "star_5", "spoke_4"]),
        d.Continuous("angle", 0, 360),
        d.Continuous("scale", 0.1, 0.2),
        d.Continuous("c1", 0.3, 1.0),
        d.Continuous("c2", 0.9, 1.0),
    ])
    return d.Product([common, d.Continuous("c0", 0.0, 0.15)])


_DISTS = {
    "continuous": lambda d: d.Continuous("x", 0.25, 0.75),
    "continuous_int": lambda d: d.Continuous("c0", 0, 5, dtype="int32"),
    "discrete_shapes": lambda d: d.Discrete("shape", ["circle", "star_5", 2]),
    "product": _goal_finding_dists,
}


def _factor_table(rng, n):
    """Factor values on and around the distributions' edges."""
    f = np.zeros((n, 10), np.float32)
    edges = np.array([0.0, 0.1, 0.15, 0.25, 0.3, 0.75, 0.9, 1.0, 5.0],
                     np.float32)
    for c in range(10):
        f[:, c] = np.where(rng.uniform(size=n) < 0.3,
                           rng.choice(edges, n), rng.uniform(-0.1, 1.1, n))
    f[:, 2] = rng.integers(0, 13, n)
    f[:, 3] = rng.uniform(-10, 370, n)
    return f


@pytest.mark.parametrize("name", sorted(_DISTS))
def test_contains_masks_equal_jax(name):
    jd, td = _both(_DISTS[name])
    assert jd.keys == td.keys
    f = _factor_table(np.random.default_rng(len(name)), 4096)
    names = tstate.FACTOR_NAMES
    want = np.asarray(jd.contains({n: jnp.asarray(f[:, i])
                                   for i, n in enumerate(names)}))
    got = td.contains(tstate.factors_to_dict(torch.from_numpy(f))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)


def test_sampled_scenes_satisfy_contains_with_uniform_statistics():
    task, gen = bench_torch.goal_finding_parts()
    n = 4096
    factors, num, ok = gen.sample_with_status(
        lane_random.split(lane_random.key(0), n))
    assert factors.shape == (n, 6, 10) and num.tolist() == [6] * n
    assert ok.all()
    target = _goal_finding_dists(tdistribs)
    spec = tstate.factors_to_dict(factors)
    assert target.contains(spec)[:, 0].all()
    assert not target.contains(spec)[:, 1:].any()  # distractor hues
    assert task.filter_mask(factors, num).sum(-1).eq(1).all()
    # Per-factor means of Continuous factors within 4 sigma of uniform.
    for name, lo, hi, sl in [("x", 0.1, 0.9, slice(None)),
                             ("angle", 0, 360, slice(None)),
                             ("scale", 0.1, 0.2, slice(None)),
                             ("c0", 0.0, 0.15, slice(0, 1)),
                             ("c0", 0.2, 0.9, slice(1, None))]:
        v = spec[name][:, sl].double()
        sigma = (hi - lo) / np.sqrt(12) / np.sqrt(v.numel())
        assert abs(float(v.mean()) - (lo + hi) / 2) < 4 * sigma, name
    shapes = torch.bincount(spec["shape"].long().flatten(), minlength=13)
    assert shapes[[1, 2, 3, 6, 8, 10]].min() > 0.9 * n  # ~n each of 6n
    assert shapes.sum() == shapes[[1, 2, 3, 6, 8, 10]].sum()


def test_discrete_probs_and_continuous_int_dtype():
    keys = lane_random.split(lane_random.key(1), 20000)
    d = tdistribs.Discrete("c1", [0.0, 1.0], probs=[0.2, 0.8])
    v = d.sample(keys)["c1"]
    assert abs(float(v.mean()) - 0.8) < 0.02
    c = tdistribs.Continuous("c0", 0, 3, dtype="int32")
    v = c.sample(keys[:1000])["c0"]
    assert set(v.tolist()) == {0.0, 1.0, 2.0}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_order_equals_jax(seed):
    rng = np.random.default_rng(seed)
    f = rng.uniform(size=(64, 7, 10)).astype(np.float32)
    valid = rng.uniform(size=(64, 7)) < 0.6
    want_f, want_n = jax.vmap(jgenerators._pack)(jnp.asarray(f),
                                                 jnp.asarray(valid))
    got_f, got_n = tgenerators._pack(torch.from_numpy(f),
                                     torch.from_numpy(valid))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def _scene_batch(rng, b, k, angle0=True):
    """Factors f32[b, k, 10]. Positions lie on the 1/256 grid, so goal
    distances and moves by grid actions are exact in float32 whatever the
    operation order (XLA on the CPU contracts w0*d0^2 + w1*d1^2 into an
    FMA; the port rounds each product)."""
    f = np.tile(tstate.DEFAULT_FACTORS, (b, k, 1)).astype(np.float32)
    f[..., tstate.X] = rng.integers(51, 205, (b, k)) / 256
    f[..., tstate.Y] = rng.integers(51, 205, (b, k)) / 256
    f[..., tstate.SHAPE] = rng.integers(1, 13, (b, k))
    f[..., tstate.SCALE] = rng.uniform(0.1, 0.3, (b, k))
    if not angle0:
        f[..., tstate.ANGLE] = rng.uniform(0, 360, (b, k))
    f[..., tstate.C0] = rng.uniform(0, 1, (b, k))
    f[..., tstate.C1] = rng.uniform(0.3, 1, (b, k))
    f[..., tstate.C2] = rng.uniform(0.9, 1, (b, k))
    return f


def _grid_actions(rng, b):
    """Actions f32[b, 4] on the 1/64 grid: moves by multiples of 1/256."""
    return (rng.integers(0, 65, (b, 4)) / 64).astype(np.float32)


_jit_select_move = {}


def _jax_select_move(scale, keep_in_frame):
    key = (scale, keep_in_frame)
    if key not in _jit_select_move:
        space = jactions.SelectMove(scale=scale, motion_cost=0.5)
        _jit_select_move[key] = jax.jit(jax.vmap(
            lambda a, f, n: space.step(a, f, n, keep_in_frame, None)))
    return _jit_select_move[key]


@pytest.mark.parametrize("keep_in_frame", [True, False])
@pytest.mark.parametrize("clicks", ["uniform", "centers"])
def test_select_move_equals_jax(keep_in_frame, clicks):
    """Injected scenes and actions: moved factors equal exactly; the cost
    (a norm) within an ulp. Random clicks use angle-0 scenes, whose
    vertices are exact on both; clicks on sprite centers use any angle."""
    rng = np.random.default_rng(keep_in_frame + 2 * (clicks == "centers"))
    b, k = 256, 5
    f = _scene_batch(rng, b, k, angle0=clicks == "uniform")
    n = rng.integers(0, k + 1, b).astype(np.int32)
    a = _grid_actions(rng, b)
    if clicks == "centers":
        pick = rng.integers(0, k, b)
        a[:, :2] = f[np.arange(b), pick, :2]
    want_f, want_c = _jax_select_move(0.25, keep_in_frame)(a, f, n)
    got_f, got_c = tactions.SelectMove(scale=0.25, motion_cost=0.5).step(
        torch.from_numpy(a), torch.from_numpy(f), torch.from_numpy(n),
        keep_in_frame, None)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=2e-7)
    moved = (got_f.numpy() != f).any(-1).any(-1)
    assert 0 < moved.sum() < b


def test_select_move_noise_is_drawn_from_the_generator():
    """The noise is a function of each lane's key: equal keys give equal
    noise, whatever the other lanes."""
    space = tactions.SelectMove(scale=0.25, noise_scale=0.1)
    a = torch.full((8, 4), 0.5)
    keys = lane_random.split(lane_random.key(3), 8)
    n1 = space.apply_noise_to_action(a, keys)
    n2 = space.apply_noise_to_action(a, keys)
    assert torch.equal(n1, n2) and not torch.equal(n1, a)
    n3 = space.apply_noise_to_action(a[:3], keys[5:])
    assert torch.equal(n3, n1[5:])


def _goal_tasks(d, t):
    return {
        "filtered": t.FindGoalPosition(
            filter_distrib=d.Continuous("c0", 0.0, 0.5),
            terminate_distance=0.1),
        "unfiltered_bonus": t.FindGoalPosition(
            terminate_distance=0.2, terminate_bonus=3.0,
            goal_position=(0.4, 0.6), weights_dimensions=(1, 0.5)),
        "sparse": t.FindGoalPosition(
            filter_distrib=d.Continuous("c0", 0.5, 1.0),
            terminate_distance=0.25, sparse_reward=True),
        "no_reward": t.NoReward(),
    }


@pytest.mark.parametrize("name", ["filtered", "unfiltered_bonus", "sparse",
                                  "no_reward"])
def test_goal_tasks_equal_jax(name):
    """Reward and success exactly equal, NaN on an empty filter and vacuous
    success included."""
    jt = _goal_tasks(jdistribs, jtasks)[name]
    tt = _goal_tasks(tdistribs, ttasks)[name]
    rng = np.random.default_rng(len(name))
    b, k = 512, 4
    f = _scene_batch(rng, b, k)
    # Some lanes near the goal, some with an empty filter or no sprites.
    near = rng.uniform(size=b) < 0.3
    f[near, :, 0:2] = (128 + rng.integers(-12, 13, (near.sum(), k, 2))) / 256
    n = rng.integers(0, k + 1, b).astype(np.int32)
    want_r = np.asarray(jax.vmap(jt.reward)(f, n))
    want_s = np.asarray(jax.vmap(jt.success)(f, n))
    ft, nt = torch.from_numpy(f), torch.from_numpy(n)
    got_r = tt.reward(ft, nt).numpy()
    got_s = tt.success(ft, nt).numpy()
    np.testing.assert_array_equal(got_r, want_r)  # NaN == NaN here
    np.testing.assert_array_equal(got_s, want_s)
    if name != "no_reward":
        assert np.isnan(got_r).any() and not np.isnan(got_r).all()
        assert got_s.any() and not got_s.all()
    valid = ttasks.task_valid(tt, ft, nt)
    assert valid.dtype == torch.bool and valid.all()


def test_state_round_trip_and_from_jax():
    rng = np.random.default_rng(0)
    b, k = 5, 3
    d = {
        "factors": _scene_batch(rng, b, k),
        "num_sprites": rng.integers(0, k + 1, b).astype(np.int32),
        "step_count": rng.integers(0, 9, b).astype(np.int32),
        "reset_next": rng.uniform(size=b) < 0.5,
        "key": np.asarray(jax.random.key_data(
            jax.random.split(jax.random.key(0), b))).view(np.int32),
        "sample_ok": np.ones(b, bool),
        "task_valid": rng.uniform(size=b) < 0.8,
    }
    s = tstate.state_from_numpy(d, device="cpu")
    assert s.factors.dtype == torch.float32
    assert s.num_sprites.dtype == torch.int32
    assert s.reset_next.dtype == torch.bool
    back = tstate.state_to_numpy(s)
    assert set(back) == set(tstate.STATE_FIELDS)
    for name, v in d.items():
        np.testing.assert_array_equal(back[name], v)
        assert back[name].dtype == v.dtype
    # Straight from a JAX EnvState (attributes, the typed key as its
    # words).
    js = JaxEnvState(factors=jnp.asarray(d["factors"]),
                num_sprites=jnp.asarray(d["num_sprites"]),
                step_count=jnp.asarray(d["step_count"]),
                reset_next=jnp.asarray(d["reset_next"]),
                key=jax.random.split(jax.random.key(0), b),
                sample_ok=jnp.asarray(d["sample_ok"]),
                task_valid=jnp.asarray(d["task_valid"]))
    s2 = tstate.state_from_numpy(js, device="cpu")
    for name in tstate.STATE_FIELDS:
        assert torch.equal(getattr(s2, name), getattr(s, name))


class _JaxFixed(jgenerators.SpriteGenerator):
    """Injects a fixed scene (as tests/test_environment.py does)."""

    def __init__(self, factors):
        self._factors = np.asarray(factors, np.float32)
        self.max_sprites = self._factors.shape[0]

    def sample(self, key):
        del key
        return jnp.asarray(self._factors), jnp.int32(self.max_sprites)


class _TorchFixed(tgenerators.SpriteGenerator):
    """The same fixed scene for every lane of the port."""

    def __init__(self, factors):
        self._factors = torch.from_numpy(np.asarray(factors, np.float32))
        self.max_sprites = self._factors.shape[0]

    def sample(self, key):
        batch = key.shape[0]
        f = self._factors.to(key.device).expand(batch, -1, -1).clone()
        return f, torch.full((batch,), self.max_sprites, dtype=torch.int32,
                             device=key.device)


def _envs(factors, max_episode_length):
    def make(d, t, a, r, gen, **kw):
        return dict(
            task=t.FindGoalPosition(
                filter_distrib=d.Continuous("c0", 0.0, 0.5),
                terminate_distance=0.075),
            action_space=a.SelectMove(scale=0.25),
            renderers={
                "image": r.ImageRenderer((24, 24), anti_aliasing=5,
                                         color_to_rgb="hsv"),
                "factors": r.SpriteFactors(),
                "success": r.Success()},
            init_sprites=gen(factors),
            max_episode_length=max_episode_length, **kw)

    jenv = jenvironment.Environment(
        **make(jdistribs, jtasks, jactions, jrenderers, _JaxFixed))
    tenv = tenvironment.Environment(
        **make(tdistribs, ttasks, tactions, trenderers, _TorchFixed),
        device="cpu")
    return jenv, tenv


def test_trajectory_parity_with_auto_reset():
    """Same injected angle-0 scene and the same numpy actions through both
    engines over several episodes: step types, discounts, rewards and
    factors exactly equal; AA=5 images within +-1."""
    rng = np.random.default_rng(7)
    b, k = 4, 3
    scene = _scene_batch(rng, 1, k)[0]
    jenv, tenv = _envs(scene, max_episode_length=4)
    jstep = jax.jit(jenv.step_batch)
    jstate, jts = jax.jit(jenv.reset_batch)(
        jax.random.split(jax.random.key(0), b))
    tstate_, tts = tenv.reset_batch(b)
    np.testing.assert_array_equal(tstate_.factors.numpy(),
                                  np.asarray(jstate.factors))
    seen_first = 0
    for t in range(11):
        # Clicks at sprite centers mostly, so sprites move and goals hit.
        a = _grid_actions(rng, b)
        pick = rng.integers(0, k, b)
        hit = rng.uniform(size=b) < 0.7
        a[hit, :2] = np.asarray(jstate.factors)[hit, pick[hit], :2]
        jstate, jts = jstep(jstate, jnp.asarray(a))
        tstate_, tts = tenv.step_batch(tstate_, torch.from_numpy(a))
        np.testing.assert_array_equal(tts.step_type.numpy(),
                                      np.asarray(jts.step_type), f"t={t}")
        np.testing.assert_array_equal(tts.discount.numpy(),
                                      np.asarray(jts.discount))
        np.testing.assert_array_equal(tts.reward.numpy(),
                                      np.asarray(jts.reward))
        np.testing.assert_array_equal(tstate_.factors.numpy(),
                                      np.asarray(jstate.factors))
        np.testing.assert_array_equal(tstate_.step_count.numpy(),
                                      np.asarray(jstate.step_count))
        np.testing.assert_array_equal(tstate_.reset_next.numpy(),
                                      np.asarray(jstate.reset_next))
        # The lanes' keys split as JAX's do, resets included.
        np.testing.assert_array_equal(
            lane_random.key_data(tstate_.key),
            np.asarray(jax.random.key_data(jstate.key)))
        for name in ("success",):
            np.testing.assert_array_equal(tts.observation[name].numpy(),
                                          np.asarray(jts.observation[name]))
        np.testing.assert_array_equal(
            tts.observation["factors"]["factors"].numpy(),
            np.asarray(jts.observation["factors"]["factors"]))
        img_t = tts.observation["image"].numpy().astype(int)
        img_j = np.asarray(jts.observation["image"]).astype(int)
        assert np.abs(img_t - img_j).max() <= 1
        seen_first += int((tts.step_type == StepType.FIRST).sum())
    assert seen_first >= b  # every lane went through >= 2 episodes


def test_first_step_from_initial_state_resets():
    scene = _scene_batch(np.random.default_rng(1), 1, 2)[0]
    _, tenv = _envs(scene, max_episode_length=5)
    state = tenv.initial_state(3)
    assert state.reset_next.all()
    state, ts = tenv.step_batch(state, torch.full((3, 4), 0.5))
    assert (ts.step_type == StepType.FIRST).all()
    assert (ts.reward == 0).all() and (ts.discount == 1).all()
    assert not state.reset_next.any() and (state.step_count == 0).all()


def test_episode_cadence_and_batched_env():
    scene = _scene_batch(np.random.default_rng(2), 1, 2)[0]
    scene[:, tstate.C0] = 0.2  # in the goal filter
    scene[:, tstate.X] = 0.2  # far from the goal: never succeeds
    _, tenv = _envs(scene, max_episode_length=3)
    benv = tenvironment.BatchedEnvironment(tenv, 2)
    state, ts = benv.reset()
    assert ts.step_type.tolist() == [StepType.FIRST] * 2
    seen = []
    noop = torch.tensor([[0.99, 0.99, 0.5, 0.5]] * 2)
    for _ in range(7):
        state, ts = benv.step(state, noop)
        seen.append(int(ts.step_type[0]))
        assert ts.observation["image"].shape == (2, 24, 24, 3)
    assert seen == [StepType.MID, StepType.MID, StepType.LAST,
                    StepType.FIRST, StepType.MID, StepType.MID,
                    StepType.LAST]
    assert benv.sample_actions().shape == (2, 4)
    spec = benv.observation_spec()
    assert spec["image"] == ((24, 24, 3), torch.uint8)
