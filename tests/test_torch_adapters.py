"""Port parity, the dm_env adapter: spriteworld_torch's single-env view
against the JAX package's, on the CPU.

Trajectories run from one injected scene (the JAX adapter's state, with
grid-valued positions, copied into the port's through `state_from_numpy`
at B=1) and one list of grid-valued actions; an adapter from a seed is in
tests/test_torch_seeded_parity.py. Tolerances: step types, discounts,
factors and sprite counts exact; rewards exact (grid-valued positions);
anti_aliasing=1 pixels exact; anti_aliasing>1 pixels within +-1.
"""

import unittest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from spriteworld_tpu.adapters import dm_env_adapter as jadapter
from spriteworld_tpu.core import actions as jactions
from spriteworld_tpu.core import distributions as jdistribs
from spriteworld_tpu.core import generators as jgenerators
from spriteworld_tpu.core import renderers as jrenderers
from spriteworld_tpu.core import tasks as jtasks

from spriteworld_torch.adapters import dm_env_adapter as tadapter
from spriteworld_torch.core import actions as tactions
from spriteworld_torch.core import distributions as tdistribs
from spriteworld_torch.core import generators as tgenerators
from spriteworld_torch.core import renderers as trenderers
from spriteworld_torch.core import state as tstate
from spriteworld_torch.core import tasks as ttasks
from spriteworld_torch.ops import lane_random

_JAX = (jactions, jdistribs, jgenerators, jrenderers, jtasks)
_TORCH = (tactions, tdistribs, tgenerators, trenderers, ttasks)


def _config(mods, aa=1, space="select_move", num_sprites=3,
            max_episode_length=6, image=True, extra=None):
    a, d, g, r, t = mods
    dist = d.Product([
        d.Continuous("x", 0.2, 0.8),
        d.Continuous("y", 0.2, 0.8),
        d.Discrete("shape", ["square", "triangle", "star_5", "circle"]),
        d.Discrete("scale", [0.15, 0.2]),
        d.Continuous("c0", 0.0, 1.0),
        d.Continuous("c1", 0.5, 1.0),
        d.Discrete("c2", [1.0]),
    ])
    space = {"select_move": lambda: a.SelectMove(scale=0.25),
             "drag_and_drop": lambda: a.DragAndDrop(scale=0.5),
             "embodied": lambda: a.Embodied(step_size=0.0625)}[space]()
    renderers = {"factors": r.SpriteFactors(),
                 "sprites": r.SpritePassthrough(),
                 "success": r.Success()}
    if image:
        renderers["image"] = r.ImageRenderer(
            (64, 64), anti_aliasing=aa, color_to_rgb="hsv")
    renderers.update(extra or {})
    return dict(
        task=t.FindGoalPosition(filter_distrib=d.Continuous("c0", 0.0, 0.5),
                                terminate_distance=0.1),
        action_space=space, renderers=renderers,
        init_sprites=g.generate_sprites(dist, num_sprites),
        max_episode_length=max_episode_length, metadata={"name": "test"})


def _adapters(seed=0, **kw):
    return (jadapter.Environment(**_config(_JAX, **kw), seed=seed),
            tadapter.Environment(**_config(_TORCH, **kw), seed=seed,
                                 device="cpu"))


def _inject(jenv, tenv, rng):
    """The JAX adapter's first scene, with positions on the 1/256 grid and
    angle 0, as a mid-episode state of both adapters (the port's at B=1)."""
    f = np.array(jenv._state.factors)
    n = int(jenv._state.num_sprites)
    f[:n, 0:2] = rng.integers(64, 193, (n, 2)) / 256
    f[:, 3] = 0.0
    jenv._state = jenv._state.replace(factors=jnp.asarray(f),
                                      reset_next=jnp.bool_(False))
    js = jenv._state
    tenv._state = tstate.state_from_numpy(
        {name: np.asarray(jax.random.key_data(js.key) if name == "key"
                          else getattr(js, name))[None]
         for name in tstate.STATE_FIELDS}, device="cpu")
    return f, n


def _assert_keys_equal(jenv, tenv):
    """The adapters' lane keys and carried keys: JAX's, bit for bit."""
    np.testing.assert_array_equal(
        lane_random.key_data(tenv._state.key[0]),
        np.asarray(jax.random.key_data(jenv._state.key)))
    np.testing.assert_array_equal(
        lane_random.key_data(tenv._key),
        np.asarray(jax.random.key_data(jenv._key)))


def _assert_obs_equal(tobs, jobs, aa):
    assert set(tobs) == set(jobs)
    assert list(tobs["factors"]) == list(jobs["factors"])  # exact
    assert [s.factors for s in tobs["sprites"]] == [
        s.factors for s in jobs["sprites"]]  # exact
    assert tobs["success"] is jobs["success"]
    if "image" in jobs:
        ti = tobs["image"].astype(int)
        ji = np.asarray(jobs["image"]).astype(int)
        assert tobs["image"].dtype == np.uint8 and ti.shape == ji.shape
        # anti_aliasing=1 exact; anti_aliasing>1 within +-1.
        assert np.abs(ti - ji).max() <= (0 if aa == 1 else 1)


def _assert_timesteps_equal(tts, jts, aa):
    assert tts.step_type == jts.step_type  # exact
    assert tts.reward == jts.reward  # exact (None on FIRST)
    assert tts.discount == jts.discount  # exact
    _assert_obs_equal(tts.observation, jts.observation, aa)


def _actions(rng, factors, n, count):
    """Grid actions (multiples of 1/64), most clicks on sprite centres."""
    out = (rng.integers(0, 65, (count, 4)) / 64).astype(np.float32)
    hit = rng.uniform(size=count) < 0.8
    pick = rng.integers(0, n, count)
    out[hit, :2] = factors[pick[hit], :2]
    # Drag toward the frame's centre, so goals are reached.
    out[hit, 2:] = np.where(factors[pick[hit], :2] < 0.5, 0.75, 0.25)
    return out


@pytest.mark.parametrize("aa", [1, 5])
def test_trajectory_on_injected_scene_equals_jax(aa):
    """Steps until LAST from one injected scene: timesteps equal JAX's;
    the port's `observation()`, `state()`, `success()` and
    `should_terminate()` agree with JAX's (anti_aliasing=1) or with the
    port's own timestep (anti_aliasing=5, where each further JAX program
    would compile its own 320x320 render)."""
    rng = np.random.default_rng(aa)
    jenv, tenv = _adapters(aa=aa, max_episode_length=8)
    f, n = _inject(jenv, tenv, rng)
    if aa == 1:
        _assert_obs_equal(tenv.observation(), jenv.observation(), aa)
    steps = 0
    _assert_keys_equal(jenv, tenv)
    for action in _actions(rng, f, n, 8):
        jts, tts = jenv.step(action), tenv.step(action)
        _assert_timesteps_equal(tts, jts, aa)
        _assert_keys_equal(jenv, tenv)
        _assert_obs_equal(tenv.observation(), tts.observation, 1)
        steps += 1
        if aa == 1 or jts.last():
            st, sj = tenv.state(as_sprites=True), jenv.state(as_sprites=True)
            assert [s.factors for s in st["sprites"]] == [
                s.factors for s in sj["sprites"]]
            assert st["global_state"] == sj["global_state"]
            np.testing.assert_array_equal(tenv.state()["sprites"],
                                          jenv.state()["sprites"])
            assert tenv.success() == jenv.success()
            assert tenv.should_terminate() == jenv.should_terminate()
        if jts.last():
            break
    assert 1 < steps
    moved = np.asarray(tenv.state()["sprites"])[:, :2] != f[:n, :2]
    assert moved.any()


def test_specs_equal_jax():
    for kw in ({"space": "select_move"}, {"space": "drag_and_drop"},
               {"space": "embodied"}, {"space": "select_move", "aa": 5}):
        jenv, tenv = _adapters(**kw)
        assert tenv.action_spec() == jenv.action_spec()
        assert type(tenv.action_spec()) is type(jenv.action_spec())
        tspec, jspec = tenv.observation_spec(), jenv.observation_spec()
        assert tspec == jspec
        assert repr(tspec) == repr(jspec)


@pytest.mark.parametrize("space", ["select_move", "drag_and_drop",
                                   "embodied"])
def test_host_action_space_samples_equal_jax_and_validate(space):
    """One seed: the same samples bit for bit; each validates against the
    spec dtype-strictly and steps the port's adapter."""
    jenv, tenv = _adapters(seed=5, space=space, image=False)
    assert tenv.action_space is tenv.action_space
    spec = tenv.action_spec()
    tenv.reset()
    for _ in range(6):
        t, j = tenv.action_space.sample(), jenv.action_space.sample()
        if isinstance(spec, list):
            assert [type(v) for v in t] == [type(v) for v in j]
            assert t == j
            for s, v in zip(spec, t):
                s.validate(v)
        else:
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
            spec.validate(t)
        assert tenv.step(t).step_type is not None


def test_embodied_actions_equal_jax():
    """Embodied int64 actions, cast to int32, carry and move as JAX's."""
    rng = np.random.default_rng(9)
    jenv, tenv = _adapters(space="embodied", max_episode_length=12,
                           image=False)
    f, n = _inject(jenv, tenv, rng)
    for i in range(10):
        action = [np.int64(i % 2), np.int64(rng.integers(0, 4))]
        _assert_timesteps_equal(tenv.step(action), jenv.step(action), 1)
    ts = tenv.step([1, 2])
    assert isinstance(ts.observation["success"], bool)


def test_dm_env_conformance():
    """dm_env's own protocol conformance suite against the port's adapter
    (as tests/test_adapters.py runs it against the JAX one)."""
    from dm_env import test_utils

    class Conformance(test_utils.EnvironmentTestMixin, unittest.TestCase):
        def make_object_under_test(inner_self):
            return tadapter.Environment(**_config(_TORCH, image=False),
                                        seed=0, device="cpu")

        def assertValidObservation(inner_self, observation):
            spec = inner_self.environment.observation_spec()
            for k, v in observation.items():
                if isinstance(spec[k], list):  # per-sprite factor dicts
                    assert len(v) == len(spec[k])
                    continue
                inner_self.assertConformsToSpec(v, spec[k])

        def make_action_sequence(inner_self):
            rng = np.random.default_rng(0)
            for _ in range(8):
                yield rng.uniform(0, 1, 4).astype(np.float32)

    suite = unittest.defaultTestLoader.loadTestsFromTestCase(Conformance)
    result = unittest.TextTestRunner(verbosity=0).run(suite)
    assert result.wasSuccessful(), result.failures + result.errors


def test_episode_cadence_and_sample_contained_position():
    _, tenv = _adapters(image=False, max_episode_length=4)
    rng = np.random.default_rng(1)
    for _ in range(2):
        ts = tenv.reset()
        assert ts.first()
        steps = 0
        while not ts.last():
            ts = tenv.step(rng.uniform(0, 1, 4))
            steps += 1
        assert steps <= 4
    sprites = tenv.state(as_sprites=True)["sprites"]
    for _ in range(10):
        p = tenv.sample_contained_position()
        assert p.shape == (2,)
        assert any(s.contains_point(p) for s in sprites)
    assert tenv.state()["global_state"]["metadata"] == {"name": "test"}


def test_sample_contained_position_matches_the_one_at_a_time_loop():
    """The draws go through the containment test 64 at a time; the point
    returned is the first that a one-at-a-time numpy loop over the same
    seed finds (exact)."""
    from spriteworld_torch.ops import geometry

    _, tenv = _adapters(image=False)
    tenv.reset()
    key = tenv._key.clone()
    got = tenv.sample_contained_position()
    seed = int(lane_random.randint(lane_random.split(key, 2)[1], 1, 0,
                                   2**31 - 1))
    f = tstate.state_to_numpy(tenv._state)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, int(f["num_sprites"][0]))
    verts = geometry.world_vertices(torch.from_numpy(f["factors"][0, idx]))
    lo, hi = verts.min(0).values.numpy(), verts.max(0).values.numpy()
    while True:
        p = rng.uniform(lo, hi)
        if bool(geometry.points_in_polygons(
                verts, torch.from_numpy(p.astype(np.float32)))):
            break
    np.testing.assert_array_equal(got, p)


class _HostReads(TorchFunctionMode):
    """Records every torch call that reads a tensor on the host."""

    _READS = {torch.Tensor.cpu, torch.Tensor.numpy, torch.Tensor.item,
              torch.Tensor.tolist, torch.Tensor.__bool__,
              torch.Tensor.__int__, torch.Tensor.__float__,
              torch.Tensor.__index__, torch.Tensor.nonzero, torch.nonzero}

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self._READS:
            self.reads.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_reset_and_step_read_the_device_once():
    """Every leaf of a timestep (and the state's flags) reaches the host
    in one transfer: one `cpu()` of the gathered buffer a call."""
    _, tenv = _adapters(aa=5)
    for call in (tenv.reset, lambda: tenv.step(
            np.array([0.5, 0.5, 0.6, 0.6], np.float32)), tenv.observation):
        with _HostReads() as mode:
            call()
        assert mode.reads == ["cpu", "numpy"], mode.reads


def _impossible(mods):
    a, d, g, r, t = mods
    return dict(task=t.NoReward(), action_space=a.SelectMove(scale=0.25),
                renderers={},
                init_sprites=g.generate_sprites(d.Product([
                    d.SetMinus(d.Continuous("x", 0.1, 0.9),
                               d.Continuous("x", 0.0, 1.0)),
                    d.Continuous("y", 0.1, 0.9)]), 1),
                max_episode_length=5)


def _clustering(mods, chain):
    a, d, g, r, t = mods
    task = t.Clustering(cluster_distribs=[d.Continuous("c0", 0.0, 0.2),
                                          d.Continuous("c0", 0.5, 0.7)],
                        termination_threshold=2.5)

    def scene(lo, hi, num):
        return g.generate_sprites(d.Product([
            d.Continuous("x", 0.1, 0.9), d.Continuous("y", 0.1, 0.9),
            d.Continuous("c0", lo, hi)]), num)

    sprites = (g.ChainGenerators(scene(0.0, 0.2, 1), scene(0.5, 0.7, 1))
               if chain else scene(0.0, 0.2, 4))
    return dict(task=task, action_space=a.SelectMove(scale=0.25),
                renderers={}, init_sprites=sprites, max_episode_length=5)


@pytest.mark.parametrize("make,match", [
    (_impossible, "Maximum number of tries"),
    (lambda m: _clustering(m, chain=False), "Davies-Bouldin metric does not"),
    (lambda m: _clustering(m, chain=True), "Davies-Bouldin metric does not"),
], ids=["impossible_distribution", "one_cluster", "all_singletons"])
def test_host_side_value_errors_as_jax(make, match, monkeypatch):
    """The two ValueErrors raise where the JAX adapter raises them: an
    over-constrained scene distribution, and a clustering outside
    sklearn's domain (one populated cluster; every cluster a
    singleton).

    The port's half runs under a smaller rejection bound: the CPU twin
    walks the key chain one proposal at a time, and an exhaustion at
    the real bound (test_rejection_bound_is_the_jax_packages) takes
    over a minute."""
    jenv = jadapter.Environment(**make(_JAX), seed=0)
    monkeypatch.setattr(tdistribs, "MAX_REJECTION_TRIES", 1000)
    tenv = tadapter.Environment(**make(_TORCH), seed=0, device="cpu")
    with pytest.raises(ValueError, match=match):
        jenv.reset()
    with pytest.raises(ValueError, match=match):
        tenv.reset()
    with pytest.raises(ValueError, match=match):
        tenv.step([0.5, 0.5, 0.5, 0.5])


def test_rejection_bound_is_the_jax_packages():
    """The bound that test_host_side_value_errors_as_jax shrinks is
    JAX's own."""
    assert (tdistribs.MAX_REJECTION_TRIES == jdistribs.MAX_REJECTION_TRIES
            == 100_000)


def test_adapter_raises_without_a_card_unless_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tadapter.Environment(**_config(_TORCH, image=False))
    env = tadapter.Environment(**_config(_TORCH, image=False), device="cpu")
    assert env._env.device.type == "cpu"
