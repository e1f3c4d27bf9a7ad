"""Port parity, the workloads' modules: Embodied, MetaAggregated, the goal
distance's rounding, RandInt/SampleGenerator, the rejecting distributions,
every config, every bench_torch.py builder, and the sorting and embodied
trajectories against the JAX package.

Both packages key every lane with threefry keys that split alike and draw
the same values from them (seeded runs of every config are in
tests/test_torch_seeded_parity.py). Here parity runs on injected scenes
and actions made with numpy (where the lanes' keys agree bit for bit
too), which reach cases a seed rarely draws; samplers are checked through
exact contains-masks and statistics too.
"""

import importlib

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

from spriteworld_torch.core import actions as tactions
from spriteworld_torch.core import distributions as tdistribs
from spriteworld_torch.core import environment as tenvironment
from spriteworld_torch.core import generators as tgenerators
from spriteworld_torch.core import renderers as trenderers
from spriteworld_torch.core import state as tstate
from spriteworld_torch.core import tasks as ttasks
from spriteworld_torch.core.state import StepType
from spriteworld_torch.parallel import ShardedRunner
from spriteworld_torch.ops import lane_random
from spriteworld_torch.parallel import runner as runner_lib

import bench_torch

SQUARE, CIRCLE = 2, 6


def _grid(rng, shape, lo=26, hi=230):
    """Positions on the 1/256 grid: goal distances and moves by multiples
    of 1/16 are exact in float32 in any operation order."""
    return (rng.integers(lo, hi, shape) / 256).astype(np.float32)


def _jspec(f):
    return {n: jnp.asarray(f[..., i])
            for i, n in enumerate(tstate.FACTOR_NAMES)}


# --- goal distance -------------------------------------------------------- #

def test_goal_distance_rounds_each_product_once():
    """Off the grid the port's reward equals a float32 computation that
    rounds each product once, as the TPU does: 50 * (0.05 - sqrt(dx*dx +
    dy*dy)). At this position XLA on the CPU, jitted, contracts the sum into
    an FMA and gives -15.590904 where the port gives -15.590906: the JAX
    package on the CPU is within 2 ulp there, not equal."""
    pos = np.array([[[0.2169918, 0.27456996]]], np.float32)
    f = np.tile(tstate.DEFAULT_FACTORS, (1, 1, 1)).astype(np.float32)
    f[..., 0:2] = pos
    n = np.array([1], np.int32)
    task = ttasks.FindGoalPosition(terminate_distance=0.05)
    got = task.reward(torch.from_numpy(f), torch.from_numpy(n)).numpy()
    d = pos[0, 0] - np.float32(0.5)
    s = np.float32(np.float32(d[0] * d[0]) + np.float32(d[1] * d[1]))
    dist = np.float32(np.sqrt(np.float64(s)))
    want = np.float32(50) * np.float32(np.float32(0.05) - dist)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, [want])
    assert want == np.float32(-15.590906)
    jax_r = np.asarray(jax.jit(jax.vmap(jtasks.FindGoalPosition(
        terminate_distance=0.05).reward))(f, n))
    np.testing.assert_array_max_ulp(got, jax_r, maxulp=2)


# --- Embodied ------------------------------------------------------------- #

def _embodied_states(rng, b, k):
    """Injected scenes: squares at angle 0 (containment of a point well
    inside or well outside is exact on both) and a circular body last.
    Lanes by case: the body on a sprite's centre (carry), far from all
    (no carry), at the frame edge, and empty scenes."""
    f = np.tile(tstate.DEFAULT_FACTORS, (b, k, 1)).astype(np.float32)
    f[..., tstate.SHAPE] = SQUARE
    f[..., tstate.SCALE] = 0.13
    f[..., 0:2] = _grid(rng, (b, k, 2))
    n = rng.integers(2, k + 1, b).astype(np.int32)
    case = np.arange(b) % 4
    for i in range(b):
        body = n[i] - 1
        f[i, body, tstate.SHAPE] = CIRCLE
        f[i, body, tstate.SCALE] = 0.07
        if case[i] == 0:  # on the centre of a random non-body sprite
            f[i, body, 0:2] = f[i, rng.integers(0, body), 0:2]
        elif case[i] == 1:  # far from every other sprite
            f[i, :body, 0:2] = 0.15
            f[i, body, 0:2] = 0.8
        elif case[i] == 2:  # at the edge, sometimes on a sprite
            f[i, body, 0] = 1.0
            f[i, body, 1] = 0.5
            f[i, 0, 0:2] = (1.0, 0.5)
        else:
            n[i] = 0
    return f, n


@pytest.mark.parametrize("keep_in_frame", [True, False])
def test_embodied_step_equals_jax(keep_in_frame):
    rng = np.random.default_rng(keep_in_frame)
    b, k = 256, 5
    f, n = _embodied_states(rng, b, k)
    a = np.stack([rng.integers(0, 2, b), rng.integers(0, 4, b)],
                 -1).astype(np.int32)
    a[2::4, 1] = 3  # right, into the edge
    js = jactions.Embodied(step_size=0.05, motion_cost=0.3)
    want_f, want_c = jax.jit(jax.vmap(
        lambda a_, f_, n_: js.step(a_, f_, n_, keep_in_frame, None)))(a, f, n)
    ts = tactions.Embodied(step_size=0.05, motion_cost=0.3)
    got_f, got_c = ts.step(torch.from_numpy(a), torch.from_numpy(f),
                           torch.from_numpy(n), keep_in_frame, None)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    moved = (got_f.numpy() != f).any(-1)
    body = np.maximum(n - 1, 0)
    lanes = np.arange(b)
    carried = moved.sum(-1) == 2
    assert carried[(lanes % 4 == 0) & (a[:, 0] == 1)].all()
    assert not carried[lanes % 4 == 1].any()
    assert moved[lanes, body][n > 0].all() if not keep_in_frame else \
        moved[lanes, body][(n > 0) & (lanes % 4 != 2)].all()
    assert not moved[n == 0].any()
    sample = ts.sample(lane_random.split(lane_random.key(0), 1000))
    assert sample.dtype == torch.int32 and sample.shape == (1000, 2)
    assert set(sample[:, 0].tolist()) == {0, 1}
    assert set(sample[:, 1].tolist()) == {0, 1, 2, 3}


# --- MetaAggregated ------------------------------------------------------- #

def _meta_subtasks(d, t):
    return [
        t.FindGoalPosition(filter_distrib=d.Continuous("c0", 0.0, 0.3),
                           goal_position=(0.75, 0.75),
                           terminate_distance=0.2),
        t.FindGoalPosition(filter_distrib=d.Continuous("c0", 0.3, 0.6),
                           goal_position=(0.25, 0.25),
                           terminate_distance=0.3,
                           raw_reward_multiplier=20.0),
        t.FindGoalPosition(filter_distrib=d.Continuous("c0", 0.6, 0.7),
                           terminate_distance=0.1),
        t.Clustering([d.Continuous("c0", 0.0, 0.3),
                      d.Continuous("c0", 0.3, 0.6)]),
    ]


@pytest.mark.parametrize("aggregator", ["sum", "max", "min", "mean"])
@pytest.mark.parametrize("criterion", ["all", "any"])
def test_meta_aggregated_equals_jax(aggregator, criterion):
    """Reward, success and valid exactly equal, NaN subtasks (empty goal
    filters) included, on grid positions."""
    rng = np.random.default_rng(len(aggregator) + 7 * len(criterion))
    b, k = 512, 4
    f = np.tile(tstate.DEFAULT_FACTORS, (b, k, 1)).astype(np.float32)
    f[..., 0:2] = _grid(rng, (b, k, 2))
    near = rng.uniform(size=b) < 0.3
    f[near, :, 0:2] = (64 + rng.integers(-6, 7, (near.sum(), k, 2))) / 256
    f[..., tstate.C0] = rng.choice([0.1, 0.4, 0.65, 0.9], (b, k))
    n = rng.integers(0, k + 1, b).astype(np.int32)
    kw = dict(reward_aggregator=aggregator, termination_criterion=criterion,
              terminate_bonus=2.0)
    jt = jtasks.MetaAggregated(_meta_subtasks(jdistribs, jtasks), **kw)
    tt = ttasks.MetaAggregated(_meta_subtasks(tdistribs, ttasks), **kw)
    ft, nt = torch.from_numpy(f), torch.from_numpy(n)
    want_r = np.asarray(jax.vmap(jt.reward)(f, n))
    got_r = tt.reward(ft, nt).numpy()
    np.testing.assert_array_equal(got_r, want_r)  # NaN == NaN here
    assert np.isnan(got_r).any() == (aggregator not in ("sum",))
    np.testing.assert_array_equal(tt.success(ft, nt).numpy(),
                                  np.asarray(jax.vmap(jt.success)(f, n)))
    valid = ttasks.task_valid(tt, ft, nt).numpy()
    np.testing.assert_array_equal(valid,
                                  np.asarray(jax.vmap(jt.valid)(f, n)))
    assert valid.any() and not valid.all()
    with pytest.raises(ValueError, match="reward_aggregator"):
        ttasks.MetaAggregated([], reward_aggregator="median")


# --- generators and distributions ----------------------------------------- #

def _dists(d):
    box = d.Product([d.Continuous("x", 0.2, 0.6), d.Continuous("y", 0.2, 0.6)])
    full = d.Product([d.Continuous("x", 0.1, 0.9),
                      d.Continuous("y", 0.1, 0.9)])
    return {
        "mixture": d.Mixture([d.Continuous("c0", 0.0, 0.2),
                              d.Continuous("c0", 0.7, 0.9)], probs=[0.3, 0.7]),
        "intersection": d.Intersection([d.Continuous("x", 0.0, 0.6),
                                        d.Continuous("x", 0.4, 1.0)],
                                       index_for_sampling=1),
        "setminus": d.SetMinus(full, box),
        "selection": d.Selection(
            d.Product([d.Discrete("shape", ["square", "circle", "star_5"]),
                       d.Continuous("scale", 0.0, 1.0)]),
            d.Discrete("shape", ["circle", "star_5"])),
    }


def _factor_table(rng, n):
    f = rng.uniform(-0.1, 1.1, (n, 10)).astype(np.float32)
    edges = np.array([0.0, 0.1, 0.2, 0.4, 0.6, 0.7, 0.9, 1.0], np.float32)
    pick = rng.uniform(size=(n, 10)) < 0.3
    f[pick] = rng.choice(edges, pick.sum())
    f[:, tstate.SHAPE] = rng.integers(0, 13, n)
    return f


@pytest.mark.parametrize("name", ["mixture", "intersection", "setminus",
                                  "selection"])
def test_rejecting_distributions_equal_jax(name):
    """contains() masks exactly equal to JAX on a shared factor table;
    sampled values satisfy contains with the expected statistics; every
    sample is ok."""
    jd, td = _dists(jdistribs)[name], _dists(tdistribs)[name]
    assert jd.keys == td.keys
    f = _factor_table(np.random.default_rng(len(name)), 4096)
    want = np.asarray(jd.contains(_jspec(f)))
    got = td.contains(tstate.factors_to_dict(torch.from_numpy(f))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)
    spec, ok = td.sample_with_status(
        lane_random.split(lane_random.key(1), (4000,)))
    assert ok.all() and td.contains(spec).all()
    if name == "mixture":
        hi = (spec["c0"] >= 0.7).double().mean()
        assert abs(float(hi) - 0.7) < 0.03
    elif name == "intersection":
        assert abs(float(spec["x"].mean()) - 0.5) < 0.01
    elif name == "setminus":
        # Uniform on the 0.64 - 0.16 = 0.48 area: a quarter of it lies in
        # x > 0.6 with y in the box's band [0.2, 0.6).
        band = ((spec["x"] >= 0.6) & (spec["y"] >= 0.2)
                & (spec["y"] < 0.6)).double().mean()
        assert abs(float(band) - 0.3 * 0.4 / 0.48) < 0.03
    else:
        assert abs(float((spec["shape"] == 6).double().mean()) - 0.5) < 0.04


def test_rejection_exhaustion_sets_ok_false(monkeypatch):
    """An empty support runs out of proposals and reports ok=False, and an
    outer rejection node stops at once on its child's exhaustion."""
    monkeypatch.setattr(tdistribs, "MAX_REJECTION_TRIES", 20)
    empty = tdistribs.SetMinus(tdistribs.Continuous("x", 0.0, 1.0),
                               tdistribs.Continuous("x", 0.0, 1.0))
    spec, ok = empty.sample_with_status(
        lane_random.split(lane_random.key(0), (3, 4)))
    assert spec["x"].shape == (3, 4) and not ok.any()
    calls = []
    orig = empty.sample_with_status

    def counted(key):
        calls.append(tuple(key.shape[:-1]))
        return orig(key)

    empty.sample_with_status = counted
    outer = tdistribs.Selection(empty, tdistribs.Continuous("x", 0.0, 0.5))
    _, ok = outer.sample_with_status(
        lane_random.split(lane_random.key(0), (5,)))
    assert not ok.any() and len(calls) == 1
    # Half the support rejected: everything accepted well within the bound.
    half = tdistribs.SetMinus(tdistribs.Continuous("x", 0.0, 1.0),
                              tdistribs.Continuous("x", 0.0, 0.5))
    spec, ok = half.sample_with_status(
        lane_random.split(lane_random.key(0), (1000,)))
    assert ok.all() and (spec["x"] >= 0.5).all()
    # A dead slot's exhausted draw does not poison the scene.
    gen = tgenerators.GenerateSprites(empty, num_sprites=(0, 2))
    _, num, ok = gen.sample_with_status(
        lane_random.split(lane_random.key(0), 64))
    assert torch.equal(ok, num == 0) and ok.any() and not ok.all()


def test_randint_and_sample_generator():
    """RandInt counts are uniform in [low, high) with dead slots reset to
    defaults; SampleGenerator picks a generator per lane by its
    probabilities and pads to the largest capacity, as JAX does."""
    d = tdistribs.Product([tdistribs.Continuous("x", 0.2, 0.4),
                           tdistribs.Discrete("shape", ["star_5"])])
    keys = lane_random.split(lane_random.key(3), 4000)
    gen = tgenerators.generate_sprites(d,
                                       num_sprites=tgenerators.RandInt(1, 4))
    assert gen.max_sprites == 3
    f, num, ok = gen.sample_with_status(keys[:3000])
    assert ok.all() and set(num.tolist()) == {1, 2, 3}
    assert abs(float(num.double().mean()) - 2.0) < 0.06
    alive = torch.arange(3) < num[:, None]
    default = torch.from_numpy(tstate.DEFAULT_FACTORS)
    assert (f[~alive] == default).all()
    assert (f[alive][:, tstate.SHAPE] == 8).all()
    assert jgenerators.generate_sprites(
        jdistribs.Continuous("x", 0, 1), (1, 4)).max_sprites == 3
    assert tgenerators.generate_sprites(d, (1, 4)).max_sprites == 3
    with pytest.raises(ValueError):
        tgenerators.RandInt(2, 2)

    small = tgenerators.generate_sprites(d, num_sprites=1)
    big = tgenerators.generate_sprites(
        tdistribs.Product([tdistribs.Continuous("x", 0.6, 0.8),
                           tdistribs.Discrete("shape", ["circle"])]), 3)
    pick = tgenerators.sample_generator([small, big], p=[0.25, 0.75])
    assert pick.max_sprites == 3
    f, num, ok = pick.sample_with_status(keys)
    assert ok.all() and f.shape == (4000, 3, 10)
    chose_big = num == 3
    assert set(num.tolist()) == {1, 3}
    assert abs(float(chose_big.double().mean()) - 0.75) < 0.03
    assert (f[~chose_big][:, 1:] == default).all()
    assert (f[~chose_big][:, 0, tstate.SHAPE] == 8).all()
    assert (f[chose_big][..., tstate.SHAPE] == 6).all()


# --- configs -------------------------------------------------------------- #

CONFIGS = [
    ("cobra.exploration", (None,)),
    ("cobra.goal_finding_new_position", ("train", "test")),
    ("cobra.goal_finding_new_shape", ("train", "test")),
    ("cobra.goal_finding_more_targets", ("train", "test")),
    ("cobra.goal_finding_more_distractors", ("train", "test")),
    ("cobra.clustering", ("train", "test")),
    ("cobra.sorting", ("train", "test")),
    ("examples.goal_finding_embodied", (None,)),
    ("examples.goal_finding_clustering", ("train", "test")),
]
FLAT = [(path, mode) for path, modes in CONFIGS for mode in modes]


def _leaf_dists(obj):
    """Every distribution reachable from a generator or task, in order."""
    out = []
    if isinstance(obj, (list, tuple)):
        for x in obj:
            out += _leaf_dists(x)
        return out
    for attr in ("factor_dist", "_filter_distrib"):
        if getattr(obj, attr, None) is not None:
            out.append(getattr(obj, attr))
    for attr in ("gen", "gens", "_subtasks", "_cluster_distribs"):
        if hasattr(obj, attr):
            val = getattr(obj, attr)
            if attr == "_cluster_distribs":
                out += list(val)
            else:
                out += _leaf_dists(val)
    return out


@pytest.mark.parametrize("path,mode", FLAT)
def test_config_structure_equals_jax(path, mode):
    """Each ported config: the same keys, metadata, episode length, action
    space, renderer, task type, capacities, and every distribution with the
    same contains-mask as JAX's; then it runs batched on the CPU, as
    tests/test_configs.py runs the JAX one."""
    jmod = importlib.import_module(f"spriteworld_tpu.configs.{path}")
    tmod = importlib.import_module(f"spriteworld_torch.configs.{path}")
    jc = jmod.get_config(mode) if mode else jmod.get_config()
    tc = tmod.get_config(mode) if mode else tmod.get_config()
    assert set(tc) == set(jc)
    assert tc["metadata"] == jc["metadata"]
    assert tc["max_episode_length"] == jc["max_episode_length"]
    assert type(tc["action_space"]).__name__ == type(
        jc["action_space"]).__name__
    for attr in ("_scale", "_step_size", "_motion_cost"):
        assert getattr(tc["action_space"], attr, None) == getattr(
            jc["action_space"], attr, None)
    it, ij = tc["renderers"]["image"], jc["renderers"]["image"]
    assert it.image_size == ij.image_size
    assert it._anti_aliasing == ij._anti_aliasing
    assert (it._color_to_rgb is None) == (ij._color_to_rgb is None)
    assert type(tc["task"]).__name__ == type(jc["task"]).__name__
    assert tc["init_sprites"].max_sprites == jc["init_sprites"].max_sprites
    td = _leaf_dists([tc["init_sprites"], tc["task"]])
    jd = _leaf_dists([jc["init_sprites"], jc["task"]])
    assert len(td) == len(jd) > 0
    f = _factor_table(np.random.default_rng(len(path)), 2048)
    f[:, tstate.C0:tstate.C2 + 1] *= np.where(
        np.random.default_rng(1).uniform(size=(2048, 1)) < 0.5, 1, 256)
    spec_t = tstate.factors_to_dict(torch.from_numpy(f))
    for a, b in zip(td, jd):
        assert a.keys == b.keys
        np.testing.assert_array_equal(a.contains(spec_t).numpy(),
                                      np.asarray(b.contains(_jspec(f))))

    tc["renderers"] = {"factors": trenderers.SpriteFactors(),
                       "success": trenderers.Success()}
    env = tenvironment.Environment(**tc, device="cpu", seed=0)
    benv = tenvironment.BatchedEnvironment(env, 8)
    state, ts = benv.reset()
    assert state.sample_ok.all()
    for _ in range(3):
        state, ts = benv.step(state, benv.sample_actions())
    assert ts.reward.shape == (8,) and not torch.isinf(ts.reward).any()
    # Every scene the generator draws satisfies the config's distributions.
    assert (state.num_sprites <= env.max_sprites).all()


# --- bench_torch builders ------------------------------------------------- #

@pytest.mark.parametrize("workload", ["all", "demo256"])
def test_bench_builders_construct_and_step(workload):
    """Every bench_torch.py workload builds and steps on the CPU through
    the runner bench_torch.py times (eager here), at a small canvas for
    demo256: every observation leaf of the reset and of the stacked
    timesteps finite, finite metrics, and an image wherever the workload
    renders one."""
    todo = bench_torch.todo_list(workload, None, workload == "demo256")
    assert len(todo) == (7 if workload == "all" else 1)
    for name, aa, exact in todo:
        if name == "demo256":
            env = bench_torch.build_demo_env(anti_aliasing=aa, render_size=16,
                                             pil_exact=exact, device="cpu")
            suffix = "demo"
        else:
            env, suffix, extra = bench_torch.build(name, aa, exact,
                                                   device="cpu")
            assert suffix.endswith("_fast") == (not exact)
        runner = ShardedRunner(env, 3)
        state, ts0 = runner.reset()
        state, m, ts = runner.rollout(state, 2, return_timesteps=True)
        for x in (runner_lib._leaves(ts0.observation)
                  + runner_lib._leaves(ts.observation)):
            assert torch.isfinite(x.float()).all(), (name, suffix)
        assert m.steps == 6 and np.isfinite(m.reward_sum), (name, suffix)
        assert np.isfinite(m.return_sum), (name, suffix)
        assert ("image" in ts.observation) == (name != "factors")


# --- trajectories --------------------------------------------------------- #

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


def _envs(path, scene, action_space):
    """Both engines on a config (train mode), the scene injected, cheap
    observations, and the given action space."""
    out = []
    for pkg, gen, r, acts in (("spriteworld_tpu", _JaxFixed, jrenderers,
                               jactions),
                              ("spriteworld_torch", _TorchFixed, trenderers,
                               tactions)):
        cfg = importlib.import_module(f"{pkg}.configs.{path}").get_config(
            "train")
        cfg["init_sprites"] = gen(scene)
        cfg["renderers"] = {"factors": r.SpriteFactors(),
                            "success": r.Success()}
        cfg["action_space"] = action_space(acts)
        out.append(cfg)
    return (jenvironment.Environment(**out[0]),
            tenvironment.Environment(**out[1], device="cpu"))


def _run_both(jenv, tenv, b, steps, actions_of):
    jstep = jax.jit(jenv.step_batch)
    jst, _ = jax.jit(jenv.reset_batch)(jax.random.split(jax.random.key(0), b))
    tst, _ = tenv.reset_batch(b)
    seen = np.zeros(3, int)
    for t in range(steps):
        a = actions_of(t, np.asarray(jst.factors), np.asarray(jst.num_sprites))
        jst, jts = jstep(jst, jnp.asarray(a))
        tst, tts = tenv.step_batch(tst, torch.from_numpy(a))
        for name in ("step_type", "discount", "reward"):
            np.testing.assert_array_equal(getattr(tts, name).numpy(),
                                          np.asarray(getattr(jts, name)),
                                          f"{name}, t={t}")
        for name in ("factors", "num_sprites", "step_count", "reset_next",
                     "task_valid"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)),
                                          f"{name}, t={t}")
        np.testing.assert_array_equal(tts.observation["success"].numpy(),
                                      np.asarray(jts.observation["success"]))
        # The lanes' keys split as JAX's, success-triggered resets included.
        np.testing.assert_array_equal(
            lane_random.key_data(tst.key),
            np.asarray(jax.random.key_data(jst.key)), f"key, t={t}")
        seen += np.bincount(tts.step_type.numpy(), minlength=3)
    return seen, tts


def test_sorting_trajectory_equals_jax():
    """cobra sorting's task (five FindGoalPosition subtasks under
    MetaAggregated(sum, all)) on an injected two-sprite scene, clicks on
    sprite centres moving by multiples of 1/64: rewards, step types and
    factors exactly equal over several episodes, a success included."""
    rng = np.random.default_rng(5)
    scene = np.tile(tstate.DEFAULT_FACTORS, (2, 1)).astype(np.float32)
    scene[:, tstate.SHAPE] = [SQUARE, 1]
    scene[:, tstate.SCALE] = 0.13
    # Red goes to (0.75, 0.75), blue to (0.75, 0.25).
    scene[:, tstate.C0] = [0.95, 0.6]
    scene[:, 0:2] = [[0.5, 0.5], [0.625, 0.375]]
    jenv, tenv = _envs("cobra.sorting", scene,
                       lambda acts: acts.SelectMove(scale=0.25))
    b = 6
    goals = np.array([[0.75, 0.75], [0.75, 0.25]], np.float32)

    def actions(t, f, n):
        a = (rng.integers(0, 65, (b, 4)) / 64).astype(np.float32)
        pick = rng.integers(0, 2, b)
        a[:, :2] = f[np.arange(b), pick, :2]
        # Lanes 0-1 steer each sprite straight to its goal.
        for lane in (0, 1):
            s = t % 2
            a[lane, :2] = f[lane, s, :2]
            a[lane, 2:] = np.clip((goals[s] - f[lane, s, :2]) / 0.25 + 0.5,
                                  0, 1)
        return a

    seen, ts = _run_both(jenv, tenv, b, 14, actions)
    assert seen[StepType.LAST] > 0 and seen[StepType.FIRST] > 0
    assert np.isfinite(ts.reward.numpy()).all()


def test_embodied_trajectory_equals_jax():
    """goal_finding_embodied's task and scene layout (targets, distractors,
    the body last) on an injected scene of angle-0 squares, with Embodied
    moving by 1/16 (the config's 0.05 leaves the 1/256 grid, where XLA on
    the CPU rounds goal distances differently): rewards, step types and
    factors exactly equal, carries included."""
    rng = np.random.default_rng(8)
    scene = np.tile(tstate.DEFAULT_FACTORS, (4, 1)).astype(np.float32)
    scene[:, tstate.SHAPE] = [SQUARE, SQUARE, SQUARE, CIRCLE]
    scene[:, tstate.SCALE] = [0.13, 0.13, 0.13, 0.07]
    scene[:, tstate.C0] = [0.2, 0.3, 0.7, 1.0]  # 2 targets, 1 distractor
    scene[:, tstate.C1] = [0.8, 0.8, 0.8, 0.0]
    scene[:, tstate.C2] = 1.0
    scene[:, 0:2] = [[0.25, 0.25], [0.75, 0.5], [0.5, 0.75], [0.25, 0.25]]
    jenv, tenv = _envs("examples.goal_finding_embodied", scene,
                       lambda acts: acts.Embodied(step_size=1 / 16))
    b = 8

    def actions(t, f, n):
        a = np.stack([rng.integers(0, 2, b), rng.integers(0, 4, b)], -1)
        a[:4, 0] = 1  # carry
        a[:4, 1] = np.where(t % 4 < 2, 3, 0)  # right, right, up, up
        return a.astype(np.int32)

    seen, ts = _run_both(jenv, tenv, b, 12, actions)
    assert seen[StepType.MID] > 0
