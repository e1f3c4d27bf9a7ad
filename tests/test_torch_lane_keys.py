"""Per-lane random keys in the port (`spriteworld_torch.ops.lane_random`
and the EnvState's `key`), against the JAX package's key contract.

(a) The plain twins of `key`, `split`, `fold_in`, `bits` and `uniform`
    equal `jax.random`'s bit for bit over seeds drawn with numpy, and
    `normal` is XLA's float32 ErfInv32 (the card's kernel is held against
    the same twins by chip_smoke.py's phase 12: CUDA has no interpret
    mode; randint, choice and the rejection chain are held to JAX in
    tests/test_torch_seeded_parity.py).
(b) Key flow: the JAX package's and the port's BatchedEnvironment from one
    seed, stepped with the same actions on goal finding and sorting with
    auto-resets, carry equal lane keys at every step, and equal factors:
    the samplers draw JAX's values from the keys. The task's success is
    masked off in both, so that episodes end at max_episode_length alone
    and every lane resets several times (tests/test_torch_seeded_parity.py
    runs the configs' own tasks from a seed).
(c) A step is a function of its state: `step_batch` and `step` on a copy
    give equal states and timesteps, resetting lanes and SelectMove's
    noise included.
(d) A lane is a function of its key: lanes of a 16-lane batch equal the
    same lane keys stepped in a batch of their own, with host-checked
    rejection and with rejection deferred and re-run.
(e) and (f), the rollout on any mesh and the cross-topology resume, are
    in tests/test_torch_mesh.py, beside the gloo ranks they run on.
(g) A JAX package checkpoint restores with its keys, and the restored
    lanes step on with JAX's key flow.
(h) The draws' statistics: uniform and normal by Kolmogorov-Smirnov,
    randint's frequencies.
"""

import importlib

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

from spriteworld_tpu.core import environment as jenvironment
from spriteworld_tpu.core import renderers as jrenderers
from spriteworld_tpu.parallel import checkpoint as jcheckpoint

from spriteworld_torch.core import environment as tenvironment
from spriteworld_torch.core import renderers as trenderers
from spriteworld_torch.core import state as tstate
from spriteworld_torch.ops import lane_random
from spriteworld_torch.parallel import restore_state

import bench_torch
import chip_smoke

_SEEDS = [int(s) for s in np.random.default_rng(2024).integers(
    -2**31, 2**31, 12)] + [0, 1, 2**31 - 1, -1]


def _words(jax_keys):
    return np.asarray(jax.random.key_data(jax_keys))


# ---------------------------------------------------------------------- #
# (a) the plain twins against jax.random.

@pytest.mark.parametrize("seed", _SEEDS)
def test_key_split_fold_in_equal_jax(seed):
    k = jax.random.key(seed)
    t = lane_random.key(seed)
    np.testing.assert_array_equal(lane_random.key_data(t), _words(k))
    for n in (1, 2, 3, 17):
        np.testing.assert_array_equal(
            lane_random.key_data(lane_random.split(t, n)),
            _words(jax.random.split(k, n)))
    np.testing.assert_array_equal(
        lane_random.key_data(lane_random.split(t, (2, 3))),
        _words(jax.random.split(k, (2, 3))))
    for d in (0, 1, 7, 12345, 2**32 - 1):
        np.testing.assert_array_equal(
            lane_random.key_data(lane_random.fold_in(t, d)),
            _words(jax.random.fold_in(k, d)))


@pytest.mark.parametrize("seed", _SEEDS[:6])
def test_batched_keys_equal_jax_per_lane(seed):
    """Each lane of a batch of keys (leading axes [3, 5]) takes JAX's
    split, fold_in, bits and uniform of that lane's key; a `start`
    splits the lanes of a longer split."""
    keys = lane_random.split(lane_random.key(seed), (3, 5))
    jkeys = jax.random.wrap_key_data(lane_random.key_data(keys))
    split = lane_random.split(keys, 4, start=3)
    want = jax.vmap(jax.vmap(lambda k: jax.random.split(k, 7)[3:]))(jkeys)
    np.testing.assert_array_equal(lane_random.key_data(split), _words(want))
    first = lane_random.split(keys, 4, start=3, counters_first=True)
    assert torch.equal(first, split.movedim(-2, 0))
    np.testing.assert_array_equal(
        lane_random.key_data(lane_random.fold_in(keys, 9)),
        _words(jax.vmap(jax.vmap(lambda k: jax.random.fold_in(k, 9)))(
            jkeys)))
    bits = lane_random.bits(keys, 11).numpy().view(np.uint32)
    want = jax.vmap(jax.vmap(lambda k: jax.random.bits(
        k, (11,), jnp.uint32)))(jkeys)
    np.testing.assert_array_equal(bits, np.asarray(want))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.2, 0.8), (-3.0, 5.5),
                                   (0.1, 0.2), (1e-3, 7.0), (-1e6, 3e-4),
                                   (0, 360)])
def test_uniform_equals_jax(lo, hi):
    """JAX's mantissa construction and scale, bit for bit (XLA fuses the
    scale into one multiply-add; the twin rounds once too)."""
    for seed in _SEEDS[:8]:
        got = lane_random.uniform(lane_random.key(seed), 64, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jax.random.key(seed), (64,),
                                             jnp.float32, lo, hi))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        assert (got >= np.float32(lo)).all() and (got < np.float32(hi)).all()


def test_normal_is_jax_construction_in_float64():
    """The normal's construction, JAX's uniform on [nextafter(-1, 0), 1)
    through float32(sqrt 2) * XLA's float32 ErfInv32, its log1p taken in
    float64 and rounded once: exactly a numpy float32 evaluation of
    ErfInv32 (fused multiply-adds rounded once through float64) on JAX's
    own uniform draws, and within 3 float32 ulp of jax.random.normal on
    the CPU, whose float32 log1p is XLA's own."""
    for seed in _SEEDS[:6]:
        got = lane_random.normal(lane_random.key(seed), 256).numpy()
        want = np.asarray(jax.random.normal(jax.random.key(seed), (256,)))
        np.testing.assert_array_max_ulp(got, want, maxulp=3)
        u = np.asarray(jax.random.uniform(
            jax.random.key(seed), (256,), jnp.float32,
            np.nextafter(np.float32(-1), np.float32(0)), 1.0))
        f32 = np.float32
        w = -f32(np.log1p(np.float64(u * -u)))
        lt = w < 5
        w = np.where(lt, w - f32(2.5), f32(np.sqrt(np.float64(w))) - f32(3))
        coef = [np.where(lt, f32(a), f32(b)) for a, b in zip(
            lane_random._ERFINV_LT5, lane_random._ERFINV_GE5)]
        p = coef[0]
        for c in coef[1:]:
            # A float32 fused multiply-add: the product is exact in
            # float64, and a float64 sum rounded to float32 is the FMA but
            # where it rounds twice across a tie (checked by the equality).
            p = f32(np.float64(p) * np.float64(w) + np.float64(c))
        exact = f32(np.sqrt(2)) * (p * u)
        np.testing.assert_array_equal(got, exact)


def test_key_rules_and_the_wrapper_on_the_cpu():
    """Seeds outside int32 split into words; the kernel wrapper refuses
    CPU keys (the CPU takes the twin); bad key shapes raise."""
    big = 2**40 + 5
    np.testing.assert_array_equal(lane_random.key_data(lane_random.key(big)),
                                  np.array([256, 5], np.uint32))
    with pytest.raises(ValueError):
        lane_random.key(2**64)
    keys = lane_random.split(lane_random.key(0), 4)
    with pytest.raises(ValueError, match="CUDA keys"):
        lane_random.threefry_launch(keys, 2, lane_random.KEYS)
    with pytest.raises(ValueError, match="int32"):
        lane_random.as_key(torch.zeros(3, dtype=torch.int32), "cpu")
    with pytest.raises(ValueError, match="uint32"):
        lane_random.fold_in(keys, -1)
    back = lane_random.wrap_key_data(lane_random.key_data(keys))
    assert torch.equal(back, keys) and back.dtype == torch.int32


# ---------------------------------------------------------------------- #
# (b) key flow against the JAX package's environment.

class _Unreachable:
    """A task whose success never fires (its reward is the task's own):
    episodes end at max_episode_length alone, whatever the scene."""

    def __init__(self, task, zeros):
        self._task = task
        self._zeros = zeros

    def reward(self, factors, num_sprites):
        return self._task.reward(factors, num_sprites)

    def success(self, factors, num_sprites):
        return self._zeros(num_sprites)


def _key_flow_envs(path):
    out = []
    for pkg, r, zeros in (
            ("spriteworld_tpu", jrenderers,
             lambda n: jnp.zeros(jnp.shape(n), bool)),
            ("spriteworld_torch", trenderers,
             lambda n: torch.zeros(n.shape, dtype=torch.bool,
                                   device=n.device))):
        cfg = importlib.import_module(f"{pkg}.configs.{path}").get_config(
            "train")
        cfg["task"] = _Unreachable(cfg["task"], zeros)
        cfg["renderers"] = {"success": r.Success()}
        cfg["max_episode_length"] = 5
        out.append(cfg)
    return (jenvironment.Environment(**out[0]),
            tenvironment.Environment(**out[1], device="cpu"))


@pytest.mark.parametrize("path", ["cobra.goal_finding_new_position",
                                  "cobra.sorting"])
def test_key_flow_equals_the_jax_environment(path):
    """30 steps of 8 lanes from one seed with the same actions: the
    port's lane keys equal JAX's at every step, through auto-resets."""
    jenv, tenv = _key_flow_envs(path)
    lanes = 8
    jbenv = jenvironment.BatchedEnvironment(jenv, lanes)
    tbenv = tenvironment.BatchedEnvironment(tenv, lanes)
    jstate, _ = jbenv.reset(jax.random.key(17))
    tstate_, _ = tbenv.reset(17)
    np.testing.assert_array_equal(lane_random.key_data(tstate_.key),
                                  _words(jstate.key))
    rng = np.random.default_rng(3)
    firsts = 0
    for t in range(30):
        a = rng.uniform(0, 1, (lanes, 4)).astype(np.float32)
        jstate, jts = jbenv.step(jstate, jnp.asarray(a))
        tstate_, tts = tbenv.step(tstate_, a)
        np.testing.assert_array_equal(tts.step_type.numpy(),
                                      np.asarray(jts.step_type), f"t={t}")
        np.testing.assert_array_equal(lane_random.key_data(tstate_.key),
                                      _words(jstate.key), f"key, t={t}")
        firsts += int((tts.step_type == 0).sum())
    assert firsts >= 4 * lanes  # every lane reset several times
    # The samplers draw JAX's values: the scenes and their moves are equal.
    np.testing.assert_array_equal(tstate_.factors.numpy(),
                                  np.asarray(jstate.factors))
    np.testing.assert_array_equal(tstate_.num_sprites.numpy(),
                                  np.asarray(jstate.num_sprites))


def test_single_lane_key_flow_equals_jax():
    """Environment.reset(key) and .step of one lane: the key of
    jax.random.key(seed) and its flow through transitions."""
    jenv, tenv = _key_flow_envs("cobra.goal_finding_new_position")
    jstate, _ = jax.jit(jenv.reset)(jax.random.key(5))
    tstate_, _ = tenv.reset(5)
    jstep = jax.jit(jenv.step)
    for t in range(12):
        a = np.full(4, 0.5, np.float32)
        jstate, _ = jstep(jstate, jnp.asarray(a))
        tstate_, _ = tenv.step(tstate_, a)
        np.testing.assert_array_equal(lane_random.key_data(tstate_.key),
                                      _words(jstate.key), f"t={t}")


# ---------------------------------------------------------------------- #
# (c), (d): pure steps and lanes that depend on their keys alone.

def _noisy_env():
    return chip_smoke.noisy_low_acceptance_env(
        bench_torch, tenvironment, "cpu", (16, 16))


def _assert_states_equal(a, b, what=""):
    for n in tstate.STATE_FIELDS:
        assert torch.equal(getattr(a, n), getattr(b, n)), (what, n)


def test_a_step_is_a_function_of_its_state():
    """step_batch twice on one state (half the lanes resetting, rejection
    in the fresh scenes, SelectMove noise in the actions): equal states
    and timesteps; the single-lane step too."""
    env = _noisy_env()
    state, _ = env.reset_batch(lane_random.split(lane_random.key(4), 16))
    state.reset_next[::2] = True
    actions = env.sample_action(lane_random.split(lane_random.key(5), 16))
    a, ta = env.step_batch(state.clone(), actions)
    b, tb = env.step_batch(state.clone(), actions)
    _assert_states_equal(a, b)
    for name in ("step_type", "reward", "discount"):
        assert torch.equal(getattr(ta, name).nan_to_num(),
                           getattr(tb, name).nan_to_num()), name
    assert torch.equal(ta.observation["image"], tb.observation["image"])
    assert (ta.step_type[::2] == 0).all()
    # The noise moved the clicks: a noise-free space steps otherwise.
    quiet = _noisy_env()
    quiet._action_space = type(env.action_space)(scale=0.25)
    c, _ = quiet.step_batch(state.clone(), actions)
    assert not torch.equal(c.factors[1::2], a.factors[1::2])
    one = type(state)(**{n: getattr(state, n)[1] for n in
                         tstate.STATE_FIELDS})
    s1, t1 = env.step(one, actions[1])
    s2, t2 = env.step(one, actions[1])
    _assert_states_equal(s1, s2, "single lane")
    assert torch.equal(t1.observation["image"], t2.observation["image"])
    _assert_states_equal(
        s1, type(state)(**{n: getattr(a, n)[1] for n in
                           tstate.STATE_FIELDS}), "lane 1 of the batch")


@pytest.mark.parametrize("lanes", [(0,), (3, 7, 12), tuple(range(15, -1, -1))])
def test_a_lane_is_a_function_of_its_key(lanes):
    """Lanes of a 16-lane batch against the same lane keys (in any order)
    reset and stepped in a batch of their own, host-checked rejection
    (an element pending past the first round in the batch needs not be
    so alone)."""
    env = _noisy_env()
    keys = lane_random.split(lane_random.key(8), 16)
    actions = env.sample_action(lane_random.split(lane_random.key(9),
                                                  (6, 16)))
    sub = list(lanes)
    big, _ = env.reset_batch(keys)
    small, _ = env.reset_batch(keys[sub])
    for t in range(6):
        big, bts = env.step_batch(big, actions[t])
        small, sts = env.step_batch(small, actions[t][sub])
        for n in tstate.STATE_FIELDS:
            assert torch.equal(getattr(big, n)[sub], getattr(small, n)), (
                t, n)
        assert torch.equal(bts.observation["image"][sub],
                           sts.observation["image"])


def test_chip_smoke_phase_12_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 12 (b) and (c) on the CPU (the kernel's part,
    (a), needs the card): the compiled step deferred and re-run, lanes
    stepped alone, and two mesh ranks one after the other against the
    whole runner."""
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda *args: None)
    reruns = chip_smoke.pure_step_and_lanes(torch, bench_torch, tenvironment,
                                            dev="cpu", image_size=(16, 16))
    assert reruns >= 1  # deferred rejection ran again, and still equal
    chip_smoke.runner_halves(torch, bench_torch, dev="cpu")


# ---------------------------------------------------------------------- #
# (g) a JAX package checkpoint restores with its keys.

def test_jax_npz_restores_keys_that_step_on_as_jax(tmp_path, monkeypatch):
    cfg = importlib.import_module(
        "spriteworld_tpu.configs.cobra.goal_finding_new_shape"
    ).get_config("train")
    cfg["renderers"] = {"success": jrenderers.Success()}
    jenv = jenvironment.Environment(**cfg)
    jstate, _ = jax.jit(jenv.reset_batch)(
        jax.random.split(jax.random.key(3), 6))
    monkeypatch.setattr(jcheckpoint, "_HAS_ORBAX", False)
    jcheckpoint.save_state(str(tmp_path / "jax"), jstate)

    tcfg = importlib.import_module(
        "spriteworld_torch.configs.cobra.goal_finding_new_shape"
    ).get_config("train")
    tcfg["renderers"] = {"success": trenderers.Success()}
    tenv = tenvironment.Environment(**tcfg, device="cpu", seed=99)
    like = tenv.initial_state(6)
    restored = restore_state(str(tmp_path / "jax"), like)
    np.testing.assert_array_equal(lane_random.key_data(restored.key),
                                  _words(jstate.key))
    assert not torch.equal(restored.key, like.key)
    a = np.full((6, 4), 0.5, np.float32)  # clicks that move nothing
    jstate, jts = jax.jit(jenv.step_batch)(jstate, jnp.asarray(a))
    tstate_, tts = tenv.step_batch(restored, torch.from_numpy(a))
    np.testing.assert_array_equal(tts.step_type.numpy(),
                                  np.asarray(jts.step_type))
    np.testing.assert_array_equal(lane_random.key_data(tstate_.key),
                                  _words(jstate.key))
    np.testing.assert_array_equal(tstate_.factors.numpy(),
                                  np.asarray(jstate.factors))


def test_a_checkpoint_without_keys_restores_with_like_keys(tmp_path):
    """A checkpoint written before the state held keys (a generator state
    beside it): restored with a warning, its keys from `like`, its
    generator ignored."""
    env = bench_torch.build_factors_env(device="cpu")
    state = env.initial_state(4)
    old = {n: getattr(state, n).numpy() for n in tstate.STATE_FIELDS
           if n != "key"}
    np.savez(str(tmp_path / "old.npz"),
             **{f"['env_state'].{n}": v for n, v in old.items()},
             **{"['generator']": np.zeros(16, np.uint8)})
    like = {"env_state": env.initial_state(lane_random.split(
        lane_random.key(7), 4))}
    with pytest.warns(UserWarning, match=r"\['env_state'\]\.key"):
        restored = restore_state(str(tmp_path / "old"), like)
    assert torch.equal(restored["env_state"].key, like["env_state"].key)
    assert torch.equal(restored["env_state"].factors, state.factors)


# ---------------------------------------------------------------------- #
# (h) statistics of the draws.

def test_draw_statistics():
    keys = lane_random.split(lane_random.key(31), 4096)
    u = lane_random.uniform(keys, 8).double().flatten().numpy()
    assert scipy.stats.kstest(u, "uniform").pvalue > 1e-3
    z = lane_random.normal(keys, 8).double().flatten().numpy()
    assert scipy.stats.kstest(z, "norm").pvalue > 1e-3
    r = lane_random.randint(keys, 8, -2, 5).flatten()
    assert int(r.min()) == -2 and int(r.max()) == 4
    counts = torch.bincount(r.long() + 2, minlength=7).numpy()
    assert scipy.stats.chisquare(counts).pvalue > 1e-3
    # Lanes and counters are independent streams: no two lanes' bits
    # agree, and the counters of one lane are not its neighbours'.
    b = lane_random.bits(keys, 4)
    assert len(set(map(tuple, b.tolist()))) == 4096
    assert not torch.equal(b[1:, 0], b[:-1, 1])
