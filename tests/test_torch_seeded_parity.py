"""Seeded runs of the port against the JAX package: one seed, the same
scenes and episodes.

The port's draws are `jax.random`'s (`ops.lane_random`: randint, choice,
the rejection loop's split chain and normal on JAX's threefry keys), so
from one seed both packages build the same scenes and, stepped with the
actions that `sample_action` draws from the same action keys, the same
episodes:

(a) per draw, over 1000+ keys: randint over spans 2, 3, 4, 6 and 16, the
    adapter seed's [0, 2**31 - 1) and a negative lo; choice with p,
    Mixture's default p among them; the cumulative sums against
    `jnp.cumsum`; the rejection nodes (SetMinus, a nested low-acceptance
    Selection) against the JAX nodes, with the elements that needed
    proposals past the first round counted; normal within its stated
    float32 ulp bound, the share of equal draws counted;
(b) every config of configs/cobra and configs/examples in each of its
    modes: `BatchedEnvironment.reset(seed)` over 16 lanes equals JAX's
    `reset(jax.random.key(seed))` in factors, num_sprites, keys, sample_ok
    and observations, then 30 steps of sampled actions equal in states,
    keys, step types, discounts, AA=1 pixels (AA=5 within +-1) and
    rewards; rewards may differ only where XLA on the CPU contracts the
    goal distance into a fused multiply-add (ROADMAP Queue 3, PR 3): there
    within 2 float32 ulp, the cases counted and the rest equal;
(c) the dm_env adapter from a seed: its first observation and
    `sample_contained_position` equal JAX's.

The JAX package runs on the CPU as its own tests run it (its renderers
take the XLA path there); the port runs its plain twins on CPU tensors.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spriteworld_tpu.core import distributions as jdistribs
from spriteworld_tpu.core import environment as jenvironment
from spriteworld_tpu.core import renderers as jrenderers

from spriteworld_torch.core import distributions as tdistribs
from spriteworld_torch.core import environment as tenvironment
from spriteworld_torch.core import renderers as trenderers
from spriteworld_torch.core import state as tstate
from spriteworld_torch.ops import lane_random

CONFIGS = [
    ("cobra.exploration", None),
    ("cobra.goal_finding_new_position", "train"),
    ("cobra.goal_finding_new_position", "test"),
    ("cobra.goal_finding_new_shape", "train"),
    ("cobra.goal_finding_new_shape", "test"),
    ("cobra.goal_finding_more_targets", "train"),
    ("cobra.goal_finding_more_targets", "test"),
    ("cobra.goal_finding_more_distractors", "train"),
    ("cobra.goal_finding_more_distractors", "test"),
    ("cobra.clustering", "train"),
    ("cobra.clustering", "test"),
    ("cobra.sorting", "train"),
    ("cobra.sorting", "test"),
    ("examples.goal_finding_embodied", None),
    ("examples.goal_finding_clustering", "train"),
    ("examples.goal_finding_clustering", "test"),
]
LANES = 16
STEPS = 30
SEED = 17
IMAGE = (16, 16)
# XLA's float32 log1p on the CPU is not the float64 one rounded once that
# the port (and its kernel) takes: normals within this many float32 ulp.
NORMAL_ULP = 3
# XLA on the CPU contracts the goal distance dx*dx + dy*dy into a fused
# multiply-add where the port rounds each product (the TPU's rounding,
# ROADMAP Queue 3, PR 3); summed over a task's sprites the rewards then
# differ by up to this many float32 ulp.
REWARD_ULP = 8


def _keys(seed, n):
    t = lane_random.split(lane_random.key(seed), n)
    return t, jax.random.wrap_key_data(lane_random.key_data(t))


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


# ---------------------------------------------------------------------- #
# (a) the draws.

@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 3), (0, 4), (0, 6), (0, 16),
                                   (0, 2**31 - 1), (-7, 5), (4, 4)])
def test_randint_equals_jax(lo, hi):
    keys, jkeys = _keys(lo * 31 + hi, 1024)
    got = lane_random.randint(keys, 3, lo, hi).numpy()
    want = jax.vmap(lambda k: jax.random.randint(k, (3,), lo, hi))(jkeys)
    np.testing.assert_array_equal(got, np.asarray(want))
    one = jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(jkeys)
    np.testing.assert_array_equal(got[:, 0], np.asarray(one))
    with pytest.raises(OverflowError):
        lane_random.randint(keys, 1, 0, 2**31)


@pytest.mark.parametrize("p", [[0.2, 0.5, 0.3], np.ones(3) / 3,
                               np.ones(7) / 7, [0.1, 0.0, 0.4, 0.25, 0.25]])
def test_choice_equals_jax(p):
    """Discrete(probs=p) and Mixture's default ones(n)/n: the cumulative
    sums equal jnp.cumsum's (eager and jitted), the draws JAX's."""
    p = np.asarray(p)
    cum = lane_random.cumulative(p)
    np.testing.assert_array_equal(cum, np.asarray(jnp.cumsum(p)))
    np.testing.assert_array_equal(
        cum, np.asarray(jax.jit(lambda: jnp.cumsum(jnp.asarray(p)))()))
    keys, jkeys = _keys(len(p), 1024)
    got = lane_random.choice(keys, 4, cum).numpy()
    want = jax.vmap(lambda k: jax.random.choice(k, len(p), (4,), p=p))(jkeys)
    np.testing.assert_array_equal(got, np.asarray(want))
    d = tdistribs.Discrete("x", list(range(len(p))), probs=p)
    jd = jdistribs.Discrete("x", list(range(len(p))), probs=p)
    np.testing.assert_array_equal(d.sample(keys)["x"].numpy(),
                                  np.asarray(jax.vmap(jd.sample)(jkeys)["x"]))


def _mixture(pkg):
    """Mixture's default probabilities over a Discrete without probs (a
    randint) and two Continuous components."""
    return pkg.Mixture([pkg.Continuous("x", 0.0, 0.3),
                        pkg.Discrete("x", [0.5, 0.6, 0.7]),
                        pkg.Continuous("x", 0.8, 1.0)])


def test_mixture_equals_jax():
    keys, jkeys = _keys(3, 2048)
    got = _mixture(tdistribs).sample(keys)["x"].numpy()
    want = np.asarray(jax.vmap(_mixture(jdistribs).sample)(jkeys)["x"])
    np.testing.assert_array_equal(got, want)
    # Every component was taken.
    assert (got < 0.3).any() and ((got > 0.4) & (got < 0.8)).any() \
        and (got >= 0.8).any()


def test_split_chain_is_jax_rejection_keys():
    """sub_r = split(s_r)[1], s_{r+1} = split(s_r)[0]: the keys JAX's
    rejection loop proposes from, and the key that continues it."""
    keys, jkeys = _keys(9, 1024)
    subs, state = lane_random.split_chain(keys, 6)

    def chain(k):
        s, out = k, []
        for _ in range(6):
            s, sub = jax.random.split(s)
            out.append(jax.random.key_data(sub))
        return jnp.stack(out), jax.random.key_data(s)

    want_subs, want_state = jax.vmap(chain)(jkeys)
    np.testing.assert_array_equal(lane_random.key_data(subs),
                                  np.asarray(want_subs).transpose(1, 0, 2))
    np.testing.assert_array_equal(lane_random.key_data(state),
                                  np.asarray(want_state))
    more, _ = lane_random.split_chain(state, 2)
    np.testing.assert_array_equal(
        lane_random.key_data(torch.cat([subs, more])),
        lane_random.key_data(lane_random.split_chain(keys, 8)[0]))


def _rejecting(pkg):
    """SetMinus (goal_finding_new_position's quadrant: it accepts 3 in 4
    proposals) and a nested low-acceptance Selection: a SetMinus (1 in 2)
    inside a Selection that accepts 3 in 25 of its proposals."""
    c = pkg.Continuous
    full = pkg.Product([c("x", 0.1, 0.9), c("y", 0.1, 0.9)])
    quadrant = pkg.Product([c("x", 0.5, 0.9), c("y", 0.5, 0.9)])
    minus = pkg.SetMinus(full, quadrant)
    nested = pkg.Selection(
        pkg.SetMinus(pkg.Product([c("x", 0.0, 1.0), c("y", 0.0, 1.0)]),
                     pkg.Product([c("x", 0.0, 0.5), c("y", 0.0, 1.0)])),
        pkg.Product([c("x", 0.9, 1.0), c("y", 0.0, 0.6)]))
    return {"setminus": minus, "nested": nested}


@pytest.mark.parametrize("name", ["setminus", "nested"])
def test_rejection_equals_jax(name, monkeypatch):
    """The rejection nodes from JAX's chain: equal samples and status over
    2048 keys, with rounds of 2 proposals so that many elements go on past
    the first (counted) and the carried chain key is exercised."""
    monkeypatch.setattr(tdistribs, "REJECTION_ROUNDS", 2)
    keys, jkeys = _keys(21, 2048)
    t, j = _rejecting(tdistribs)[name], _rejecting(jdistribs)[name]
    spec, ok = t.sample_with_status(keys)
    jspec, jok = jax.jit(jax.vmap(j.sample_with_status))(jkeys)
    for k in ("x", "y"):
        np.testing.assert_array_equal(spec[k].numpy(), np.asarray(jspec[k]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.all()
    # Elements that needed more than one round: every one of their first
    # 2 proposals was rejected.
    flag = torch.zeros((), dtype=torch.bool)
    with tdistribs.defer_rejection(flag):
        _, first_ok = t.sample_with_status(keys)
    past = int((~first_ok).sum())
    assert bool(flag) and past >= (50 if name == "setminus" else 1000), past


def test_normal_is_xla_erfinv32_within_its_bound():
    """normal over 200,000 draws: within NORMAL_ULP float32 ulp of
    jax.random.normal on the CPU, most of them equal (the share is in
    PERF.md); the float32 ErfInv32 is the twin's."""
    keys, jkeys = _keys(5, 2000)
    got = lane_random.normal(keys, 100).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (100,)))(jkeys))
    d = _ulps(got, want)
    print(f"\nnormal: {int((d == 0).sum())} of {d.size} draws equal JAX's, "
          f"the rest within {int(d.max())} float32 ulp")
    assert d.max() <= NORMAL_ULP, d.max()
    assert (d == 0).mean() > 0.98, (d == 0).mean()


# ---------------------------------------------------------------------- #
# (b) every config from a seed.

# The configs whose observations include images: the configs' own
# renderer modes (Pillow-exact fill, Lanczos at AA=5) at IMAGE, AA=1 and
# AA=5. XLA on the CPU takes 5-100 s to compile them a config (more with
# more sprites), so they render in one config: goal finding with shapes
# drawn by randint, HSV colours, shuffled z-order and fresh scenes on
# auto-reset. The others observe factors and success.
IMAGE_CONFIGS = {("cobra.goal_finding_new_shape", "train")}


def _renderers(r, images, hsv):
    out = {"factors": r.SpriteFactors(), "success": r.Success()}
    if images:
        rgb = "hsv" if hsv else None
        out["image"] = r.ImageRenderer(IMAGE, anti_aliasing=1,
                                       color_to_rgb=rgb)
        out["image5"] = r.ImageRenderer(IMAGE, anti_aliasing=5,
                                        color_to_rgb=rgb)
    return out


def _envs(path, mode):
    out = []
    for pkg, r in (("spriteworld_tpu", jrenderers),
                   ("spriteworld_torch", trenderers)):
        mod = importlib.import_module(f"{pkg}.configs.{path}")
        cfg = mod.get_config(mode) if mode else mod.get_config()
        hsv = cfg["renderers"]["image"]._color_to_rgb is not None
        cfg["renderers"] = _renderers(r, (path, mode) in IMAGE_CONFIGS, hsv)
        out.append(cfg)
    return (jenvironment.Environment(**out[0]),
            tenvironment.Environment(**out[1], device="cpu"))


def _obs_equal(tobs, jobs, what):
    if "image" in tobs:
        np.testing.assert_array_equal(tobs["image"].numpy(),
                                      np.asarray(jobs["image"]), what)
        diff = np.abs(tobs["image5"].numpy().astype(int)
                      - np.asarray(jobs["image5"]).astype(int))
        assert diff.max() <= 1, (what, diff.max())
    for k in ("factors", "mask"):
        np.testing.assert_array_equal(tobs["factors"][k].numpy(),
                                      np.asarray(jobs["factors"][k]), what)
    np.testing.assert_array_equal(tobs["success"].numpy(),
                                  np.asarray(jobs["success"]), what)


def _states_equal(t, j, what):
    for n in tstate.STATE_FIELDS:
        want = getattr(j, n)
        want = (jax.random.key_data(want) if n == "key" else want)
        got = getattr(t, n)
        got = lane_random.key_data(got) if n == "key" else got.numpy()
        np.testing.assert_array_equal(got, np.asarray(want), f"{what}: {n}")


def _jax_episodes(jenv, seed, action_seeds):
    """JAX's BatchedEnvironment run as one jitted program: reset(key) is
    `reset_batch(split(key, LANES))`, sample_actions(key) is
    `vmap(sample_action)(split(key, LANES))`; the steps in a `lax.scan`
    (one compile of the step, not one for reset, step and sampler each).
    Returns the reset's (state, timestep) and the stacked (state,
    timestep, actions) after each step."""

    def run(key, action_keys):
        first = jenv.reset_batch(jax.random.split(key, LANES))

        def body(state, akey):
            acts = jax.vmap(jenv.sample_action)(jax.random.split(akey, LANES))
            state, ts = jenv.step_batch(state, acts)
            return state, (state, ts, acts)

        return first, jax.lax.scan(body, first[0], action_keys)[1]

    action_keys = jax.vmap(jax.random.key)(jnp.asarray(action_seeds))
    return jax.jit(run)(jax.random.key(seed), action_keys)


def _at(tree, t):
    return jax.tree_util.tree_map(lambda x: x[t], tree)


@pytest.mark.parametrize("path,mode", CONFIGS)
def test_seeded_episodes_equal_jax(path, mode):
    """BatchedEnvironment.reset(SEED) over LANES lanes, then STEPS steps
    of sample_actions(1000 + t): the port's equal JAX's (see the module
    docstring)."""
    jenv, tenv = _envs(path, mode)
    seeds = [1000 + t for t in range(STEPS)]
    (jstate, jts), (jstates, jtss, jacts) = _jax_episodes(jenv, SEED, seeds)
    tbenv = tenvironment.BatchedEnvironment(tenv, LANES)
    tstate_, tts = tbenv.reset(SEED)
    _states_equal(tstate_, jstate, "reset")
    _obs_equal(tts.observation, jts.observation, "reset")
    assert bool(tstate_.sample_ok.all())
    fused = firsts = 0
    for t, seed in enumerate(seeds):
        tact = tbenv.sample_actions(seed)
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jacts[t]))
        tstate_, tts = tbenv.step(tstate_, tact)
        jstate, jts = _at(jstates, t), _at(jtss, t)
        what = f"{path} {mode} t={t}"
        _states_equal(tstate_, jstate, what)
        for n in ("step_type", "discount"):
            np.testing.assert_array_equal(getattr(tts, n).numpy(),
                                          np.asarray(getattr(jts, n)), what)
        _obs_equal(tts.observation, jts.observation, what)
        got, want = tts.reward.numpy(), np.asarray(jts.reward)
        off = got != want
        assert _ulps(got[off], want[off]).max(initial=0) <= REWARD_ULP, (
            what, got[off], want[off])
        fused += int(off.sum())
        firsts += int((tts.step_type == 0).sum())
    print(f"\n{path} {mode}: {LANES} lanes x {STEPS} steps, {firsts} "
          f"fresh scenes, rewards off by the fused goal distance: {fused}")


PROBE_CONFIGS = ["cobra.goal_finding_new_position", "cobra.sorting",
                 "cobra.clustering", "examples.goal_finding_embodied"]


@pytest.mark.parametrize("path", PROBE_CONFIGS)
def test_reset_probe_every_lane_equals_jax(path):
    """ROADMAP Queue 3's probe: `BatchedEnvironment(env, 64).reset(17)` of
    both packages (train mode where there is one), JAX's through its own
    BatchedEnvironment: lanes with JAX's factors and num_sprites, 64 of 64
    (before JAX's draws were ported: 0-1 of 64)."""
    mode = None if path.startswith("examples.goal_finding_embodied") \
        else "train"
    cfgs = []
    for pkg, r in (("spriteworld_tpu", jrenderers),
                   ("spriteworld_torch", trenderers)):
        cfg = importlib.import_module(f"{pkg}.configs.{path}").get_config(
            *([mode] if mode else []))
        cfg["renderers"] = {"success": r.Success()}
        cfgs.append(cfg)
    jb = jenvironment.BatchedEnvironment(jenvironment.Environment(**cfgs[0]),
                                         64)
    tb = tenvironment.BatchedEnvironment(
        tenvironment.Environment(**cfgs[1], device="cpu"), 64)
    jstate, _ = jb.reset(jax.random.key(SEED))
    tstate_, _ = tb.reset(SEED)
    same = ((tstate_.factors.numpy() == np.asarray(jstate.factors))
            .all((1, 2))
            & (tstate_.num_sprites.numpy() == np.asarray(jstate.num_sprites))
            & (lane_random.key_data(tstate_.key)
               == np.asarray(jax.random.key_data(jstate.key))).all(1))
    print(f"\n{path}: {int(same.sum())} / 64 lanes equal JAX's")
    assert same.all()


# ---------------------------------------------------------------------- #
# (c) the dm_env adapter from a seed.

def test_dm_env_adapter_from_a_seed_equals_jax():
    """Both adapters from seed 5 on goal_finding_new_position (rejection
    in the scene): the first observation (factors, success and AA=1
    pixels), the positions sample_contained_position draws (its numpy
    seed is a randint of the adapter's next key) over several calls, and a
    second episode's observation after the steps that end the first."""
    from spriteworld_tpu.adapters import dm_env_adapter as jadapter
    from spriteworld_torch.adapters import dm_env_adapter as tadapter

    adapters = []
    for pkg, r, adapter in (("spriteworld_tpu", jrenderers, jadapter),
                            ("spriteworld_torch", trenderers, tadapter)):
        cfg = importlib.import_module(
            f"{pkg}.configs.cobra.goal_finding_new_position").get_config(
                "train")
        cfg["renderers"] = {
            "image": r.ImageRenderer(IMAGE, anti_aliasing=1,
                                     color_to_rgb="hsv"),
            "factors": r.SpriteFactors(), "success": r.Success()}
        cfg["max_episode_length"] = 3
        kw = {} if pkg == "spriteworld_tpu" else {"device": "cpu"}
        adapters.append(adapter.Environment(**cfg, seed=5, **kw))
    jenv, tenv = adapters

    def same(tts, jts, what):
        assert tts.step_type == jts.step_type, what
        for k in ("image", "success"):
            np.testing.assert_array_equal(np.asarray(tts.observation[k]),
                                          np.asarray(jts.observation[k]),
                                          what)
        # The adapters' factors observation: a dict of factors a sprite.
        assert list(tts.observation["factors"]) == list(
            jts.observation["factors"]), what

    same(tenv.reset(), jenv.reset(), "reset")
    for t in range(4):
        np.testing.assert_array_equal(tenv.sample_contained_position(),
                                      jenv.sample_contained_position(),
                                      f"contained position {t}")
        a = np.array([0.5, 0.5, 0.5 + 0.1 * t, 0.5], np.float32)
        same(tenv.step(a), jenv.step(a), f"step {t}")
