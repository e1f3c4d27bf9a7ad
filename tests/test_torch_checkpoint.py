"""Port parity, checkpoints: `spriteworld_torch.parallel.save_state` /
`restore_state`, and a JAX package checkpoint restored into the port."""

import importlib
import warnings

import numpy as np
import pytest
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
from spriteworld_torch.parallel import (ShardedRunner, restore_state,
                                        save_state)


def _env(seed=0):
    cfg = importlib.import_module(
        "spriteworld_torch.configs.cobra.goal_finding_new_shape"
    ).get_config("train")
    cfg["renderers"] = {"success": trenderers.Success()}
    return tenvironment.Environment(**cfg, device="cpu", seed=seed)


def test_roundtrip_resumes_the_identical_trajectory(tmp_path):
    """Kill and resume: the env state (the lanes' keys in it), the
    runner's action key and the in-flight episode returns restored into a
    fresh env and runner continue exactly as the uninterrupted run:
    states, timesteps and metrics equal."""
    env_a = _env()
    runner_a = ShardedRunner(env_a, 8)
    state, _ = runner_a.reset(7)
    state, m1 = runner_a.rollout(state, 7)
    ckpt = {"env_state": state, "episode_returns": runner_a.episode_returns,
            "action_key": runner_a.action_key}
    save_state(str(tmp_path / "ck"), ckpt)
    assert runner_a.episode_returns.abs().sum() > 0  # episodes in flight
    want_state, want_m, want_ts = runner_a.rollout(state, 9,
                                                   return_timesteps=True)

    env_b = _env(seed=123)  # other keys until restored
    runner_b = ShardedRunner(env_b, 8)
    like = {"env_state": env_b.initial_state(8),
            "episode_returns": torch.zeros(8),
            "action_key": runner_b.action_key}
    restored = restore_state(str(tmp_path / "ck"), like)
    runner_b.action_key = restored["action_key"]
    for name in tstate.STATE_FIELDS:
        assert torch.equal(getattr(restored["env_state"], name),
                           getattr(state, name))
    got_state, got_m, got_ts = runner_b.rollout(
        restored["env_state"], 9, return_timesteps=True,
        episode_returns=restored["episode_returns"])
    for name in tstate.STATE_FIELDS:
        assert torch.equal(getattr(got_state, name),
                           getattr(want_state, name))
    assert torch.equal(got_ts.step_type, want_ts.step_type)
    assert torch.equal(got_ts.reward.nan_to_num(),
                       want_ts.reward.nan_to_num())
    assert got_m == want_m
    assert torch.equal(runner_b.episode_returns, runner_a.episode_returns)


def test_keys_are_jax_field_paths(tmp_path):
    state = _env().initial_state(4)
    save_state(str(tmp_path / "s"), {"env_state": state, "n": [1, 2.5]})
    with np.load(str(tmp_path / "s.npz")) as data:
        keys = set(data.files)
    assert keys == {f"['env_state'].{n}" for n in tstate.STATE_FIELDS} | {
        "['n'][0]", "['n'][1]"}


def test_missing_fields_fill_from_like(tmp_path):
    """A checkpoint predating a field restores it from `like` with a
    warning; an unknown stored field is ignored with a warning."""
    save_state(str(tmp_path / "old"), {"a": torch.arange(4.0),
                                       "gone": torch.ones(2)})
    like = {"a": torch.zeros(4), "b": torch.full((2,), 7, dtype=torch.int32)}
    with pytest.warns(UserWarning, match="predates state field") as rec:
        restored = restore_state(str(tmp_path / "old"), like)
    assert any("unknown field" in str(w.message) for w in rec)
    assert torch.equal(restored["a"], torch.arange(4.0))
    assert torch.equal(restored["b"], torch.tensor([7, 7],
                                                   dtype=torch.int32))


def test_jax_checkpoint_restores_with_its_keys_dropped(tmp_path,
                                                       monkeypatch):
    """A JAX package EnvState saved in its .npz form restores into the
    port's EnvState field for field; its typed PRNG key, saved as its key
    data, is no longer dropped: it restores as the lanes' keys."""
    cfg = importlib.import_module(
        "spriteworld_tpu.configs.cobra.goal_finding_new_shape"
    ).get_config("train")
    cfg["renderers"] = {"success": jrenderers.Success()}
    jenv = jenvironment.Environment(**cfg)
    jstate, _ = jax.jit(jenv.reset_batch)(
        jax.random.split(jax.random.key(0), 4))
    jstate, _ = jax.jit(jenv.step_batch)(
        jstate, jax.vmap(jenv.sample_action)(
            jax.random.split(jax.random.key(1), 4)))
    monkeypatch.setattr(jcheckpoint, "_HAS_ORBAX", False)
    jcheckpoint.save_state(str(tmp_path / "jax"),
                           {"env_state": jstate,
                            "episode_returns": jnp.arange(4.0)})

    like = {"env_state": _env().initial_state(4),
            "episode_returns": torch.zeros(4)}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # every field is there
        restored = restore_state(str(tmp_path / "jax"), like)
    for name in tstate.STATE_FIELDS:
        got = getattr(restored["env_state"], name)
        assert got.dtype == getattr(like["env_state"], name).dtype
        want = getattr(jstate, name)
        if name == "key":
            got, want = lane_random.key_data(got), jax.random.key_data(want)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert torch.equal(restored["episode_returns"], torch.arange(4.0))
