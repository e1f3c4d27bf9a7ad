"""The plain reference against the port's plain path on the CPU, at a few
lanes: the runner's reset and steps, and the dm_env adapter's episodes."""

import importlib

import numpy as np
import pytest
import torch

from perfbench import check, harness
from perfbench.reference import threefry

CONFIGS = ("cobra.goal_finding_new_position", "cobra.sorting")
SEED = 3_000_000_019  # above 2**31: the key takes both words


def _ref(name):
    return check.reference_module(harness.Layout().reference(name))


def _loop(name):
    return harness.Layout().loop(name)


def _port_env(name):
    from spriteworld_torch.core import environment as env_lib

    mod = importlib.import_module(f"spriteworld_torch.configs.{name}")
    return env_lib.Environment(**mod.get_config("train"), device="cpu")


def test_threefry_against_the_port_twin():
    from spriteworld_torch.ops import lane_random

    k = lane_random.key(SEED)
    assert np.array_equal(threefry.key(SEED), lane_random.key_data(k))
    keys = lane_random.split(k, 5)
    rng = threefry.Rng()
    want = rng.split(threefry.key(SEED)[None], 5)[0]
    assert np.array_equal(want, lane_random.key_data(keys))
    ref_keys = lane_random.key_data(keys)
    np.testing.assert_array_equal(
        rng.uniform(ref_keys, 3, 0.1, 0.9),
        lane_random.uniform(keys, 3, 0.1, 0.9).numpy())
    np.testing.assert_array_equal(
        rng.randint(ref_keys, 0, 9),
        lane_random.randint(keys, 1, 0, 9)[:, 0].numpy())
    assert rng.blocks == 5 + 15 + 20


@pytest.mark.parametrize("name", CONFIGS)
def test_runner_steps_equal(name):
    from spriteworld_torch.parallel import ShardedRunner

    lanes, steps = 6, 23
    runner = ShardedRunner(_port_env(name), lanes)
    state, ts = runner.reset(SEED)
    state2, _, tss = runner.rollout(state, steps, return_timesteps=True)
    env = _ref(name).build()
    idx = np.arange(lanes)
    ref = env.reset(env.rng.block(threefry.key(SEED)[None],
                                  idx.astype(np.uint32)))
    np.testing.assert_array_equal(ref.factors, state.factors.numpy())
    np.testing.assert_array_equal(env.observe(ref, "image"),
                                  ts.observation["image"].numpy())
    start = {k: getattr(state, f).numpy()
             for k, f in (("factors", "factors"), ("num", "num_sprites"),
                          ("step_count", "step_count"),
                          ("reset_next", "reset_next"), ("key", "key"))}
    # The action key starts at fold_in(key(seed), 1).
    sts, rws, ims, end, key = _loop("runner").simulate(
        env, check.as_state(start), threefry.blocks(threefry.key(SEED), 1),
        idx, steps, "image")
    np.testing.assert_array_equal(sts, tss.step_type.numpy())
    np.testing.assert_array_equal(rws, tss.reward.numpy())
    np.testing.assert_array_equal(
        ims, tss.observation["image"].numpy().reshape(ims.shape))
    np.testing.assert_array_equal(end.factors, state2.factors.numpy())
    np.testing.assert_array_equal(key, runner.action_key.numpy()
                                  .view(np.uint32))
    if env.max_episode_length < steps:  # every lane ends and resets
        assert (sts == 2).any(0).all() and (sts == 0).any(0).all()


@pytest.mark.parametrize("name", CONFIGS)
def test_adapter_episode_equal(name):
    from perfbench.dm_env_stand_in import dm_env_stand_in

    with dm_env_stand_in():
        from spriteworld_torch.adapters import dm_env_adapter

        mod = importlib.import_module(f"spriteworld_torch.configs.{name}")
        adapter = dm_env_adapter.Environment(**mod.get_config("train"),
                                             seed=SEED, device="cpu")
        adapter.reset()
        first = adapter.reset()
        rng = np.random.default_rng(5)
        actions = rng.random((8, 4), dtype=np.float32)
        got = [adapter.step(a) for a in actions]
    env = _ref(name).build()
    loop = _loop("adapter")
    keys = loop.reset_keys(SEED, 2)
    want = loop.simulate(env, keys[2], actions, "image")
    np.testing.assert_array_equal(want[0][0], first.observation["image"])
    np.testing.assert_array_equal(want[1], [int(t.step_type) for t in got])
    np.testing.assert_array_equal(want[2], [np.float32(t.reward)
                                            for t in got])
    np.testing.assert_array_equal(want[3][:, 0], [t.observation["image"]
                                                  for t in got])
    torch.testing.assert_close(torch.from_numpy(want[4].factors),
                               adapter._state.factors, rtol=0, atol=0)
