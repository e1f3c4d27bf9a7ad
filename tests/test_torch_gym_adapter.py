"""Port parity, the Gym adapter: spriteworld_torch's GymWrapper over its
dm_env adapter builds the spaces the JAX package's builds over its own, and
runs the reference's episode choreography. Runs against the real gym when
installed, else against the stub in tests/_gym_stub.py, as
tests/test_gym_adapter.py does.
"""

import numpy as np
import pytest

import _gym_stub

_gym_stub.install()

from dm_env import specs as dm_specs  # noqa: E402
from gym import spaces  # noqa: E402

from spriteworld_tpu.adapters import dm_env_adapter as jadapter  # noqa: E402
from spriteworld_tpu.adapters import gym_adapter as jgym  # noqa: E402
from spriteworld_tpu.core import actions as jactions  # noqa: E402
from spriteworld_tpu.core import distributions as jdistribs  # noqa: E402
from spriteworld_tpu.core import generators as jgenerators  # noqa: E402
from spriteworld_tpu.core import renderers as jrenderers  # noqa: E402
from spriteworld_tpu.core import tasks as jtasks  # noqa: E402

from spriteworld_torch.adapters import dm_env_adapter as tadapter  # noqa: E402,E501
from spriteworld_torch.adapters import gym_adapter as tgym  # noqa: E402
from spriteworld_torch.core import actions as tactions  # noqa: E402
from spriteworld_torch.core import distributions as tdistribs  # noqa: E402
from spriteworld_torch.core import generators as tgenerators  # noqa: E402
from spriteworld_torch.core import renderers as trenderers  # noqa: E402
from spriteworld_torch.core import tasks as ttasks  # noqa: E402

MAX_EPISODE_LENGTH = 5


def _config(a, d, g, r, t, space, num_sprites):
    dist = d.Product([
        d.Continuous("x", 0.2, 0.8),
        d.Continuous("y", 0.2, 0.8),
        d.Discrete("shape", ["square"]),
        d.Discrete("scale", [0.2]),
        d.Discrete("c0", [255]),
    ])
    return dict(
        task=t.NoReward(),
        action_space={"select_move": a.SelectMove,
                      "embodied": a.Embodied}[space](),
        renderers={"image": r.ImageRenderer(image_size=(16, 16)),
                   "factors": r.SpriteFactors(),
                   "success": r.Success()},
        init_sprites=g.generate_sprites(dist, num_sprites),
        max_episode_length=MAX_EPISODE_LENGTH)


def _wrappers(space, num_sprites=1):
    jenv = jadapter.Environment(**_config(
        jactions, jdistribs, jgenerators, jrenderers, jtasks, space,
        num_sprites), seed=0)
    tenv = tadapter.Environment(**_config(
        tactions, tdistribs, tgenerators, trenderers, ttasks, space,
        num_sprites), seed=0, device="cpu")
    return jgym.GymWrapper(jenv), tgym.GymWrapper(tenv)


@pytest.mark.parametrize("space,num_sprites", [("select_move", 1),
                                               ("embodied", 2)])
def test_spaces_equal_jax_and_episode_cadence(space, num_sprites):
    jwrap, twrap = _wrappers(space, num_sprites)
    assert twrap.action_space == jwrap.action_space
    assert twrap.observation_space == jwrap.observation_space
    want = (spaces.Box(0.0, 1.0, shape=(4,), dtype=np.float32)
            if space == "select_move"
            else spaces.Tuple([spaces.Discrete(2), spaces.Discrete(4)]))
    assert twrap.action_space == want
    # The reference's episode choreography (gym_wrapper_test.py:59-72).
    for _ in range(2):
        obs = twrap.reset()
        assert obs["factors"].shape == (num_sprites, 10)
        for _ in range(MAX_EPISODE_LENGTH - 1):
            obs, reward, done, info = twrap.step(
                twrap.action_space.sample())
            assert obs["image"].dtype == np.uint8
            assert obs["success"].dtype == np.float32
            assert not done and reward == 0.0 and "discount" in info
        _, _, done, _ = twrap.step(twrap.action_space.sample())
        assert done
        # A step after LAST resets: FIRST, not done.
        _, _, done, _ = twrap.step(twrap.action_space.sample())
        assert not done
    assert twrap.render().shape == (16, 16, 3)
    with pytest.raises(ValueError, match="render mode"):
        twrap.render("human")


def test_spec_to_space_equals_jax():
    cases = [
        dm_specs.BoundedArray((4,), np.float32, 0.0, 1.0),
        dm_specs.BoundedArray((2, 3), np.float32, [-1.0, 0.0, 0.5], 2.0),
        dm_specs.DiscreteArray(5, dtype=np.int64),
        dm_specs.Array((8, 8, 3), np.uint8),
        dm_specs.Array((), bool),
        [dm_specs.DiscreteArray(2), dm_specs.DiscreteArray(4)],
    ]
    for spec in cases:
        assert tgym.spec_to_space(spec) == jgym.spec_to_space(spec)
    for module in (tgym, jgym):
        with pytest.raises(ValueError, match="Unsupported spec"):
            module.spec_to_space(object())
