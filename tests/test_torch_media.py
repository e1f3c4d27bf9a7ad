"""Port parity, utils/media: record_episode against the JAX package's on one
injected scene and one list of actions (anti_aliasing=1 frames exact), its
frames against the plain render of its states (exact), its stopping rule
and seeding, and save_gif through Pillow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spriteworld_tpu.core import actions as jactions
from spriteworld_tpu.core import distributions as jdistribs
from spriteworld_tpu.core import environment as jenvironment
from spriteworld_tpu.core import generators as jgenerators
from spriteworld_tpu.core import renderers as jrenderers
from spriteworld_tpu.core import tasks as jtasks
from spriteworld_tpu.utils import media as jmedia

from spriteworld_torch.core import actions as tactions
from spriteworld_torch.core import distributions as tdistribs
from spriteworld_torch.core import environment as tenvironment
from spriteworld_torch.core import generators as tgenerators
from spriteworld_torch.core import renderers as trenderers
from spriteworld_torch.core import state as tstate
from spriteworld_torch.core import tasks as ttasks
from spriteworld_torch.ops import rasterize_cuda
from spriteworld_torch.ops import lane_random
from spriteworld_torch.utils import media as tmedia


class _JaxFixed(jgenerators.SpriteGenerator):
    """Injects one fixed scene (as tests/test_environment.py does)."""

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


def _scene(rng, k=3):
    """Angle-0 sprites on the 1/256 grid (vertices and moves exact)."""
    f = np.tile(tstate.DEFAULT_FACTORS, (k, 1)).astype(np.float32)
    f[:, tstate.X] = rng.integers(64, 193, k) / 256
    f[:, tstate.Y] = rng.integers(64, 193, k) / 256
    f[:, tstate.SHAPE] = rng.integers(1, 13, k)
    f[:, tstate.SCALE] = rng.uniform(0.1, 0.25, k)
    f[:, tstate.C0] = rng.uniform(0, 1, k)
    f[:, tstate.C1] = rng.uniform(0.3, 1, k)
    f[:, tstate.C2] = 1.0
    # Sprite 0 passes the goal filter, far from the goal: no vacuous
    # success on the first step.
    f[0, tstate.C0] = 0.25
    f[0, tstate.X:tstate.Y + 1] = 64 / 256
    return f


def _config(d, t, a, r, gen, max_episode_length, aa=1):
    return dict(
        task=t.FindGoalPosition(filter_distrib=d.Continuous("c0", 0.0, 0.5),
                                terminate_distance=0.05),
        action_space=a.SelectMove(scale=0.25),
        renderers={"image": r.ImageRenderer((64, 64), anti_aliasing=aa,
                                            color_to_rgb="hsv"),
                   "success": r.Success()},
        init_sprites=gen, max_episode_length=max_episode_length)


def _torch_env(scene, max_episode_length=6, aa=1):
    return tenvironment.Environment(
        **_config(tdistribs, ttasks, tactions, trenderers,
                  _TorchFixed(scene), max_episode_length, aa),
        device="cpu")


def _scripted(actions):
    """A policy that plays `actions` [T, 4] in order, whatever its
    arguments."""
    it = iter(actions)
    return lambda _, state: next(it)[None]


def test_frames_equal_jax_record_episode():
    """One injected scene, one action list: the port's frames equal the
    JAX record_episode's (anti_aliasing=1: exact), to the same LAST or
    max_steps."""
    rng = np.random.default_rng(0)
    scene = _scene(rng)
    actions = (rng.integers(0, 65, (12, 4)) / 64).astype(np.float32)
    pick = rng.integers(0, 3, 12)
    actions[:, :2] = scene[pick, :2]
    jenv = jenvironment.Environment(**_config(
        jdistribs, jtasks, jactions, jrenderers, _JaxFixed(scene), 6))
    want = jmedia.record_episode(jenv, jax.random.key(0), max_steps=12,
                                 policy=_scripted(actions))
    got = tmedia.record_episode(_torch_env(scene), 0, max_steps=12,
                                policy=_scripted(actions))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[0] >= 4  # the reset and 3 steps at least
    np.testing.assert_array_equal(got, want)  # exact at anti_aliasing=1


@pytest.mark.parametrize("aa", [1, 3])
def test_frames_equal_plain_render_of_states(aa):
    env = _torch_env(_scene(np.random.default_rng(1)), aa=aa)
    frames, states = tmedia.record_episode(env, 2, max_steps=4,
                                           return_states=True)
    assert len(states) == len(frames) == 5  # stopped at max_steps
    f = torch.cat([s.factors for s in states])
    n = torch.cat([s.num_sprites for s in states])
    tables = rasterize_cuda.prepare(f, n, 64 * aa, 64 * aa,
                                    env.renderers["image"]._color_to_rgb)
    want = rasterize_cuda.render_rgb_batch_plain(tables, (64, 64))
    np.testing.assert_array_equal(frames, want.numpy())  # exact


def test_stops_at_last_and_a_seed_repeats_the_episode():
    env = _torch_env(_scene(np.random.default_rng(2)), max_episode_length=3)
    a = tmedia.record_episode(env, 5, max_steps=10)
    assert a.shape[0] == 4  # reset + 3 steps, the last LAST
    b = tmedia.record_episode(env, 5, max_steps=10)
    np.testing.assert_array_equal(a, b)
    c = tmedia.record_episode(env, lane_random.key(5), max_steps=10,
                              policy=lambda keys, s: env.sample_action(keys))
    np.testing.assert_array_equal(c, a)  # the default policy, keyed alike


def test_save_gif_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (5, 16, 12, 3)).astype(np.uint8)
    path = tmedia.save_gif(frames, str(tmp_path / "synth.gif"), scale=3)
    img = Image.open(path)
    assert img.n_frames == 5
    assert img.size == (36, 48)  # (width, height) scaled by 3
    path = tmedia.save_gif(frames[:2], str(tmp_path / "plain.gif"))
    assert Image.open(path).size == (12, 16)
    with pytest.raises(ValueError, match="expected u8"):
        tmedia.save_gif(frames[..., 0], str(tmp_path / "bad.gif"))
