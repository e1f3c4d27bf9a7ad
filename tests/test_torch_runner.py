"""Port parity, runner: `spriteworld_torch.parallel.ShardedRunner` against
the JAX package's `ShardedRunner` on the CPU.

Both runners step the same injected scene (every reset draws it again) with
the same deterministic policy, written in jnp and in torch: click the
sprite `step_count % num_sprites` and move it a sixteenth towards the
centre. Positions stay on the 1/256 grid, so goal distances are exact in
float32 in both. Stacked timesteps: step types, discounts, rewards and
factors exact, images within +-1 at anti_aliasing=5 and exact at 1;
metrics: counters exact, float sums within rtol=1e-5 (their summation
orders differ).
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
from spriteworld_tpu.parallel import ShardedRunner as JaxRunner

from spriteworld_torch.core import actions as tactions
from spriteworld_torch.core import distributions as tdistribs
from spriteworld_torch.core import environment as tenvironment
from spriteworld_torch.core import generators as tgenerators
from spriteworld_torch.core import renderers as trenderers
from spriteworld_torch.core import state as tstate
from spriteworld_torch.core import tasks as ttasks
from spriteworld_torch.core.state import StepType
from spriteworld_torch.ops import lane_random
from spriteworld_torch.parallel import EvalStats, Metrics, ShardedRunner

B, K = 8, 3  # B divides the JAX tests' 8 virtual CPU devices


def _scene(seed, k=K):
    """One angle-0 scene f32[k, 10] with positions on the 1/256 grid."""
    rng = np.random.default_rng(seed)
    f = np.tile(tstate.DEFAULT_FACTORS, (k, 1)).astype(np.float32)
    f[:, tstate.X] = rng.integers(51, 205, k) / 256
    f[:, tstate.Y] = rng.integers(51, 205, k) / 256
    f[:, tstate.SHAPE] = rng.integers(1, 13, k)
    f[:, tstate.SCALE] = rng.uniform(0.1, 0.3, k)
    f[:, tstate.C0] = rng.uniform(0, 1, k)
    f[:, tstate.C1] = rng.uniform(0.3, 1, k)
    f[:, tstate.C2] = rng.uniform(0.9, 1, k)
    return f


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


def _config(d, t, a, r, gen, scene, aa, max_episode_length, image=True):
    renderers = {"factors": r.SpriteFactors(), "success": r.Success()}
    if image:
        renderers["image"] = r.ImageRenderer((16, 16), anti_aliasing=aa,
                                             color_to_rgb="hsv")
    return dict(
        task=t.FindGoalPosition(filter_distrib=d.Continuous("c0", 0.0, 0.5),
                                terminate_distance=0.075),
        action_space=a.SelectMove(scale=0.25),
        renderers=renderers,
        init_sprites=gen(scene),
        max_episode_length=max_episode_length)


def _torch_env(scene, aa=1, max_episode_length=3, image=True):
    return tenvironment.Environment(
        **_config(tdistribs, ttasks, tactions, trenderers, _TorchFixed, scene,
                  aa, max_episode_length, image), device="cpu")


def _jax_env(scene, aa=1, max_episode_length=3, image=True):
    return jenvironment.Environment(
        **_config(jdistribs, jtasks, jactions, jrenderers, _JaxFixed, scene,
                  aa, max_episode_length, image))


def _jax_policy(key, state):
    del key
    j = state.step_count % state.num_sprites
    click = jnp.take_along_axis(state.factors, j[:, None, None], 1)[:, 0, :2]
    return jnp.concatenate([click, jnp.where(click < 0.5, 0.75, 0.25)], -1)


def _torch_policy(keys, state):
    del keys
    j = (state.step_count % state.num_sprites).long()
    click = state.factors.gather(
        1, j[:, None, None].expand(-1, 1, state.factors.shape[-1]))[:, 0, :2]
    return torch.cat([click, torch.where(click < 0.5, 0.75, 0.25)], -1)


def _host_metrics(tss, acc):
    """Metrics recomputed on the host from stacked timesteps, in float64,
    from the per-lane return accumulator `acc` (updated in place)."""
    reward = np.nan_to_num(tss.reward.numpy().astype(np.float64))
    last = tss.step_type.numpy() == StepType.LAST
    succ = tss.observation["success"].numpy()
    returns = 0.0
    for t in range(reward.shape[0]):
        acc += reward[t]
        returns += acc[last[t]].sum()
        acc[last[t]] = 0.0
    return (int(last.sum()), int((last & succ).sum()), returns,
            reward.sum())


@pytest.mark.parametrize("aa", [1, 5])
def test_rollout_equals_jax(aa):
    """Two chunks of stacked timesteps, their metrics and the final states
    of both runners are equal."""
    scene = _scene(aa)
    jrun = JaxRunner(_jax_env(scene, aa), B, policy=_jax_policy)
    trun = ShardedRunner(_torch_env(scene, aa), B, policy=_torch_policy)
    assert not trun.use_graph
    jstate, _ = jrun.reset(jax.random.key(0))
    tst, _ = trun.reset(0)
    key = jax.random.key(1)
    trun.action_key = lane_random.key(1)  # JAX's rollout key
    total = Metrics.zero()
    for chunk in range(2):
        jstate, key, jm, jts = jrun.rollout(jstate, key, 5,
                                            return_timesteps=True)
        tst, tm, tts = trun.rollout(tst, 5, return_timesteps=True)
        for name in ("step_type", "discount", "reward"):
            np.testing.assert_array_equal(getattr(tts, name).numpy(),
                                          np.asarray(getattr(jts, name)),
                                          f"{name}, chunk {chunk}")
        for name in ("success",):
            np.testing.assert_array_equal(tts.observation[name].numpy(),
                                          np.asarray(jts.observation[name]))
        for name in ("factors", "mask"):
            got = tts.observation["factors"][name].numpy()
            np.testing.assert_array_equal(
                got, np.asarray(jts.observation["factors"][name]))
        img_t = tts.observation["image"].numpy().astype(int)
        img_j = np.asarray(jts.observation["image"]).astype(int)
        assert img_t.shape == img_j.shape == (5, B, 16 * 16 * 3)
        assert np.abs(img_t - img_j).max() <= (1 if aa > 1 else 0)
        for name in tstate.STATE_FIELDS:
            want = getattr(jstate, name)
            if name == "key":
                want = jax.random.key_data(want).view(np.int32)
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(want), name)
        # The carried action keys split alike.
        np.testing.assert_array_equal(
            lane_random.key_data(trun.action_key),
            np.asarray(jax.random.key_data(key)))
        assert (tm.steps, tm.episodes, tm.successes) == (
            int(jm.steps), int(jm.episodes), int(jm.successes))
        np.testing.assert_allclose(tm.return_sum, float(jm.return_sum),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm.reward_sum, float(jm.reward_sum),
                                   rtol=1e-5)
        np.testing.assert_allclose(trun.episode_returns.numpy(),
                                   np.asarray(jrun.episode_returns),
                                   rtol=1e-6)
        total = total + tm
    assert total.steps == 2 * 5 * B and total.episodes > 0


def test_metrics_agree_with_timesteps_and_chunks_accumulate():
    """A chunk's metrics equal their host recomputation from its stacked
    timesteps, and chunk metrics add up to the metrics of one long chunk
    from the same start (the same steps)."""
    scene = _scene(3)
    scene[:, tstate.C0] = 0.2  # every sprite in the goal filter
    env = _torch_env(scene, max_episode_length=4, image=False)
    runner = ShardedRunner(env, B)
    start, _ = runner.reset(5)
    key_start = runner.action_key
    state, total = start, Metrics.zero()
    acc = np.zeros(B)
    for _ in range(3):
        state, m, tss = runner.rollout(state, 6, return_timesteps=True)
        episodes, successes, returns, rewards = _host_metrics(tss, acc)
        assert (m.steps, m.episodes, m.successes) == (6 * B, episodes,
                                                      successes)
        np.testing.assert_allclose(m.return_sum, returns, rtol=1e-5)
        np.testing.assert_allclose(m.reward_sum, rewards, rtol=1e-5)
        total = total + m
    assert total.episodes > 0 and 0 <= total.success_rate <= 1

    runner.action_key = key_start
    runner.episode_returns = np.zeros(B, np.float32)
    state2, whole = runner.rollout(start, 18)
    for name in tstate.STATE_FIELDS:
        assert torch.equal(getattr(state2, name), getattr(state, name))
    assert (whole.steps, whole.episodes, whole.successes) == (
        total.steps, total.episodes, total.successes)
    np.testing.assert_allclose(whole.return_sum, total.return_sum,
                               rtol=1e-5)
    np.testing.assert_allclose(whole.mean_return, total.mean_return,
                               rtol=1e-5)


def test_timestep_obs_and_flattened_shapes():
    """timestep_obs keeps the named observations; leaves with more than
    one per-lane dim come back as [T, B, -1] (an image as [T, B, H*W*3])."""
    env = _torch_env(_scene(4), aa=1)
    runner = ShardedRunner(env, B)
    state, _ = runner.reset(0)
    state, _, tss = runner.rollout(state, 2, return_timesteps=True)
    assert tss.step_type.shape == (2, B)
    assert tss.observation["image"].shape == (2, B, 16 * 16 * 3)
    assert tss.observation["image"].dtype == torch.uint8
    assert tss.observation["factors"]["factors"].shape == (2, B, K * 10)
    assert tss.observation["factors"]["mask"].shape == (2, B, K)
    _, _, tss2 = runner.rollout(state, 3, return_timesteps=True,
                                timestep_obs=("success",))
    assert set(tss2.observation) == {"success"}
    assert tss2.observation["success"].shape == (3, B)


def test_evaluate_statistics_against_host_recomputation():
    """evaluate() gives the statistics of the first num_episodes episodes
    that one rollout from the same reset shows in its timesteps."""
    scene = _scene(6)
    scene[:, tstate.C0] = 0.2
    env = _torch_env(scene, max_episode_length=5, image=False)
    ref = ShardedRunner(env, B)
    state, _ = ref.reset(9)
    _, m, tss = ref.rollout(state, 24, return_timesteps=True,
                            timestep_obs=("success",))
    reward = np.nan_to_num(tss.reward.numpy().astype(np.float64))
    last = tss.step_type.numpy() == StepType.LAST
    succ = tss.observation["success"].numpy()
    acc, returns, successes = np.zeros(B), [], []
    for t in range(24):
        acc += reward[t]
        returns += acc[last[t]].tolist()
        successes += succ[t][last[t]].tolist()
        acc[last[t]] = 0.0
    n = len(returns) - 3
    assert n > 3

    stats = ShardedRunner(env, B).evaluate(n, chunk_steps=8, key=9)
    want = np.asarray(returns[:n])
    assert isinstance(stats, EvalStats) and stats.episodes == n
    assert stats.mean_return == pytest.approx(want.mean(), rel=1e-6)
    assert stats.std_return == pytest.approx(want.std(ddof=1), rel=1e-6)
    assert stats.ci95_return == pytest.approx(
        1.96 * want.std(ddof=1) / np.sqrt(n), rel=1e-6)
    assert stats.success_rate == pytest.approx(np.mean(successes[:n]))
    with pytest.raises(RuntimeError, match="max_chunks"):
        ShardedRunner(env, B).evaluate(10**6, chunk_steps=2, max_chunks=2)


def test_evaluate_preserves_inflight_returns():
    scene = _scene(7)
    scene[:, tstate.C0] = 0.2
    env = _torch_env(scene, max_episode_length=6, image=False)
    runner = ShardedRunner(env, B)
    state, _ = runner.reset(5)
    state, _ = runner.rollout(state, 4)
    before = runner.episode_returns.clone()
    key = runner.action_key
    assert before.abs().sum() > 0  # episodes genuinely mid-flight
    runner.evaluate(num_episodes=5, chunk_steps=8)
    assert torch.equal(runner.episode_returns, before)
    assert torch.equal(runner.action_key, key)


def test_guards():
    """The i32 chunk guard, the episode_returns shape check, and
    use_graph=True on a CPU env."""
    env = _torch_env(_scene(8), image=False)
    runner = ShardedRunner(env, B)
    state, _ = runner.reset(0)
    with pytest.raises(ValueError, match="overflow"):
        runner.rollout(state, 2**31 // B)
    with pytest.raises(ValueError, match="positive"):
        runner.rollout(state, 0)
    with pytest.raises(ValueError, match="shape"):
        runner.episode_returns = np.zeros(B + 1, np.float32)
    runner.rollout(state, 1, episode_returns=np.ones(B, np.float32))
    assert runner.episode_returns.shape == (B,)
    with pytest.raises(ValueError, match="CUDA"):
        ShardedRunner(env, B, use_graph=True)
