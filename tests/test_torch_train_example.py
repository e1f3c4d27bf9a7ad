"""Port parity, the trainer: `train_example_torch` against the JAX
package's `train_example` on the CPU.

The same numpy-seeded inputs go through both: the policies with carried
flax parameters (`params_from_flax`), the squashed-Gaussian log-density,
the REINFORCE loss and its gradients (train_example.py:202-215, built here
from `train_example.log_prob_z` and `policy.apply` under
`jax.value_and_grad`), Adam against `optax.adam(2e-3)`, the loss split over
two gloo ranks, the rollout's advantage/valid bookkeeping against a numpy
statement of train_example.py:185-194, and a short CPU training run that
must improve its reward, as tests/test_train_example.py asks of JAX.

Run as a script (`python test_torch_train_example.py <rank> <world>
<address>`), this file is one rank of the two-rank loss check.
"""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

_ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(_ROOT))

import train_example_torch as tt  # noqa: E402
from spriteworld_torch import constants  # noqa: E402
from spriteworld_torch.core import state as state_lib  # noqa: E402
from spriteworld_torch.core.generators import SpriteGenerator  # noqa: E402
from spriteworld_torch.parallel import mesh as mesh_lib  # noqa: E402

T, B, K, NF = 5, 12, 1, 10  # stacked transitions: T steps x B lanes
IMAGE_TOL = 1e-6  # bf16 convs: largest |mu| difference seen 8.9e-08


def loss_inputs(seed=0):
    """Seeded stacked factor observations, masks, z, advantages and
    weights [T, B, ...] (numpy)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (T, B, K, NF)).astype(np.float32),
            rng.uniform(size=(T, B, K)) < 0.9,
            rng.normal(0, 1.5, (T, B, 4)).astype(np.float32),
            rng.normal(0, 0.1, (T, B)).astype(np.float32),
            (rng.uniform(size=(T, B)) < 0.7).astype(np.float32))


def torch_policy(seed=1):
    return tt.Policy((K, NF), generator=torch.Generator().manual_seed(seed))


def flat_grads(policy):
    return torch.cat([p.grad.reshape(-1) for p in policy.parameters()])


# ---------------------------------------------------------------------- #
# One rank of the two-rank loss check (run as a script).

def rank_main(rank: str, world: str, address: str):
    mesh_lib.initialize_multihost(address, int(world), int(rank),
                                  device="cpu")
    mesh = mesh_lib.env_mesh(device="cpu")
    factors, mask, z, advs, ws = loss_inputs()
    lanes = slice(mesh.rank * B // mesh.size,
                  (mesh.rank + 1) * B // mesh.size)
    policy = torch_policy()
    share = tt.reinforce_loss(
        policy, (torch.tensor(factors[:, lanes]),
                 torch.tensor(mask[:, lanes])),
        torch.tensor(z[:, lanes]), torch.tensor(advs[:, lanes]),
        torch.tensor(ws[:, lanes]), mesh)
    share.backward()
    grads = flat_grads(policy)
    replicated = mesh_lib.replicated_sharding(mesh)
    replicated.all_reduce(grads)
    loss = replicated.all_reduce(share.detach().clone())
    print(json.dumps({"loss": float(loss), "grads": grads.tolist()}),
          flush=True)
    torch.distributed.destroy_process_group()
    # Leave at once: gloo's threads can abort the interpreter's own exit
    # (std::terminate) once the group is gone.
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    rank_main(*sys.argv[1:])

# ---------------------------------------------------------------------- #
# The tests (they import JAX; the ranks above do not).

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import train_example as jt  # noqa: E402


def _flax_policy(seed=1):
    factors, mask, *_ = loss_inputs()
    policy = jt.Policy()
    params = policy.init(jax.random.key(seed), jnp.asarray(factors[0]),
                         jnp.asarray(mask[0]))
    return policy, params


def _to_torch(params, module):
    module.load_state_dict(tt.params_from_flax(jax.device_get(params)))
    return module


def _flax_grads_flat(grads, module):
    """JAX gradients in the port's parameter order and layout."""
    sd = tt.params_from_flax(jax.device_get(grads))
    return torch.cat([sd[n].reshape(-1) for n, _ in
                      module.named_parameters()])


def test_policy_with_carried_params_matches_flax():
    policy, params = _flax_policy()
    factors, mask, *_ = loss_inputs(3)
    f, m = factors.reshape(-1, K, NF), mask.reshape(-1, K)
    mu, log_std = policy.apply(params, jnp.asarray(f), jnp.asarray(m))
    port = _to_torch(params, tt.Policy((K, NF)))
    with torch.no_grad():
        tmu, tlog_std = port(torch.tensor(f), torch.tensor(m))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tlog_std.detach().numpy(),
                                  np.asarray(log_std))


@pytest.mark.parametrize("size", [16, 15])
def test_conv_policy_with_carried_params_matches_flax(size):
    """bf16 on both sides, at an even size and an odd one (asymmetric
    SAME padding). The convolutions round to bf16 alike on both sides; the
    float32 head sums in other orders: the largest |mu| difference seen
    was 8.9e-08 (at 16x16) against a tolerance of IMAGE_TOL."""
    rng = np.random.default_rng(size)
    image = rng.integers(0, 256, (6, size, size, 3)).astype(np.uint8)
    policy = jt.ConvPolicy()
    params = policy.init(jax.random.key(2), jnp.asarray(image))
    mu, log_std = policy.apply(params, jnp.asarray(image))
    port = _to_torch(params, tt.ConvPolicy((size, size)))
    with torch.no_grad():
        tmu, tlog_std = port(torch.tensor(image))
    assert tmu.dtype == torch.float32
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=0,
                               atol=IMAGE_TOL)
    np.testing.assert_array_equal(tlog_std.detach().numpy(),
                                  np.asarray(log_std))
    # Flattening in NCHW order would be off by 0.17 at 16x16; at 15x15 a
    # padding of 1 on every side would not even fit the Dense.
    assert np.abs(np.asarray(mu)).max() > 1e4 * IMAGE_TOL


def test_same_padding_is_flax_same():
    assert tt.same_padding(64) == (1, 1)
    assert tt.same_padding(15) == (1, 2)
    assert tt.same_padding(8) == (1, 1)
    assert tt.same_padding(2) == (1, 1)
    assert tt.same_padding(1) == (1, 2)


def test_init_is_lecun_normal():
    policy = tt.ConvPolicy(generator=torch.Generator().manual_seed(0))
    for name, fan_in in (("conv_1", 4 * 4 * 16), ("dense_0", 64 * 8 * 8)):
        w = getattr(policy, name).weight.detach().numpy().ravel()
        std = np.sqrt(1.0 / fan_in)
        assert abs(w.std() / std - 1) < 0.05, name
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7
        assert not getattr(policy, name).bias.detach().any()
    assert torch.equal(policy.log_std.detach(), torch.full((4,), -1.0))


def test_log_prob_z_matches():
    rng = np.random.default_rng(4)
    mu = rng.normal(0, 1, (64, 4)).astype(np.float32)
    log_std = rng.normal(-1, 0.3, (64, 4)).astype(np.float32)
    z = rng.normal(0, 2, (64, 4)).astype(np.float32)
    want = jt.log_prob_z(jnp.asarray(mu), jnp.asarray(log_std),
                         jnp.asarray(z))
    got = tt.log_prob_z(torch.tensor(mu), torch.tensor(log_std),
                        torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _jax_loss_and_grads(policy, params, inputs):
    """train_example.py:202-215 (loss_fn), from the JAX package's own
    log_prob_z and policy.apply."""
    factors, mask, z, advs, ws = (jnp.asarray(x) for x in inputs)

    def loss_fn(params):
        flat = lambda x: jnp.swapaxes(x, 0, 1).reshape(  # noqa: E731
            (-1,) + x.shape[2:])
        mu, log_std = policy.apply(params, flat(factors), flat(mask))
        logp = jt.log_prob_z(mu, log_std, flat(z))
        a = flat(advs) - advs.mean()
        w = flat(ws)
        return -(logp * a * w).sum() / jnp.maximum(w.sum(), 1.0)

    return jax.value_and_grad(loss_fn)(params)


def _torch_loss_and_grads(port, inputs):
    port.zero_grad()
    factors, mask, z, advs, ws = (torch.tensor(x) for x in inputs)
    loss = tt.reinforce_loss(port, (factors, mask), z, advs, ws)
    loss.backward()
    return loss.detach(), flat_grads(port)


def test_reinforce_loss_and_grads_match_jax():
    policy, params = _flax_policy()
    inputs = loss_inputs()
    loss, grads = _jax_loss_and_grads(policy, params, inputs)
    port = _to_torch(params, tt.Policy((K, NF)))
    tloss, tgrads = _torch_loss_and_grads(port, inputs)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5)
    want = _flax_grads_flat(grads, port)
    np.testing.assert_allclose(tgrads.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_adam_matches_optax():
    """Three steps from the same parameters with the same seeded
    gradients: torch.optim.Adam as the trainer builds it against
    optax.adam(2e-3)."""
    _, params = _flax_policy()
    port = _to_torch(params, tt.Policy((K, NF)))
    opt = torch.optim.Adam(port.parameters(), lr=2e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    tx = optax.adam(2e-3)
    state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(0, 1e-2, x.shape), jnp.float32),
            params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        sd = tt.params_from_flax(jax.device_get(grads))
        for name, p in port.named_parameters():
            p.grad = sd[name].clone()
        opt.step()
    want = tt.params_from_flax(jax.device_get(params))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_loss_over_two_gloo_ranks_equals_one_process():
    """Each rank holds half the lanes; with the statistics all-reduced
    before the loss and the gradients after, the loss and gradients are
    those of one process over all the transitions."""
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES" and not k.startswith("JAX_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    outs = [json.loads(o.strip().splitlines()[-1]) for o in
            mesh_lib.run_ranks([__file__], 2, timeout=120, env=env)]
    loss, grads = _torch_loss_and_grads(torch_policy(), loss_inputs())
    for o in outs:
        np.testing.assert_allclose(o["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(o["grads"], np.float32),
                                   grads.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(grads.abs().max()))
    assert outs[0] == outs[1]


class _InjectedScenes(SpriteGenerator):
    """Every reset draws these scenes, f32[B, 1, 10] (one sprite a lane)."""

    def __init__(self, factors):
        self._factors = torch.tensor(factors)
        self.max_sprites = 1

    def sample(self, key):
        batch = key.shape[0]
        assert batch == self._factors.shape[0]
        return (self._factors.to(key.device).clone(),
                torch.ones(batch, dtype=torch.int32, device=key.device))


_BUILD_TRAIN_ENV = tt.build_train_env


def _injected_env(factors):
    """build_train_env on the CPU with injected scenes."""
    env = _BUILD_TRAIN_ENV(device="cpu", seed=7)
    env._init_sprites = _InjectedScenes(factors)
    return env


def test_rollout_bookkeeping_matches_numpy(monkeypatch):
    """25 steps (episodes end at 20, so lanes restart mid-rollout) on
    injected scenes with injected actions; the stacked observations,
    rewards, valid masks and advantages against a replay of the same
    actions on a fresh env and a numpy statement of
    train_example.py:185-194."""
    steps, lanes = 25, 6
    rng = np.random.default_rng(6)
    scenes = np.tile(state_lib.DEFAULT_FACTORS, (lanes, 1, 1))
    scenes[:, 0, state_lib.X] = rng.integers(51, 205, lanes) / 256
    scenes[:, 0, state_lib.Y] = rng.integers(51, 205, lanes) / 256
    scenes[:, 0, state_lib.SHAPE] = [
        constants.shape_id(("circle", "square")[i % 2]) for i in range(lanes)]
    scenes[:, 0, state_lib.SCALE] = 0.3
    scenes[:, 0, state_lib.C0] = rng.uniform(0, 1, lanes)
    zs = rng.normal(0, 1.5, (steps, lanes, 4)).astype(np.float32)
    calls = []

    def injected(mu, log_std, keys):
        z = torch.tensor(zs[len(calls)])
        calls.append(1)
        return torch.sigmoid(z), z

    monkeypatch.setattr(tt, "sample_action_z", injected)
    monkeypatch.setattr(tt, "build_train_env",
                        lambda *a, **k: _injected_env(scenes))
    trainer = tt.Trainer(lanes, steps, seed=7, device="cpu")
    ro = trainer.rollout().clone()
    assert len(calls) == steps

    env = _injected_env(scenes)
    state, ts = env.reset_batch(lanes)
    rewards, firsts, obs = [], [], [tt.Policy.inputs(ts.observation)]
    for t in range(steps):
        state, ts = env.step_batch(state, torch.sigmoid(torch.tensor(zs[t])))
        rewards.append(np.nan_to_num(ts.reward.numpy()))
        firsts.append(ts.first().numpy())
        obs.append(tt.Policy.inputs(ts.observation))
    rewards, firsts = np.asarray(rewards), np.asarray(firsts)
    assert firsts[1:].any()  # lanes restarted inside the rollout

    prev_r = np.zeros(lanes, np.float32)
    prev_ok = np.zeros(lanes, bool)
    for t in range(steps):
        valid = prev_ok & ~firsts[t]
        adv = np.where(valid, rewards[t] - prev_r, np.float32(0))
        np.testing.assert_array_equal(ro.valid[t].numpy(),
                                      valid.astype(np.float32))
        np.testing.assert_array_equal(ro.adv[t].numpy(), adv)
        np.testing.assert_array_equal(ro.reward[t].numpy(), rewards[t])
        np.testing.assert_array_equal(ro.z[t].numpy(), zs[t])
        for got, want in zip(ro.obs, obs[t]):
            assert torch.equal(got[t], want)
        prev_r, prev_ok = rewards[t], ~firsts[t]


def test_train_runs_and_improves():
    _, history = tt.train(num_envs=64, iters=60, rollout_steps=10, seed=0,
                          log_every=59, device="cpu")
    first, last = history[0], history[-1]
    assert np.isfinite(first["loss"]) and np.isfinite(last["loss"])
    # Dense rewards: a learning policy must beat its own untrained start.
    assert last["reward_mean"] > first["reward_mean"]


def test_image_policy_train_runs():
    stats = {}
    _, history = tt.train(num_envs=8, iters=3, rollout_steps=4, seed=0,
                          log_every=2, obs_mode="image", image_size=(16, 16),
                          device="cpu", stats=stats)
    for m in history:
        assert np.isfinite(m["loss"]) and np.isfinite(m["reward_mean"])
    assert stats["env_steps_per_sec"] > 0
    assert stats["trainer"].buffers.obs[0].shape == (4, 8, 16, 16, 3)


def test_lanes_that_do_not_divide_the_mesh_raise():
    mesh = mesh_lib.EnvMesh(size=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide the mesh size 3"):
        tt.Trainer(16, 4, mesh=mesh, device="cpu")
