"""End-to-end training example on the card: env lanes feeding a REINFORCE
learner.

Counterpart of train_example.py. B environment lanes step in lockstep and
a policy-gradient update follows each rollout. The rollout (T steps of the
policy's forward, the env step with its render, the reward-delta
advantages) is one step captured as a CUDA graph and replayed T times,
through the runner's mechanism (`core.step_graph.StepGraph`: rejection
deferred to a device flag, an eager re-run where the flag is set); it
makes no host sync. Randomness is keyed as in train_example.py: the
trainer carries a key, `key(seed)` split into itself, an init key (unused:
the parameters come from a torch.Generator of the seed) and the reset key,
whose split over the global lanes gives the lanes their keys; each rollout
step splits the carried key into the next one and the step's, whose split
over the global lanes gives each lane its action noise key. The update
is eager: one batched re-application of the policy over the T x B stored
transitions, autograd, and Adam (optax's `adam(2e-3)`). The device is read
only at log iterations.

Under a mesh (`parallel.mesh`: `torchrun`, or `initialize_multihost`),
parameters are replicated and lanes sharded: each rank rolls out
`num_envs / ranks` lanes, the loss's statistics (the advantage mean and the
weight sum) are all-reduced before the loss, the gradients after
`backward`, and every rank applies the same Adam step. Rank 0's initial
parameters are broadcast once.

The task is the BASELINE goal-finding env with SpriteFactors observations:
the policy reads the factor slab, emits a sigmoid-squashed Gaussian over
the 4-d SelectMove action, and learns to click the target sprite and drag
it toward the goal. --obs image swaps in the rendered 64x64 RGB observation
(at anti_aliasing=1 on the card: the packed_raster kernel) and a bf16 conv
policy.

Usage:
  python train_example_torch.py [--num_envs 1024] [--iters 200] [--steps 20]
                                [--seed 0] [--obs factors|image]
                                [--device cuda|cpu]
  torchrun --nproc_per_node N train_example_torch.py [...]   # N ranks
"""

import argparse
import contextlib
import dataclasses
import math
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from spriteworld_torch.core import actions as action_lib
from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import environment as env_lib
from spriteworld_torch.core import generators as sprite_generators
from spriteworld_torch.core import renderers, tasks
from spriteworld_torch.core.state import STATE_FIELDS
from spriteworld_torch.ops import lane_random
from spriteworld_torch.parallel import (StepGraph, env_mesh,
                                        initialize_multihost,
                                        replicated_sharding)
from spriteworld_torch.parallel.mesh import EnvMesh
from spriteworld_torch.parallel.runner import _to_host
from spriteworld_torch.utils import device as device_lib


def build_train_env(obs: str = "factors", image_size=(64, 64),
                    device="cuda", seed: int = 0):
    """Single-sprite goal finding with factor or image observations
    (train_example.build_train_env): one sprite of scale 0.3, circle or
    square, an unfiltered dense FindGoalPosition reward and a full-range
    SelectMove. obs="image" renders 64x64 HSV images at anti_aliasing=1."""
    dist_ = distribs.Product([
        distribs.Continuous("x", 0.2, 0.8),
        distribs.Continuous("y", 0.2, 0.8),
        distribs.Discrete("shape", ["circle", "square"]),
        distribs.Discrete("scale", [0.3]),
        distribs.Continuous("c0", 0.0, 1.0),
    ])
    task = tasks.FindGoalPosition(
        goal_position=(0.5, 0.5), terminate_distance=0.08)
    if obs == "image":
        obs_renderers = {
            "image": renderers.ImageRenderer(image_size, color_to_rgb="hsv"),
            "success": renderers.Success()}
    else:
        obs_renderers = {"factors": renderers.SpriteFactors(),
                         "success": renderers.Success()}
    return env_lib.Environment(
        task=task,
        action_space=action_lib.SelectMove(scale=0.5),
        renderers=obs_renderers,
        init_sprites=sprite_generators.generate_sprites(dist_, 1),
        max_episode_length=20,
        metadata={"name": f"train_example_goal_finding_{obs}"},
        device=device, seed=seed)


# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# lecun_normal divides by it so the truncated draw keeps variance 1/fan_in.
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """flax's lecun_normal: a normal of std sqrt(1/fan_in)/0.8796 cut at
    two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def _flax_init(module: nn.Module, generator: Optional[torch.Generator]):
    """Linear and Conv2d kernels lecun_normal, biases zero, as flax's
    Dense and Conv are initialised."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            nn.init.zeros_(m.bias)


class Policy(nn.Module):
    """MLP over the flattened factor slab -> squashed-Gaussian action
    (train_example.Policy)."""

    def __init__(self, input_shape: Tuple[int, int], hidden: int = 128,
                 action_dim: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k, f = input_shape
        self.dense_0 = nn.Linear(k * f, hidden)
        self.dense_1 = nn.Linear(hidden, hidden)
        self.dense_2 = nn.Linear(hidden, action_dim)
        self.log_std = nn.Parameter(torch.full((action_dim,), -1.0))
        _flax_init(self, generator)

    @staticmethod
    def inputs(obs) -> tuple:
        """The policy's inputs in an observation of the env."""
        return obs["factors"]["factors"], obs["factors"]["mask"]

    def forward(self, factors, mask):
        # factors [B, K, F]; dead slots are zeroed by the mask so padding
        # cannot leak into the policy.
        x = (factors * mask[..., None]).reshape(factors.shape[0], -1)
        x = F.relu(self.dense_0(x))
        x = F.relu(self.dense_1(x))
        mu = self.dense_2(x)
        return mu, self.log_std.expand_as(mu)


def same_padding(size: int, kernel: int = 4, stride: int = 2):
    """flax's "SAME" padding (lo, hi) of one spatial axis: the output is
    ceil(size / stride) and the extra row, where the total is odd, goes
    after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvPolicy(nn.Module):
    """CNN over rendered RGB observations -> squashed-Gaussian action
    (train_example.ConvPolicy).

    Three 4x4 stride-2 convs with flax's "SAME" padding compute in bf16,
    their inputs, weights and biases cast to bf16 as flax's
    `dtype=bfloat16` casts them (the bias added after the convolution's
    rounding); the activations are flattened in NHWC order, as flax
    flattens them, so that carried weights line up; the head and the
    distribution parameters stay float32.
    """

    def __init__(self, image_size=(64, 64), hidden: int = 128,
                 action_dim: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_0 = nn.Conv2d(3, 16, 4, stride=2)
        self.conv_1 = nn.Conv2d(16, 32, 4, stride=2)
        self.conv_2 = nn.Conv2d(32, 64, 4, stride=2)
        h, w = image_size
        for _ in range(3):
            h, w = -(-h // 2), -(-w // 2)
        self.dense_0 = nn.Linear(64 * h * w, hidden)
        self.dense_1 = nn.Linear(hidden, action_dim)
        self.log_std = nn.Parameter(torch.full((action_dim,), -1.0))
        # Divided by as a tensor: the card divides by a Python scalar
        # through its reciprocal, which rounds otherwise.
        self.register_buffer("_max_value", torch.tensor(255.0),
                             persistent=False)
        _flax_init(self, generator)

    @staticmethod
    def inputs(obs) -> tuple:
        return (obs["image"],)

    def forward(self, image):
        x = image.to(torch.bfloat16) / self._max_value  # u8[B, H, W, 3]
        x = x.permute(0, 3, 1, 2)
        for conv in (self.conv_0, self.conv_1, self.conv_2):
            pad_h = same_padding(x.shape[2])
            pad_w = same_padding(x.shape[3])
            x = F.pad(x, pad_w + pad_h)
            x = F.conv2d(x, conv.weight.to(torch.bfloat16), None, stride=2)
            x = F.relu(x + conv.bias.to(torch.bfloat16)[:, None, None])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
        x = F.relu(self.dense_0(x))
        mu = self.dense_1(x)
        return mu, self.log_std.expand_as(mu)


def params_from_flax(params) -> dict:
    """The `state_dict` of the port's Policy or ConvPolicy from the JAX
    package's flax parameters (a tree of arrays, with or without the
    top-level "params"): Dense kernels [in, out] transposed, Conv kernels
    [kh, kw, in, out] permuted to [out, in, kh, kw], biases and log_std as
    they are."""
    tree = params.get("params", params)
    out = {}
    for name, leaf in tree.items():
        if name == "log_std":
            out[name] = torch.tensor(np.asarray(leaf, np.float32))
            continue
        kernel = np.asarray(leaf["kernel"], np.float32)
        weight = kernel.T if kernel.ndim == 2 \
            else kernel.transpose(3, 2, 0, 1)
        out[f"{name.lower()}.weight"] = torch.tensor(
            np.ascontiguousarray(weight))
        out[f"{name.lower()}.bias"] = torch.tensor(
            np.asarray(leaf["bias"], np.float32))
    return out


def sample_action_z(mu, log_std, keys: torch.Tensor):
    """a = sigmoid(z), z ~ N(mu, std); returns (action, z). Lane b's noise
    comes from its key `keys[b]` (keys int32[B, 2]).

    The pre-squash z is kept so the update can recompute log-probs for
    the stored transitions in one batch."""
    std = torch.exp(log_std)
    noise = lane_random.normal(keys, mu.shape[-1], mu.dtype)
    z = mu + std * noise
    return torch.sigmoid(z), z


def log_prob_z(mu, log_std, z):
    """log-density of a = sigmoid(z) under the squashed Gaussian."""
    std = torch.exp(log_std)
    # Gaussian log-density + sigmoid change-of-variables.
    logp = -0.5 * (((z - mu) / std) ** 2 + 2 * log_std
                   + math.log(2 * math.pi))
    log_det = F.logsigmoid(z) + F.logsigmoid(-z)
    return (logp - log_det).sum(-1)


def reinforce_loss(policy, obs_t, z_t, advs, ws,
                   mesh: Optional[EnvMesh] = None):
    """train_example's loss_fn (train_example.py:202-215): one batched
    re-application of `policy` over the T x B transitions (`obs_t`, a
    tuple of the policy's stacked [T, B, ...] inputs; `z_t` [T, B, A];
    `advs` and `ws` [T, B]), the advantages centred by their mean over all
    T x B entries (masked ones included), the sum divided by
    max(sum(ws), 1).

    Under `mesh` the advantage sum, the count and sum(ws) are all-reduced
    first, so the statistics are global, and the value is this rank's
    share: the shares sum to the loss over every rank's transitions, and
    their gradients, all-reduced, to its gradient.
    """
    def flat(x):  # [T, B, ...] -> [B * T, ...], lanes outermost
        return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))

    mu, log_std = policy(*(flat(x) for x in obs_t))
    logp = log_prob_z(mu, log_std, flat(z_t))
    stats = torch.stack([advs.sum(), advs.new_full((), advs.numel()),
                         ws.sum()]).detach()
    if mesh is not None:
        replicated_sharding(mesh).all_reduce(stats)
    advs = flat(advs) - stats[0] / stats[1]
    ws = flat(ws)
    return -(logp * advs * ws).sum() / torch.clamp(stats[2], min=1.0)


@contextlib.contextmanager
def _deterministic_convs():
    """cuDNN held to deterministic algorithms inside the block, so that a
    captured rollout's convolutions are those of the eager one."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@dataclasses.dataclass
class Rollout:
    """One rollout's stacked transitions on the device, [T, B_local, ...]:
    the policy's inputs, the pre-squash actions, the reward-delta
    advantages, the valid mask (float32), the rewards (NaN as 0) and the
    success flags."""

    obs: tuple
    z: torch.Tensor
    adv: torch.Tensor
    valid: torch.Tensor
    reward: torch.Tensor
    success: torch.Tensor

    def clone(self) -> "Rollout":
        return Rollout(tuple(x.clone() for x in self.obs),
                       *(getattr(self, f.name).clone()
                         for f in dataclasses.fields(self)[1:]))


class Trainer:
    """The training loop's pieces: env lanes, policy, Adam, a captured
    rollout and an eager update. `train()` drives it; chip_smoke.py also
    reaches inside (the graph rollout against the eager one).

    On a CUDA env the rollout step is captured at the first `rollout()`
    (after one eager warm-up step, as `ShardedRunner` captures its step);
    `rollout(use_graph=False)` runs the same step eagerly.
    """

    def __init__(self, num_envs: int = 1024, rollout_steps: int = 20,
                 seed: int = 0, obs_mode: str = "factors",
                 image_size=(64, 64), mesh: Optional[EnvMesh] = None,
                 device="cuda"):
        self.mesh = mesh if mesh is not None \
            else EnvMesh.single(device_lib.resolve(device))
        if num_envs % self.mesh.size:
            raise ValueError(
                f"num_envs={num_envs} must divide the mesh size "
                f"{self.mesh.size}.")
        self.num_envs = int(num_envs)
        self.local_envs = self.num_envs // self.mesh.size
        self.rollout_steps = int(rollout_steps)
        dev = self.mesh.device
        self.env = build_train_env(obs_mode, image_size, dev, seed)
        self._repl = replicated_sharding(self.mesh)
        # train_example.py: key, k_init, k_reset = split(key(seed), 3).
        keys = lane_random.split(lane_random.key(seed, dev), 3)
        self.key = keys[0].clone()  # carried, split each rollout step

        init = torch.Generator().manual_seed(int(seed))
        if obs_mode == "image":
            policy = ConvPolicy(image_size, generator=init)
        else:
            kf = self.env.observation_spec()["factors"]["factors"][0]
            policy = Policy(kf, generator=init)
        self.policy = policy.to(dev)
        with torch.no_grad():
            for p in self.policy.parameters():
                self._repl.broadcast(p.data)
        self.optimizer = torch.optim.Adam(
            self.policy.parameters(), lr=2e-3, betas=(0.9, 0.999), eps=1e-8)

        state, ts = self.env.reset_batch(self._global_split(keys[2]))
        self.state = state
        self.obs = tuple(x.clone() for x in self.policy.inputs(ts.observation))
        b, t = self.local_envs, self.rollout_steps
        self.prev_r = torch.zeros(b, device=dev)
        self.prev_ok = torch.zeros(b, dtype=torch.bool, device=dev)
        self.t = torch.zeros(1, dtype=torch.int64, device=dev)
        self.pending = torch.zeros((), dtype=torch.bool, device=dev)
        z_dim = self.policy.log_std.shape[0]
        self.buffers = Rollout(
            obs=tuple(torch.empty((t,) + tuple(x.shape), dtype=x.dtype,
                                  device=dev) for x in self.obs),
            z=torch.empty((t, b, z_dim), device=dev),
            adv=torch.empty((t, b), device=dev),
            valid=torch.empty((t, b), device=dev),
            reward=torch.empty((t, b), device=dev),
            success=torch.empty((t, b), dtype=torch.bool, device=dev))
        self.use_graph = dev.type == "cuda"
        self._programs = {}
        # Rollouts run again because a rejection node had elements still
        # pending after its first rounds.
        self.reruns = 0

    # ------------------------------------------------------------------ #
    def _global_split(self, key: torch.Tensor) -> torch.Tensor:
        """This rank's slice of `split(key, num_envs)`."""
        return lane_random.split(key, self.local_envs,
                                 start=self.mesh.rank * self.local_envs)

    def _step(self):
        """One rollout step on the carried tensors, in place
        (train_example.py:176-193)."""
        with torch.no_grad(), _deterministic_convs():
            keys = lane_random.split(self.key, 2)
            self.key.copy_(keys[0])
            mu, log_std = self.policy(*self.obs)
            actions, z = sample_action_z(mu, log_std,
                                         self._global_split(keys[1]))
            state, ts = self.env.step_batch(self.state, actions)
            reward = torch.nan_to_num(ts.reward)
            # FindGoalPosition rewards track goal distance, so the reward
            # DELTA within an episode isolates this step's action from the
            # scene's standing distance. Steps without a same-episode
            # predecessor (FIRST, or right after one) are masked out.
            first = ts.first()
            valid = self.prev_ok & ~first
            adv = torch.where(valid, reward - self.prev_r, 0.0)
            out = (*self.obs, z, adv, valid.float(), reward,
                   ts.observation["success"])
            bufs = (*self.buffers.obs, self.buffers.z, self.buffers.adv,
                    self.buffers.valid, self.buffers.reward,
                    self.buffers.success)
            for buf, x in zip(bufs, out):
                buf.index_copy_(0, self.t, x.unsqueeze(0))
            for n in STATE_FIELDS:
                getattr(self.state, n).copy_(getattr(state, n))
            for buf, x in zip(self.obs,
                              self.policy.inputs(ts.observation)):
                buf.copy_(x)
            self.prev_r.copy_(reward)
            self.prev_ok.copy_(~first)
            self.t.add_(1)

    def _program(self, use_graph: bool) -> StepGraph:
        """The rollout step, built at first use; a capture's warm-up and
        captured steps leave the carried state as they found it."""
        if use_graph not in self._programs:
            point = self.save_point()
            self._start()
            self._programs[use_graph] = StepGraph(
                self._step, self.pending, use_graph)
            self.restore_point(point)
        return self._programs[use_graph]

    def save_point(self):
        """(state, policy inputs, key): where a rollout starts, as device
        copies."""
        return (self.state.clone(),
                tuple(x.clone() for x in self.obs),
                self.key.clone())

    def restore_point(self, point):
        state, obs, key = point
        for n in STATE_FIELDS:
            getattr(self.state, n).copy_(getattr(state, n))
        for buf, x in zip(self.obs, obs):
            buf.copy_(x)
        self.key.copy_(key)

    def _start(self):
        for x in (self.prev_r, self.prev_ok, self.t, self.pending):
            x.zero_()

    def rollout(self, use_graph: Optional[bool] = None) -> Rollout:
        """T steps from the carried state; returns the stacked transitions
        (the trainer's buffers, overwritten by the next rollout).

        A graph's rollout makes no host sync unless the captured step holds
        a rejection node: then the device flag is read, and where it is set
        the rollout runs again eagerly with host-checked rejection from the
        same start. The eager rollout checks rejection on the host as it
        goes (no host sync where the env has no rejection node)."""
        use_graph = self.use_graph if use_graph is None else use_graph
        program = self._program(use_graph)
        start = self.save_point() if program.rejects else None
        self._start()
        program.run(self.rollout_steps, self._step, defer=use_graph)
        if start is not None and _to_host(self.pending):
            self.reruns += 1
            self.restore_point(start)
            self._start()
            program.run(self.rollout_steps, self._step, defer=False)
        return self.buffers

    def update(self, rollout: Rollout) -> torch.Tensor:
        """One REINFORCE update from `rollout`; returns the device tensor
        [loss, reward sum, success count, transitions], summed over the
        ranks (no host read)."""
        self.optimizer.zero_grad()
        loss = reinforce_loss(self.policy, rollout.obs, rollout.z,
                              rollout.adv, rollout.valid, self.mesh)
        loss.backward()
        if self.mesh.size > 1 or self.mesh.group is not None:
            grads = [p.grad for p in self.policy.parameters()]
            flat = torch.cat([g.reshape(-1) for g in grads])
            self._repl.all_reduce(flat)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        self.optimizer.step()
        metrics = torch.stack([
            loss.detach(), rollout.reward.sum(),
            rollout.success.sum(dtype=torch.float32),
            rollout.reward.new_full((), rollout.reward.numel())])
        return self._repl.all_reduce(metrics)


def _metrics(host) -> dict:
    loss, reward_sum, successes, count = host
    return {"loss": loss, "reward_mean": reward_sum / count,
            "success_rate": successes / count}


class _Clock:
    """Stamps on the device's clock (CUDA events) or the host's."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def stamp(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def train(num_envs=1024, iters=200, rollout_steps=20, seed=0,
          log_every=20, mesh=None, obs_mode="factors", image_size=(64, 64),
          device="cuda", stats: Optional[dict] = None):
    """train_example.train on the port; returns (policy, history), history
    holding the logged iterations' {loss, reward_mean, success_rate}.

    `stats`, where given, receives the steady-state env-steps/s (every
    iteration after the first, which captures the graph), the median
    rollout and update milliseconds of those iterations (device time
    between events on the card), and the `trainer`."""
    trainer = Trainer(num_envs, rollout_steps, seed, obs_mode, image_size,
                      mesh, device)
    lead = trainer.mesh.rank == 0
    history = []
    if stats is not None:
        stats["trainer"] = trainer
    if iters <= 0:
        return trainer.policy, history
    clock = _Clock(trainer.mesh.device)
    stamps = []
    t1 = None
    m = None
    for it in range(iters):
        a = clock.stamp()
        rollout = trainer.rollout()
        b = clock.stamp()
        m = trainer.update(rollout)
        stamps.append((a, b, clock.stamp()))
        if it == 0:
            _to_host(m)  # sync: everything after this is steady state
            t1 = time.perf_counter()
        if it % log_every == 0 or it == iters - 1:
            logged = _metrics(_to_host(m))
            history.append(logged)
            if lead:
                print(f"iter {it:4d}  loss {logged['loss']:+8.4f}  "
                      f"reward {logged['reward_mean']:+8.5f}  "
                      f"success {logged['success_rate']:.3f}", flush=True)
    _to_host(m)
    if iters > 1:
        sps = num_envs * rollout_steps * (iters - 1) / (
            time.perf_counter() - t1)
        rollout_ms = float(np.median([clock.ms(a, b)
                                      for a, b, _ in stamps[1:]]))
        update_ms = float(np.median([clock.ms(b, c)
                                     for _, b, c in stamps[1:]]))
        if stats is not None:
            stats.update(env_steps_per_sec=sps, rollout_ms=rollout_ms,
                         update_ms=update_ms)
        if lead:
            where = (device_lib.card_name_and_power_limit()
                     if trainer.mesh.device.type == "cuda" else "the CPU")
            print(f"steady-state training throughput: {sps / 1e6:.2f}M "
                  "env-steps/s (rollout + REINFORCE update, post-capture); "
                  f"rollout {rollout_ms:.3f} ms, update {update_ms:.3f} ms "
                  f"an iteration (median); {trainer.mesh.size} rank(s) on "
                  f"{where}", flush=True)
    return trainer.policy, history


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--obs", default="factors", choices=["factors", "image"],
                   help="observation/policy pair: factor-slab MLP or "
                        "rendered-RGB CNN (the full render->conv pipeline)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; under torchrun each rank "
                        "takes cuda:LOCAL_RANK")
    args = p.parse_args(argv)
    initialize_multihost(device=args.device)  # a no-op without torchrun
    mesh = env_mesh(args.device) if dist.is_initialized() else None
    train(num_envs=args.num_envs, iters=args.iters,
          rollout_steps=args.steps, seed=args.seed, obs_mode=args.obs,
          mesh=mesh, device=args.device)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
