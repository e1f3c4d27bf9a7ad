"""Process mesh and sharding helpers for the env-batch data-parallel layout.

Counterpart of `spriteworld_tpu/parallel/mesh.py`. Environments are
mutually independent, so the engine's parallelism is pure data parallelism
over a 1-D `('envs',)` axis: each process (a rank of `torch.distributed`)
steps a contiguous slice of the global lanes on its own device, and the
only traffic between ranks is collectives of metric sums and gradients
(NCCL between cards, gloo between CPU processes). Where JAX names a
sharding, the port names the operations that sharding implies:
`env_sharding` slices a global batch to this rank's lanes and gathers local
lanes back into global order; `replicated_sharding` all-reduces values
every rank holds (metric sums, gradients).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from spriteworld_torch.utils import device as device_lib
from spriteworld_torch.utils.device import same_device

ENV_AXIS = "envs"

_TORCHRUN_VARS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         *,
                         device="cuda") -> None:
    """Bring up the process group that joins the ranks.

    `torch.distributed.init_process_group` over
    `tcp://{coordinator_address}` ("host:port") with `num_processes` ranks,
    this process being rank `process_id`. Without an address, the
    variables `torchrun` sets (`MASTER_ADDR`, `RANK`, `WORLD_SIZE`) are
    used where present; where they are not, the process stays alone (a
    mesh of one). Safe to call when the group is already up (no-op). An
    explicit address that cannot be joined raises.

    The backend is NCCL when `device` is CUDA and gloo on the CPU. Each
    rank steps on `cuda:{local_rank}` (`LOCAL_RANK` where `torchrun` sets
    it, else `process_id` modulo the cards this host has), which becomes
    the process's current card.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if not all(v in os.environ for v in _TORCHRUN_VARS):
            return  # one process: the mesh of one
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs "
                             "num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
    cuda = device_lib.resolve(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=init_method, world_size=world,
                            rank=rank)


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """The 1-D `'envs'` axis: `size` ranks, this one `rank`, stepping on
    `device`; `group` is the process group (None for a mesh of one)."""

    size: int
    rank: int
    device: torch.device
    group: Any = None

    @classmethod
    def single(cls, device) -> "EnvMesh":
        """The mesh of one on `device`: what a runner without a mesh uses."""
        return cls(size=1, rank=0, device=torch.device(device))


def env_mesh(device=None) -> EnvMesh:
    """The mesh over every rank of the process group, each stepping on its
    current card (NCCL) or the CPU (gloo); without a group, the mesh of
    one on `device` (default "cuda")."""
    if not dist.is_initialized():
        return EnvMesh.single(device_lib.resolve(device or "cuda"))
    local = (torch.device("cuda", torch.cuda.current_device())
             if dist.get_backend() == "nccl" else torch.device("cpu"))
    if device is not None and not same_device(device, local):
        raise ValueError(f"this rank steps on {local}, not {device}")
    return EnvMesh(size=dist.get_world_size(), rank=dist.get_rank(),
                   device=local, group=dist.group.WORLD)


def _map(fn: Callable, tree):
    """`fn` over the tensors of a nested dict, tuple, list or dataclass."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class EnvSharding:
    """Batch-leading trees split over `'envs'`: rank r holds the r-th
    contiguous slice of the global lanes."""

    mesh: EnvMesh

    def local_size(self, global_size: int) -> int:
        if global_size % self.mesh.size:
            raise ValueError(f"{global_size} lanes do not divide the mesh "
                             f"size {self.mesh.size}")
        return global_size // self.mesh.size

    def shard(self, tree):
        """This rank's lanes of a tree of global batches (views)."""
        def take(x):
            n = self.local_size(x.shape[0])
            return x[self.mesh.rank * n:(self.mesh.rank + 1) * n]
        return _map(take, tree)

    def gather(self, tree, axis: int = 0):
        """Every rank's lanes of a tree of local batches (lanes on `axis`),
        in global lane order, on every rank (one `all_gather` a leaf)."""
        if self.mesh.size == 1:
            return tree

        def gather(x):
            # Bool travels as uint8: not every backend reduces bool.
            raw = x.contiguous().view(torch.uint8) if x.dtype == torch.bool \
                else x.contiguous()
            parts = [torch.empty_like(raw) for _ in range(self.mesh.size)]
            dist.all_gather(parts, raw, group=self.mesh.group)
            out = torch.cat(parts, dim=axis)
            return out.view(torch.bool) if x.dtype == torch.bool else out
        return _map(gather, tree)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Values every rank holds whole: all-reduced across `'envs'`."""

    mesh: EnvMesh

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum"):
        """`tensor` reduced in place over every rank (`op`: "sum" or
        "max"); returns it. A mesh of one leaves it as it is."""
        if self.mesh.size > 1 or self.mesh.group is not None:
            dist.all_reduce(tensor, op={"sum": dist.ReduceOp.SUM,
                                        "max": dist.ReduceOp.MAX}[op],
                            group=self.mesh.group)
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0):
        """`tensor` replaced in place by rank `src`'s; returns it."""
        if self.mesh.size > 1:
            dist.broadcast(tensor, src, group=self.mesh.group)
        return tensor


def env_sharding(mesh: EnvMesh) -> EnvSharding:
    """Sharding of batch-leading tensors: lanes split across 'envs'.

    Applies to every leaf of EnvState/TimeStep batches; they all carry the
    lanes as axis 0."""
    return EnvSharding(mesh)


def replicated_sharding(mesh: EnvMesh) -> Replicated:
    """Replicated values (metric sums, gradients, parameters)."""
    return Replicated(mesh)


def free_port() -> int:
    """A TCP port of this host that is free now (for a coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: Sequence[str], world: int, timeout: float = 120,
              env: Optional[dict] = None, cwd: Optional[str] = None
              ) -> List[str]:
    """Run `world` processes of `python argv... <rank> <world> <address>`
    on this host, each a rank of one group whose coordinator is
    `127.0.0.1:<free port>`, and return their standard outputs in rank
    order. Every process is killed when one fails or the time runs out;
    either raises (RuntimeError, or subprocess.TimeoutExpired), with the
    failing rank's standard error."""
    address = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, *argv, str(rank), str(world), address],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=cwd) for rank in range(world)]
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} of {world} exited with "
                                   f"{p.returncode}:\n{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs
