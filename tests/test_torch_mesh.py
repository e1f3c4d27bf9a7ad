"""The port's mesh: `spriteworld_torch.parallel.mesh` and
`ShardedRunner(mesh=...)` over `torch.distributed` (gloo) on the CPU.

The JAX runner keys every lane, so its rollout is the same on every mesh
shape (tests/test_distributed.py). The port draws from one generator a
rank, seeded `rank_seed(seed, rank)`, so the checks here are the port's
own: a one-rank group equals the runner without a mesh; two ranks of 8
lanes equal two runs without a mesh of 8 lanes each, seeded as the ranks
are, exactly (counts, float32 sums added once, image checksums, states);
`evaluate` agrees on both ranks; a checkpoint gathered under two ranks
restores lane for lane under one, and a two-rank resume continues equal to
the run it was cut from.

Run as a script (`python test_torch_mesh.py <task> <dir> <rank> <world>
<address>`), this file is one rank of such a group (`mesh.run_ranks`).
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

from spriteworld_torch.core import actions  # noqa: E402
from spriteworld_torch.core import distributions as distribs  # noqa: E402
from spriteworld_torch.core import environment  # noqa: E402
from spriteworld_torch.core import generators  # noqa: E402
from spriteworld_torch.core import renderers  # noqa: E402
from spriteworld_torch.core import tasks  # noqa: E402
from spriteworld_torch.core.state import STATE_FIELDS  # noqa: E402
from spriteworld_torch.parallel import checkpoint  # noqa: E402
from spriteworld_torch.parallel import mesh as mesh_lib  # noqa: E402
from spriteworld_torch.parallel import runner as runner_lib  # noqa: E402

NUM_ENVS = 16  # global lanes: 8 a rank on two ranks
SEED = 3
STEPS_BEFORE = 7  # rollout before the checkpoint
STEPS_AFTER = 9  # continuation after it
EVAL_EPISODES = 24


def build_env(seed=0):
    """tests/_dist_worker.py's scene on the port: three squares and
    triangles, goal finding with 5-step episodes, factors, a 16x16 image
    at anti_aliasing=1 and success; with colours drawn, so that the image
    checksum counts pixels (that scene's sprites are black on black)."""
    return environment.Environment(
        task=tasks.FindGoalPosition(
            goal_position=(0.5, 0.5), terminate_distance=0.1),
        action_space=actions.SelectMove(scale=0.25),
        renderers={"factors": renderers.SpriteFactors(),
                   "image": renderers.ImageRenderer((16, 16),
                                                    color_to_rgb="hsv"),
                   "success": renderers.Success()},
        init_sprites=generators.generate_sprites(
            distribs.Product([
                distribs.Continuous("x", 0.2, 0.8),
                distribs.Continuous("y", 0.2, 0.8),
                distribs.Discrete("shape", ["square", "triangle"]),
                distribs.Continuous("scale", 0.1, 0.2),
                distribs.Continuous("c0", 0.3, 1.0),
                distribs.Continuous("c1", 0.3, 1.0),
                distribs.Continuous("c2", 0.3, 1.0),
            ]), num_sprites=3),
        max_episode_length=5, device="cpu", seed=seed)


def image_sum(env, state) -> int:
    """Pixel checksum of the states' rendered images (exact, int64)."""
    success = env.task.success(state.factors, state.num_sprites)
    img = env.observation_batch(state.factors, state.num_sprites,
                                success)["image"]
    return int(img.to(torch.int64).sum())


def metrics_dict(m) -> dict:
    return {"episodes": m.episodes, "successes": m.successes,
            "steps": m.steps, "return_sum": m.return_sum,
            "reward_sum": m.reward_sum}


def checkpoint_like(env, lanes: int, ranks: int = 2) -> dict:
    """The tree `rank_run` saves: global lanes and each rank's generator
    state in a row."""
    gen = env.generator.get_state()
    return {"env_state": env.initial_state(lanes),
            "episode_returns": torch.zeros(lanes),
            "generators": torch.zeros((ranks, gen.numel()),
                                      dtype=torch.uint8)}


# ---------------------------------------------------------------------- #
# One rank of a group (run as a script).

def rank_run(mesh, out_dir: str) -> dict:
    """Reset, STEPS_BEFORE steps, a checkpoint gathered over the ranks
    (rank 0 writes it), STEPS_AFTER more steps, then evaluate."""
    env = build_env()
    runner = runner_lib.ShardedRunner(env, NUM_ENVS, mesh=mesh)
    state, _ = runner.reset(SEED)
    state, m1 = runner.rollout(state, STEPS_BEFORE)
    sharding = mesh_lib.env_sharding(mesh)
    # The image checksum is a collective too: each rank's exact int64
    # sum, all-reduced.
    pixels = torch.tensor([image_sum(env, state)], dtype=torch.int64)
    mesh_lib.replicated_sharding(mesh).all_reduce(pixels)
    ckpt = sharding.gather({
        "env_state": state, "episode_returns": runner.episode_returns,
        "generators": env.generator.get_state()[None]})
    if mesh.rank == 0:
        checkpoint.save_state(os.path.join(out_dir, "ckpt"), ckpt)
    state, m2 = runner.rollout(state, STEPS_AFTER)
    stats = runner.evaluate(EVAL_EPISODES, chunk_steps=4)
    return {"m1": metrics_dict(m1), "image_sum": int(pixels),
            "m2": metrics_dict(m2), "eval": stats.__dict__,
            "local_lanes": runner.local_envs}


def rank_resume(mesh, out_dir: str) -> dict:
    """Restore the gathered checkpoint, take this rank's lanes and
    generator, and continue STEPS_AFTER steps."""
    env = build_env(seed=123)  # another generator until restored
    restored = checkpoint.restore_state(
        os.path.join(out_dir, "ckpt"), checkpoint_like(env, NUM_ENVS))
    local = mesh_lib.env_sharding(mesh).shard(
        {"env_state": restored["env_state"],
         "episode_returns": restored["episode_returns"]})
    env.generator.set_state(restored["generators"][mesh.rank].clone())
    runner = runner_lib.ShardedRunner(env, NUM_ENVS, mesh=mesh)
    _, m2 = runner.rollout(local["env_state"], STEPS_AFTER,
                           episode_returns=local["episode_returns"])
    return {"m2": metrics_dict(m2)}


def rank_single(mesh, out_dir: str) -> dict:
    """On a one-rank group: the runner with the mesh and without it from
    the same seed, bit for bit (states, metrics, stacked timesteps,
    evaluate)."""
    del out_dir
    assert mesh.size == 1 and mesh.group is not None
    runs = []
    for m in (mesh, None):
        env = build_env()
        runner = runner_lib.ShardedRunner(env, 8, mesh=m)
        state, _ = runner.reset(SEED)
        state, metrics, tss = runner.rollout(state, 6, return_timesteps=True)
        stats = runner.evaluate(10, chunk_steps=4)
        runs.append((state, metrics, tss, stats))
    (sa, ma, ta, ea), (sb, mb, tb, eb) = runs
    return {
        "state": [torch.equal(getattr(sa, n), getattr(sb, n))
                  for n in STATE_FIELDS],
        "metrics": [metrics_dict(ma), metrics_dict(mb)],
        "step_type": torch.equal(ta.step_type, tb.step_type),
        "reward": torch.equal(ta.reward.nan_to_num(), tb.reward.nan_to_num()),
        "image": torch.equal(ta.observation["image"],
                             tb.observation["image"]),
        "eval": [ea.__dict__, eb.__dict__]}


def rank_main(task: str, out_dir: str, rank: str, world: str, address: str):
    mesh_lib.initialize_multihost(address, int(world), int(rank),
                                  device="cpu")
    mesh = mesh_lib.env_mesh(device="cpu")
    out = {"run": rank_run, "resume": rank_resume,
           "single": rank_single}[task](mesh, out_dir)
    out.update(rank=mesh.rank, size=mesh.size)
    print(json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    # Leave at once: gloo's threads can abort the interpreter's own exit
    # (std::terminate) once the group is gone.
    sys.stderr.flush()
    os._exit(0)


# ---------------------------------------------------------------------- #
# The tests.

def _worker_env():
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES" and not k.startswith("JAX_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def _run_two_ranks(task: str, out_dir) -> list:
    outs = mesh_lib.run_ranks([__file__, task, str(out_dir)], 2,
                              timeout=120, env=_worker_env())
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def _meshless(rank: int):
    """What rank `rank` of two should step: 8 lanes, its derived seed,
    without a mesh. Returns (env, runner, state and metrics after
    STEPS_BEFORE, metrics of the STEPS_AFTER that follow)."""
    env = build_env()
    runner = runner_lib.ShardedRunner(env, NUM_ENVS // 2)
    state, _ = runner.reset(runner_lib.rank_seed(SEED, rank))
    state, m1 = runner.rollout(state, STEPS_BEFORE)
    cut = {"env_state": state, "episode_returns": runner.episode_returns,
           "generator": env.generator.get_state(), "image_sum":
           image_sum(env, state)}
    _, m2 = runner.rollout(state, STEPS_AFTER)
    return cut, m1, m2


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("mesh")
    return out_dir, _run_two_ranks("run", out_dir)


def test_rank_seed_keeps_seed_on_rank_zero():
    assert runner_lib.rank_seed(SEED, 0) == SEED
    seeds = {runner_lib.rank_seed(SEED, r) for r in range(64)}
    assert len(seeds) == 64
    assert all(0 <= s < 2**64 for s in seeds)


def test_initialize_without_address_stays_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    mesh_lib.initialize_multihost(device="cpu")
    assert not torch.distributed.is_initialized()
    mesh = mesh_lib.env_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.device == torch.device("cpu")
    assert mesh_lib.ENV_AXIS == "envs"


def test_explicit_address_needs_the_group_shape():
    with pytest.raises(ValueError, match="num_processes and process_id"):
        mesh_lib.initialize_multihost("127.0.0.1:1", device="cpu")
    assert not torch.distributed.is_initialized()


def test_lanes_that_do_not_divide_the_mesh_raise():
    mesh = mesh_lib.EnvMesh(size=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide the mesh size 3"):
        runner_lib.ShardedRunner(build_env(), NUM_ENVS, mesh=mesh)
    with pytest.raises(ValueError, match="do not divide"):
        mesh_lib.env_sharding(mesh).shard(torch.zeros(NUM_ENVS))


def test_sharding_takes_contiguous_slices():
    x = torch.arange(12).reshape(6, 2)
    for rank in range(3):
        mesh = mesh_lib.EnvMesh(size=3, rank=rank,
                                device=torch.device("cpu"))
        got = mesh_lib.env_sharding(mesh).shard({"a": x, "b": (x[:, 0],)})
        assert torch.equal(got["a"], x[2 * rank:2 * rank + 2])
        assert torch.equal(got["b"][0], x[2 * rank:2 * rank + 2, 0])


def test_one_rank_group_equals_the_runner_without_a_mesh(tmp_path):
    """A one-rank gloo group (in a process of its own, so that no group
    outlives the test): the metrics go through the collectives and every
    result equals the runner without a mesh, bit for bit."""
    out = json.loads(mesh_lib.run_ranks(
        [__file__, "single", str(tmp_path)], 1, timeout=120,
        env=_worker_env())[0].strip().splitlines()[-1])
    assert (out["rank"], out["size"]) == (0, 1)
    assert all(out["state"]), out["state"]
    assert out["metrics"][0] == out["metrics"][1]
    assert out["step_type"] and out["reward"] and out["image"]
    assert out["eval"][0] == out["eval"][1]


def test_two_ranks_equal_two_runs_without_a_mesh(two_ranks):
    _, outs = two_ranks
    assert [(o["rank"], o["size"], o["local_lanes"]) for o in outs] == [
        (0, 2, 8), (1, 2, 8)]
    cuts, m1s, m2s = zip(*(_meshless(r) for r in range(2)))
    for key, ms in (("m1", m1s), ("m2", m2s)):
        want = {
            "steps": ms[0].steps + ms[1].steps,
            "episodes": ms[0].episodes + ms[1].episodes,
            "successes": ms[0].successes + ms[1].successes,
            # float32 sums, added once across the two ranks.
            "return_sum": float(np.float32(ms[0].return_sum)
                                + np.float32(ms[1].return_sum)),
            "reward_sum": float(np.float32(ms[0].reward_sum)
                                + np.float32(ms[1].reward_sum)),
        }
        for o in outs:
            assert o[key] == want, (key, o[key], want)
    assert outs[0]["image_sum"] == outs[1]["image_sum"] == (
        cuts[0]["image_sum"] + cuts[1]["image_sum"])
    assert outs[0]["m1"]["episodes"] > 0 and outs[0]["image_sum"] > 0


def test_evaluate_agrees_on_both_ranks(two_ranks):
    _, outs = two_ranks
    assert outs[0]["eval"] == outs[1]["eval"]
    assert outs[0]["eval"]["episodes"] == EVAL_EPISODES


def test_gathered_checkpoint_restores_lane_for_lane(two_ranks):
    """The two ranks' gathered state, restored under one rank: lanes 0-7
    are rank 0's, lanes 8-15 rank 1's, as the runs without a mesh left
    them, and each rank's generator state is in its row."""
    out_dir, _ = two_ranks
    env = build_env()
    restored = checkpoint.restore_state(str(out_dir / "ckpt"),
                                        checkpoint_like(env, NUM_ENVS))
    for rank in range(2):
        cut, _, _ = _meshless(rank)
        lanes = slice(8 * rank, 8 * rank + 8)
        for name in STATE_FIELDS:
            assert torch.equal(getattr(restored["env_state"], name)[lanes],
                               getattr(cut["env_state"], name)), name
        assert torch.equal(restored["episode_returns"][lanes],
                           cut["episode_returns"])
        assert torch.equal(restored["generators"][rank], cut["generator"])
    # One rank steps all 16 restored lanes on.
    runner = runner_lib.ShardedRunner(env, NUM_ENVS)
    _, m = runner.rollout(restored["env_state"], STEPS_AFTER,
                          episode_returns=restored["episode_returns"])
    assert m.steps == NUM_ENVS * STEPS_AFTER and m.episodes > 0


def test_two_rank_resume_continues_the_run(two_ranks):
    out_dir, outs = two_ranks
    resumed = _run_two_ranks("resume", out_dir)
    for o in resumed:
        assert o["m2"] == outs[0]["m2"]


if __name__ == "__main__":
    rank_main(*sys.argv[1:])
