"""The port's mesh: `spriteworld_torch.parallel.mesh` and
`ShardedRunner(mesh=...)` over `torch.distributed` (gloo) on the CPU.

The port keys every lane as the JAX runner does (each lane's key in the
state, the runner's action key split over the global lanes), so its
rollout is the same on every mesh shape, as tests/test_distributed.py holds
the JAX runner's: a one-rank group equals the runner without a mesh; one
gloo rank of 16 lanes and two of 8 step every lane alike (step types,
rewards, factors, image checksums exactly; the metrics' counts exactly,
their float32 sums, added in another order, to rounding); `evaluate`
agrees on both ranks; a checkpoint gathered under two ranks equals the
one-rank checkpoint bit for bit, and a checkpoint saved under either
topology resumes under the other to the uninterrupted run.

Run as a script (`python test_torch_mesh.py <task> <dir> <rank> <world>
<address>`), this file is one rank of such a group (`mesh.run_ranks`);
`<dir>` holds the checkpoint, `ckpt<world>` for a run of `<world>` ranks;
`resume<n>` restores `ckpt<n>`.
"""

import json
import os
import pathlib
import sys

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


def checkpoint_like(env, lanes: int) -> dict:
    """The tree `rank_run` saves: the global lanes' state and in-flight
    returns, and the runner's action key."""
    return {"env_state": env.initial_state(lanes),
            "episode_returns": torch.zeros(lanes),
            "action_key": env.root_key()}


def lane_trace(sharding, tss) -> dict:
    """Stacked timesteps of every lane in global lane order: step types
    and rewards (NaN as -1), [T][lanes]."""
    step_type, reward = sharding.gather(
        (tss.step_type, tss.reward.nan_to_num(-1.0)), axis=1)
    return {"step_type": step_type.tolist(), "reward": reward.tolist()}


# ---------------------------------------------------------------------- #
# One rank of a group (run as a script).

def rank_run(mesh, out_dir: str) -> dict:
    """Reset, STEPS_BEFORE steps, a checkpoint gathered over the ranks
    (rank 0 writes it), STEPS_AFTER more steps, then evaluate; every
    lane's timesteps and final factors in global order."""
    env = build_env()
    runner = runner_lib.ShardedRunner(env, NUM_ENVS, mesh=mesh)
    sharding = mesh_lib.env_sharding(mesh)
    state, _ = runner.reset(SEED)
    state, m1, tss1 = runner.rollout(state, STEPS_BEFORE,
                                     return_timesteps=True)
    # The image checksum is a collective too: each rank's exact int64
    # sum, all-reduced.
    pixels = torch.tensor([image_sum(env, state)], dtype=torch.int64)
    mesh_lib.replicated_sharding(mesh).all_reduce(pixels)
    ckpt = sharding.gather({
        "env_state": state, "episode_returns": runner.episode_returns})
    ckpt["action_key"] = runner.action_key
    if mesh.rank == 0:
        checkpoint.save_state(
            os.path.join(out_dir, f"ckpt{mesh.size}"), ckpt)
    state, m2, tss2 = runner.rollout(state, STEPS_AFTER,
                                     return_timesteps=True)
    stats = runner.evaluate(EVAL_EPISODES, chunk_steps=4)
    return {"m1": metrics_dict(m1), "image_sum": int(pixels),
            "m2": metrics_dict(m2), "eval": stats.__dict__,
            "local_lanes": runner.local_envs,
            "trace1": lane_trace(sharding, tss1),
            "trace2": lane_trace(sharding, tss2),
            "factors": sharding.gather(state.factors).flatten().tolist()}


def rank_resume(mesh, out_dir: str, saved_by: int) -> dict:
    """Restore the checkpoint that a run of `saved_by` ranks gathered,
    take this rank's lanes and the action key, and continue STEPS_AFTER
    steps."""
    env = build_env(seed=123)  # other keys until restored
    restored = checkpoint.restore_state(
        os.path.join(out_dir, f"ckpt{saved_by}"),
        checkpoint_like(env, NUM_ENVS))
    sharding = mesh_lib.env_sharding(mesh)
    local = sharding.shard({"env_state": restored["env_state"],
                            "episode_returns": restored["episode_returns"]})
    runner = runner_lib.ShardedRunner(env, NUM_ENVS, mesh=mesh)
    runner.action_key = restored["action_key"]
    state, m2, tss2 = runner.rollout(
        local["env_state"], STEPS_AFTER, return_timesteps=True,
        episode_returns=local["episode_returns"])
    return {"m2": metrics_dict(m2), "trace2": lane_trace(sharding, tss2),
            "factors": sharding.gather(state.factors).flatten().tolist()}


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
    if task.startswith("resume"):
        out = rank_resume(mesh, out_dir, int(task[len("resume"):]))
    else:
        out = {"run": rank_run, "single": rank_single}[task](mesh, out_dir)
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


def _run_ranks(task: str, out_dir, world: int = 2) -> list:
    outs = mesh_lib.run_ranks([__file__, task, str(out_dir)], world,
                              timeout=120, env=_worker_env())
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def _meshless():
    """The run without a mesh: one runner of all NUM_ENVS lanes. Returns
    (the state, in-flight returns, action key and image checksum after
    STEPS_BEFORE; the metrics before and after; every lane's timesteps
    and final factors, as `rank_run` reports them)."""
    env = build_env()
    runner = runner_lib.ShardedRunner(env, NUM_ENVS)
    one = mesh_lib.env_sharding(mesh_lib.EnvMesh.single(env.device))
    state, _ = runner.reset(SEED)
    state, m1, tss1 = runner.rollout(state, STEPS_BEFORE,
                                     return_timesteps=True)
    cut = {"env_state": state, "episode_returns": runner.episode_returns,
           "action_key": runner.action_key,
           "image_sum": image_sum(env, state)}
    state, m2, tss2 = runner.rollout(state, STEPS_AFTER,
                                     return_timesteps=True)
    lanes = {"trace1": lane_trace(one, tss1), "trace2": lane_trace(one, tss2),
             "factors": state.factors.flatten().tolist()}
    return cut, metrics_dict(m1), metrics_dict(m2), lanes


def _assert_metrics_equal(got: dict, want: dict, exact: bool):
    """Counts exactly; the float32 sums exactly where they were added in
    the same order (the same topology), else to rounding."""
    for key in ("steps", "episodes", "successes"):
        assert got[key] == want[key], (key, got, want)
    for key in ("return_sum", "reward_sum"):
        assert got[key] == (want[key] if exact else pytest.approx(
            want[key], rel=1e-5, abs=1e-5)), (key, got, want)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("mesh")
    return out_dir, _run_ranks("run", out_dir)


@pytest.fixture(scope="module")
def one_rank(two_ranks):
    """The same run on a one-rank gloo group of all 16 lanes, its
    checkpoint beside the two ranks' (ckpt1, ckpt2)."""
    out_dir, _ = two_ranks
    return _run_ranks("run", out_dir, world=1)[0]


def test_one_gloo_rank_and_two_step_every_lane_alike(two_ranks, one_rank):
    """One gloo rank of 16 lanes against two of 8 (the rollout is the same
    on any mesh, as tests/test_parallel.py holds the JAX runner's): every
    lane's step types, rewards and final factors, the image checksum and
    the evaluation exactly, the metrics' counts exactly and their float32
    sums to rounding."""
    _, outs = two_ranks
    assert (one_rank["size"], one_rank["local_lanes"]) == (1, NUM_ENVS)
    for o in outs:
        for key in ("trace1", "trace2", "factors", "image_sum", "eval"):
            assert o[key] == one_rank[key], key
        for key in ("m1", "m2"):
            _assert_metrics_equal(o[key], one_rank[key], exact=False)
    assert one_rank["m1"]["episodes"] > 0


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
    """Each rank's lanes are those of the run without a mesh: the two
    ranks' gathered lanes equal the lanes of one runner of all 16 without
    a mesh, their metrics' counts exactly and float32 sums to rounding."""
    _, outs = two_ranks
    assert [(o["rank"], o["size"], o["local_lanes"]) for o in outs] == [
        (0, 2, 8), (1, 2, 8)]
    cut, m1, m2, lanes = _meshless()
    for o in outs:
        for key in ("trace1", "trace2", "factors"):
            assert o[key] == lanes[key], key
        _assert_metrics_equal(o["m1"], m1, exact=False)
        _assert_metrics_equal(o["m2"], m2, exact=False)
        assert o["image_sum"] == cut["image_sum"]
    assert outs[0]["m1"]["episodes"] > 0 and outs[0]["image_sum"] > 0


def test_evaluate_agrees_on_both_ranks(two_ranks):
    _, outs = two_ranks
    assert outs[0]["eval"] == outs[1]["eval"]
    assert outs[0]["eval"]["episodes"] == EVAL_EPISODES


def test_gathered_checkpoint_restores_lane_for_lane(two_ranks):
    """The two ranks' gathered state, restored under one rank, is the
    state of the run without a mesh, lane for lane and key for key, with
    its in-flight returns and action key; one rank steps all 16 restored
    lanes on to the uninterrupted run's metrics."""
    out_dir, _ = two_ranks
    env = build_env(seed=123)
    restored = checkpoint.restore_state(str(out_dir / "ckpt2"),
                                        checkpoint_like(env, NUM_ENVS))
    cut, _, m2, _ = _meshless()
    for name in STATE_FIELDS:
        assert torch.equal(getattr(restored["env_state"], name),
                           getattr(cut["env_state"], name)), name
    assert torch.equal(restored["episode_returns"], cut["episode_returns"])
    assert torch.equal(restored["action_key"], cut["action_key"])
    runner = runner_lib.ShardedRunner(env, NUM_ENVS)
    runner.action_key = restored["action_key"]
    _, m = runner.rollout(restored["env_state"], STEPS_AFTER,
                          episode_returns=restored["episode_returns"])
    _assert_metrics_equal(metrics_dict(m), m2, exact=True)
    assert m.episodes > 0


def test_two_rank_resume_continues_the_run(two_ranks):
    out_dir, outs = two_ranks
    resumed = _run_ranks("resume2", out_dir)
    for o in resumed:
        assert o["m2"] == outs[0]["m2"]
        assert o["trace2"] == outs[0]["trace2"]
        assert o["factors"] == outs[0]["factors"]


def test_checkpoint_of_one_rank_resumes_under_two(two_ranks, one_rank):
    """Cross-topology resume (tests/test_distributed.py holds the JAX
    runner's): the one-rank run's checkpoint, restored under two ranks,
    continues to the uninterrupted one-rank run, lane for lane."""
    out_dir, _ = two_ranks
    for o in _run_ranks("resume1", out_dir):
        assert o["trace2"] == one_rank["trace2"]
        assert o["factors"] == one_rank["factors"]
        _assert_metrics_equal(o["m2"], one_rank["m2"], exact=False)


def test_checkpoint_of_two_ranks_resumes_under_one(two_ranks, one_rank):
    """And the reverse: the two ranks' checkpoint, restored under one gloo
    rank, continues to the uninterrupted runs (exactly the one-rank run's
    metrics, whose sums add in the same order)."""
    out_dir, outs = two_ranks
    o = _run_ranks("resume2", out_dir, world=1)[0]
    assert o["trace2"] == outs[0]["trace2"] == one_rank["trace2"]
    assert o["factors"] == one_rank["factors"]
    _assert_metrics_equal(o["m2"], one_rank["m2"], exact=True)


if __name__ == "__main__":
    rank_main(*sys.argv[1:])
