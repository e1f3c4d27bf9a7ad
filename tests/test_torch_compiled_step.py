"""The compiled step-by-step surface on the CPU: the port's single-lane
`Environment` methods against the JAX package's, and the compiled programs
(`core.environment.Compiled`) that `BatchedEnvironment`, the dm_env
adapter and `utils/media.record_episode` replay.

A CPU environment launches the programs eagerly (`use_graph=False`, the
default there; True raises), through the same `StepGraph` path, donation
and deferred rejection as the card's graphs: these tests hold that path
equal, bit for bit, to the plain eager `reset_batch`/`step_batch` from the
same keys, the rejection re-run included. Single-lane parity with JAX runs
on an injected scene and numpy actions (the method of
tests/test_trajectory_parity.py): state, rewards, step types and
anti_aliasing=1 pixels exact, anti_aliasing=5 pixels within +-1.

Run as a script (`python test_torch_compiled_step.py mesh <dir> <rank>
<world> <address>`), this file is one rank of a gloo group
(`mesh.run_ranks`).
"""

import gc
import json
import os
import pathlib
import sys
import weakref

import numpy as np
import pytest
import torch

_ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(_ROOT))

from spriteworld_torch.core import actions as tactions  # noqa: E402
from spriteworld_torch.core import distributions as tdistribs  # noqa: E402
from spriteworld_torch.core import environment as tenvironment  # noqa: E402
from spriteworld_torch.core import generators as tgenerators  # noqa: E402
from spriteworld_torch.core import renderers as trenderers  # noqa: E402
from spriteworld_torch.core import tasks as ttasks  # noqa: E402
from spriteworld_torch.core.state import STATE_FIELDS, StepType  # noqa: E402
from spriteworld_torch.ops import lane_random  # noqa: E402
from spriteworld_torch.parallel import mesh as mesh_lib  # noqa: E402

MESH_LANES = 8  # global lanes of the mesh test: 4 a rank on two ranks
MESH_SEED = 5
MESH_STEPS = 9


def _small_env(seed=0, max_episode_length=4, image_size=(16, 16), aa=1):
    """Three squares and triangles, goal finding with short episodes,
    factors, sprites, an HSV image and success, on the CPU."""
    d = tdistribs
    return tenvironment.Environment(
        task=ttasks.FindGoalPosition(goal_position=(0.5, 0.5),
                                     terminate_distance=0.1),
        action_space=tactions.SelectMove(scale=0.25),
        renderers={"factors": trenderers.SpriteFactors(),
                   "sprites": trenderers.SpritePassthrough(),
                   "image": trenderers.ImageRenderer(
                       image_size, anti_aliasing=aa, color_to_rgb="hsv"),
                   "success": trenderers.Success()},
        init_sprites=tgenerators.generate_sprites(d.Product([
            d.Continuous("x", 0.2, 0.8), d.Continuous("y", 0.2, 0.8),
            d.Discrete("shape", ["square", "triangle"]),
            d.Continuous("scale", 0.1, 0.2), d.Continuous("c0", 0.3, 1.0),
            d.Continuous("c1", 0.3, 1.0), d.Continuous("c2", 0.3, 1.0)]),
            num_sprites=3),
        max_episode_length=max_episode_length, device="cpu", seed=seed)


def _low_acceptance(seed=0):
    import bench_torch
    import chip_smoke

    env = chip_smoke.low_acceptance_env(bench_torch, tenvironment,
                                        device="cpu", image_size=(16, 16))
    env.seed = seed
    return env


def _assert_states_equal(a, b, what=""):
    for n in STATE_FIELDS:
        assert torch.equal(getattr(a, n), getattr(b, n)), (what, n)


def _assert_tree_equal(a, b, what=""):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{what}/{k}")
    else:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=what)


def _assert_timesteps_equal(a, b, what=""):
    for name in ("step_type", "reward", "discount"):
        _assert_tree_equal(getattr(a, name), getattr(b, name),
                           f"{what} {name}")
    _assert_tree_equal(a.observation, b.observation, f"{what} observation")


# ---------------------------------------------------------------------- #
# Single-lane methods against the JAX Environment's.

def _pair(scene, aa, max_episode_length):
    import test_torch_env as te

    from spriteworld_tpu.core import actions as ja
    from spriteworld_tpu.core import distributions as jd
    from spriteworld_tpu.core import environment as je
    from spriteworld_tpu.core import renderers as jr
    from spriteworld_tpu.core import tasks as jt

    def config(d, t, a, r, gen):
        return dict(
            task=t.FindGoalPosition(
                filter_distrib=d.Continuous("c0", 0.0, 0.5),
                terminate_distance=0.075),
            action_space=a.SelectMove(scale=0.25),
            renderers={"image": r.ImageRenderer((24, 24), anti_aliasing=aa,
                                                color_to_rgb="hsv"),
                       "factors": r.SpriteFactors(),
                       "success": r.Success()},
            init_sprites=gen(scene), max_episode_length=max_episode_length)

    jenv = je.Environment(**config(jd, jt, ja, jr, te._JaxFixed))
    tenv = tenvironment.Environment(
        **config(tdistribs, ttasks, tactions, trenderers, te._TorchFixed),
        device="cpu")
    return jenv, tenv


def _assert_lane_equal(tstate, tts, jstate, jts, aa, what):
    import jax

    for n in STATE_FIELDS:
        want = getattr(jstate, n)
        if n == "key":  # the lane's key splits as JAX's
            want = jax.random.key_data(want).view(np.int32)
        np.testing.assert_array_equal(getattr(tstate, n).numpy(),
                                      np.asarray(want), f"{what}: {n}")
    for n in ("step_type", "reward", "discount"):
        np.testing.assert_array_equal(getattr(tts, n).numpy(),
                                      np.asarray(getattr(jts, n)),
                                      f"{what}: {n}")
    if jts.observation == ():
        assert tts.observation == (), what
        return
    _assert_obs_equal(tts.observation, jts.observation, aa, what)


def _assert_obs_equal(tobs, jobs, aa, what):
    np.testing.assert_array_equal(tobs["success"].numpy(),
                                  np.asarray(jobs["success"]), what)
    np.testing.assert_array_equal(tobs["factors"]["factors"].numpy(),
                                  np.asarray(jobs["factors"]["factors"]),
                                  what)
    ti = tobs["image"].numpy().astype(int)
    ji = np.asarray(jobs["image"]).astype(int)
    assert ti.shape == ji.shape == (24, 24, 3), what
    # anti_aliasing=1 exact; anti_aliasing>1 within +-1.
    assert np.abs(ti - ji).max() <= (0 if aa == 1 else 1), what


@pytest.mark.parametrize("aa", [1, 5])
def test_single_lane_methods_equal_jax(aa):
    """reset, observation, success, transition and step of one lane over
    two episodes and an auto-reset, on one injected scene and one list of
    grid actions, against the JAX Environment's jitted methods."""
    import jax
    import jax.numpy as jnp
    import test_torch_env as te

    rng = np.random.default_rng(40 + aa)
    k = 3
    scene = te._scene_batch(rng, 1, k)[0]
    jenv, tenv = _pair(scene, aa, max_episode_length=4)
    jstate, jts = jax.jit(jenv.reset)(jax.random.key(0))
    tstate, tts = tenv.reset()
    _assert_lane_equal(tstate, tts, jstate, jts, aa, "reset")
    assert tstate.factors.shape == (k, 10) and tts.step_type.shape == ()

    jsuccess = jax.jit(jenv.success)(jstate)
    tsuccess = tenv.success(tstate)
    assert tsuccess.shape == () and bool(tsuccess) == bool(jsuccess)
    jobs = jax.jit(jenv.observation)(jstate.factors, jstate.num_sprites,
                                     jsuccess)
    tobs = tenv.observation(tstate.factors, tstate.num_sprites, tsuccess)
    _assert_obs_equal(tobs, jobs, aa, "observation")

    jtransition, jstep = jax.jit(jenv.transition), jax.jit(jenv.step)
    types = []
    for t in range(10):
        a = te._grid_actions(rng, 1)[0]
        if rng.uniform() < 0.7:
            a[:2] = np.asarray(jstate.factors)[rng.integers(0, k), :2]
        ja = jnp.asarray(a)
        js2, jts2 = jtransition(jstate, ja)
        ts2, tts2 = tenv.transition(tstate, torch.from_numpy(a))
        _assert_lane_equal(ts2, tts2, js2, jts2, aa, f"transition {t}")
        jstate, jts = jstep(jstate, ja)
        tstate, tts = tenv.step(tstate, torch.from_numpy(a))
        _assert_lane_equal(tstate, tts, jstate, jts, aa, f"step {t}")
        types.append(int(tts.step_type))
    # Two episodes at least, and an auto-reset between them.
    assert types.count(StepType.LAST) >= 2, types
    assert StepType.FIRST in types[types.index(StepType.LAST):], types


# ---------------------------------------------------------------------- #
# BatchedEnvironment: the compiled path, eager on the CPU.

def _action_keys(key, lanes, steps):
    """The lane action keys of `steps` calls of `sample_actions()` after
    `reset(key)`: the action key starts at fold_in(key, 1), and each call
    splits it into the next one and the call's, split over the lanes."""
    action_key = lane_random.fold_in(key, 1)
    for _ in range(steps):
        action_key, step_key = lane_random.split(action_key, 2)
        yield lane_random.split(step_key, lanes)


def _plain_run(env, lanes, steps):
    """The plain eager code: reset_batch of the lanes of key(env.seed),
    then step_batch on sample_action of BatchedEnvironment's action keys,
    every result copied."""
    key = lane_random.key(env.seed)
    state, ts = env.reset_batch(lane_random.split(key, lanes))
    out = [(state.clone(), ts)]
    for keys in _action_keys(key, lanes, steps):
        state, ts = env.step_batch(state, env.sample_action(keys))
        out.append((state.clone(), ts))
    return out


@pytest.mark.parametrize("lanes", [1, 4])
def test_batched_environment_steps_as_the_eager_code(lanes):
    steps = 12  # three episodes of 4 steps at most
    want = _plain_run(_small_env(seed=3), lanes, steps)
    env = _small_env(seed=3)
    benv = tenvironment.BatchedEnvironment(env, lanes)
    assert not benv.use_graph and benv.local_envs == lanes
    state, ts = benv.reset()
    got = [(state.clone(), ts)]
    for _ in range(steps):
        new, ts = benv.step(state, benv.sample_actions())
        if len(got) > 1:
            assert new is state  # the state passed back is not copied
        state = new
        got.append((state.clone(), ts))
    for t, ((gs, gts), (ws, wts)) in enumerate(zip(got, want)):
        _assert_states_equal(gs, ws, f"step {t}")
        # The timesteps of earlier steps were not overwritten.
        _assert_timesteps_equal(gts, wts, f"step {t}")
    assert sum(int(ts.last().sum()) for _, ts in got) >= lanes
    assert benv.reruns == 0


def test_step_donates_its_state_and_copies_a_foreign_one():
    env = _small_env(seed=1)
    benv = tenvironment.BatchedEnvironment(env, 2)
    state, _ = benv.reset()
    donated, _ = benv.step(state, benv.sample_actions())
    assert donated is state  # JAX's donate_argnums=(0,): the buffers
    foreign = env.initial_state(2)
    kept = foreign.clone()
    out, ts = benv.step(foreign, benv.sample_actions())
    assert out is state and out is not foreign
    _assert_states_equal(foreign, kept, "a foreign state is only read")
    assert (ts.step_type == StepType.FIRST).all()  # reset_next lanes
    with pytest.raises(ValueError, match="actions of shape"):
        benv.step(out, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="state field factors"):
        benv.step(env.initial_state(3), benv.sample_actions())


def test_use_graph_on_a_cpu_env_raises():
    env = _small_env()
    for make in (
            lambda: tenvironment.BatchedEnvironment(env, 2, use_graph=True),
            lambda: tenvironment.Compiled(env.device, 1, use_graph=True)):
        with pytest.raises(ValueError, match="use_graph=True needs a CUDA "
                                             "environment"):
            make()


def test_compiled_programs_make_no_host_sync():
    """The bodies that a capture records (reset, step, observation, with
    the factor, sprite, image and success renderers, and the copies into
    the buffers) read nothing from the host; outside them, the flag."""
    from test_torch_sync_free import NoHostSync

    env = _small_env(seed=2)
    compiled = tenvironment.Compiled(env.device, 3)
    keys = lane_random.split(lane_random.key(2), (4, 3))
    state, _ = compiled.reset(env, keys[0])  # fills the constant caches
    compiled.step(env, state, env.sample_action(keys[1]))
    compiled.observe(env, state)
    with NoHostSync():
        state, ts = compiled.reset(env, keys[0])
        for t in range(3):
            state, ts = compiled.step(env, state,
                                      env.sample_action(keys[t + 1]))
        obs = compiled.observe(env, state)
    assert ts.step_type.shape == (3,)
    assert set(obs) == {"factors", "sprites", "image", "success"}
    assert not bool(compiled.pending)


# ---------------------------------------------------------------------- #
# Deferred rejection, re-run.

@pytest.mark.parametrize("lanes", [1, 4])
def test_pending_rejection_reruns_as_the_host_checked_step(lanes):
    """A low-acceptance scene sampler: deferred steps that leave elements
    pending are run again, and every result equals the host-checked eager
    step from the same keys."""
    steps = 6
    want = _plain_run(_low_acceptance(seed=4), lanes, steps)
    env = _low_acceptance(seed=4)
    benv = tenvironment.BatchedEnvironment(env, lanes)
    state, ts = benv.reset()
    got = [(state.clone(), ts)]
    for _ in range(steps):
        state, ts = benv.step(state, benv.sample_actions())
        got.append((state.clone(), ts))
    assert benv.reruns >= 1
    for t, ((gs, gts), (ws, wts)) in enumerate(zip(got, want)):
        _assert_states_equal(gs, ws, f"step {t}")
        _assert_timesteps_equal(gts, wts, f"step {t}")
        assert bool(gs.sample_ok.all())


def test_pending_flag_is_set_by_a_deferred_launch():
    """Compiled's launch alone leaves the flag for the caller: set after a
    deferred step whose rejection ran past its first rounds, and clear
    after the re-run, which equals the host-checked step."""
    env = _low_acceptance(seed=1)
    plain = _low_acceptance(seed=1)
    compiled = tenvironment.Compiled(env.device, 4)
    keys = lane_random.split(lane_random.key(1), (9, 4))
    state, _ = compiled.reset(env, keys[0])
    if bool(compiled.pending):
        compiled.rerun(env)
    want, _ = plain.reset_batch(keys[0])
    _assert_states_equal(state, want, "reset")
    pended = 0
    for t in range(8):
        a = env.sample_action(keys[t + 1])
        want, wts = plain.step_batch(want, a)
        state, ts = compiled.step(env, state, a)
        if bool(compiled.pending):
            pended += 1
            state, ts = compiled.rerun(env)
            assert not bool(compiled.pending)
        _assert_states_equal(state, want, f"step {t}")
        _assert_timesteps_equal(ts, wts, f"step {t}")
    assert pended >= 1 and compiled.reruns >= pended


# ---------------------------------------------------------------------- #
# The dm_env adapter and media on a CPU env.

def _adapter_config(env):
    return dict(task=env.task, action_space=env.action_space,
                renderers=env.renderers, init_sprites=env._init_sprites,
                keep_in_frame=env._keep_in_frame,
                max_episode_length=env.max_episode_length,
                metadata=env.metadata)


@pytest.mark.parametrize("make", [_small_env, _low_acceptance],
                         ids=["goal_finding", "low_acceptance"])
def test_adapter_steps_as_the_eager_code(make):
    """The adapter's compiled reset and step (eager on the CPU) against
    the plain eager code on an env of the same seed, keyed as the adapter
    keys its calls: the construction's scene draw and each reset from the
    next of the adapter's carried keys, step_batch of the same actions, and
    sample_contained_position taking a key between steps."""
    from spriteworld_torch.adapters import dm_env_adapter

    ref = make(seed=6)
    adapter = dm_env_adapter.Environment(**_adapter_config(make()), seed=6,
                                         device="cpu")
    with pytest.raises(ValueError, match="use_graph=True needs a CUDA"):
        dm_env_adapter.Environment(**_adapter_config(make()), seed=6,
                                   device="cpu", use_graph=True)
    carried = lane_random.key(6)

    def next_key():
        nonlocal carried
        carried, key = lane_random.split(carried, 2)
        return key[None]

    state = ref.initial_state(next_key())
    rng = np.random.default_rng(0)
    lasts = 0
    for t in range(14):
        if t == 0:
            ts = adapter.reset()
            state, want = ref.reset_batch(next_key())
        else:
            a = rng.uniform(0, 1, 4).astype(np.float32)
            ts = adapter.step(a)
            state, want = ref.step_batch(state, torch.from_numpy(a[None]))
        assert int(ts.step_type) == int(want.step_type[0]), t
        if int(ts.step_type) != StepType.FIRST:  # restart(): no reward
            assert ts.discount == float(want.discount[0]), t
            assert np.float32(ts.reward) == want.reward[0].numpy() or (
                np.isnan(ts.reward) and bool(want.reward[0].isnan())), t
        np.testing.assert_array_equal(ts.observation["image"],
                                      want.observation["image"][0].numpy())
        assert ts.observation["success"] is bool(
            want.observation["success"][0])
        _assert_states_equal(adapter._state, state, f"step {t}")
        lasts += int(ts.step_type) == StepType.LAST
        if t % 3 == 1:
            np.testing.assert_array_equal(
                adapter.observation()["image"],
                want.observation["image"][0].numpy())
            adapter.sample_contained_position()
            next_key()
    if make is _low_acceptance:
        assert adapter._compiled.reruns >= 1
    else:
        assert lasts >= 2


def test_media_compiles_once_per_env_and_lets_the_env_go():
    from spriteworld_torch.utils import media

    env = _small_env(seed=8, max_episode_length=3)
    a = media.record_episode(env, 5, max_steps=10)
    compiled = media._COMPILED[env][False]
    b, states = media.record_episode(env, 5, max_steps=10,
                                     return_states=True)
    assert media._COMPILED[env][False] is compiled  # built once
    np.testing.assert_array_equal(a, b)
    assert a.shape[0] == 4  # the reset and 3 steps, the last LAST
    # The states are copies, not the step's buffers.
    assert [int(s.step_count) for s in states] == [0, 1, 2, 3]
    ref = weakref.ref(env)
    del env, compiled, states
    gc.collect()
    assert ref() is None  # the cache holds no reference to its env


# ---------------------------------------------------------------------- #
# The mesh (two gloo ranks).

def rank_mesh(mesh) -> dict:
    """MESH_STEPS steps of this rank's lanes from reset(MESH_SEED)."""
    env = _small_env()
    benv = tenvironment.BatchedEnvironment(env, MESH_LANES, mesh=mesh)
    state, ts = benv.reset(MESH_SEED)
    trace = [ts.step_type.tolist()]
    for _ in range(MESH_STEPS):
        state, ts = benv.step(state, benv.sample_actions())
        trace.append(ts.step_type.tolist() + ts.reward.tolist())
    return {"rank": mesh.rank, "size": mesh.size,
            "local_envs": benv.local_envs, "trace": trace,
            "factors": state.factors.flatten().tolist()}


def _meshless(rank: int) -> dict:
    """Rank `rank`'s half of the lanes of one BatchedEnvironment of all
    MESH_LANES lanes without a mesh."""
    benv = tenvironment.BatchedEnvironment(_small_env(), MESH_LANES)
    state, ts = benv.reset(MESH_SEED)
    half = slice(rank * MESH_LANES // 2, (rank + 1) * MESH_LANES // 2)
    trace = [ts.step_type[half].tolist()]
    for _ in range(MESH_STEPS):
        state, ts = benv.step(state, benv.sample_actions())
        trace.append(ts.step_type[half].tolist() + ts.reward[half].tolist())
    return {"trace": trace, "factors": state.factors[half].flatten().tolist()}


def test_mesh_of_two_ranks_equals_two_envs_without_a_mesh(tmp_path):
    """Each rank of two steps its half of the lanes exactly as one env of
    all the lanes without a mesh steps them: the lanes' keys, scenes and
    actions do not depend on the mesh."""
    from test_torch_mesh import _worker_env

    outs = [json.loads(o.strip().splitlines()[-1]) for o in
            mesh_lib.run_ranks([__file__, "mesh", str(tmp_path)], 2,
                               timeout=120, env=_worker_env())]
    assert [(o["rank"], o["size"], o["local_envs"]) for o in outs] == [
        (0, 2, 4), (1, 2, 4)]
    for rank, out in enumerate(outs):
        want = _meshless(rank)
        assert out["trace"] == want["trace"], rank
        assert out["factors"] == want["factors"], rank
    assert outs[0]["factors"] != outs[1]["factors"]


def test_lanes_that_do_not_divide_the_mesh_raise():
    mesh = mesh_lib.EnvMesh(size=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="num_envs=8 must divide the mesh "
                                         "size 3"):
        tenvironment.BatchedEnvironment(_small_env(), 8, mesh=mesh)


def _rank_main(task, out_dir, rank, world, address):
    del task, out_dir
    mesh_lib.initialize_multihost(address, int(world), int(rank),
                                  device="cpu")
    out = rank_mesh(mesh_lib.env_mesh(device="cpu"))
    print(json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    # Leave at once: gloo's threads can abort the interpreter's own exit
    # (std::terminate) once the group is gone.
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
