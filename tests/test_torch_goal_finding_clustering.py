"""The compositional example (`configs/examples/goal_finding_clustering`,
train mode) against its plain reference (`perfbench/reference/`), on the
CPU: the runner's reset and steps at 6 lanes through two episodes, the
dm_env adapter's episode, the Davies-Bouldin index and the Clustering task
on random and degenerate memberships, and the bfloat16 control."""

import importlib

import numpy as np
import pytest
import torch

from perfbench import check, harness, traffic
from perfbench.reference import compositional, threefry

from spriteworld_torch import constants
from spriteworld_torch.core import distributions as tdistribs
from spriteworld_torch.core import environment as env_lib
from spriteworld_torch.core import tasks as ttasks
from spriteworld_torch.ops import clustering as tclustering_ops

NAME = "examples.goal_finding_clustering"
SEED = 3_000_000_019  # above 2**31: the key takes both words
STATE = (("factors", "factors"), ("num", "num_sprites"),
         ("step_count", "step_count"), ("reset_next", "reset_next"),
         ("key", "key"))


def _reference():
    return check.reference_module(harness.Layout().reference(NAME))


def _config():
    mod = importlib.import_module(f"spriteworld_torch.configs.{NAME}")
    return mod.get_config("train")


def test_the_configuration_file_holds_the_built_sizes():
    layout = harness.Layout()
    config = layout.config(NAME)
    kwargs = harness.env_kwargs(config)  # raises where a size differs
    assert kwargs["init_sprites"].max_sprites == config["max_sprites"] == 12
    assert config["color_to_rgb"] is None and "color_to_rgb" in config[
        "holds"]
    cell = layout.cell("goal_finding_clustering.rollout")
    assert cell["config"] == NAME and cell["traffic"] == "rollout"


@pytest.mark.parametrize("shape", ["pentagon", "star_4", "spoke_4",
                                   "triangle", "square", "circle"])
def test_reference_shapes_are_the_programs(shape):
    sid = compositional.SHAPE_IDS[shape]
    assert sid == constants.ShapeType[shape].value
    verts = compositional.VERTICES[sid]
    n = constants.VERTEX_COUNTS[sid]
    assert len(verts) == n
    np.testing.assert_array_equal(verts, constants.VERTEX_BANK[sid, :n])


def test_runner_steps_equal_the_reference():
    """Reset state and image, then 53 steps of the runner's random policy
    (every lane's episode ends at step 50 and the next one starts): step
    types, rewards, images, the end state and the action key, bit for
    bit."""
    from spriteworld_torch.parallel import ShardedRunner

    lanes, steps = 6, 53
    runner = ShardedRunner(env_lib.Environment(**_config(), device="cpu"),
                           lanes)
    state, ts = runner.reset(SEED)
    start = {k: getattr(state, f).numpy().copy() for k, f in STATE}
    state2, _, tss = runner.rollout(state, steps, return_timesteps=True)
    env = _reference().build()
    idx = np.arange(lanes)
    ref = env.reset(env.rng.block(threefry.key(SEED)[None],
                                  idx.astype(np.uint32)))
    for k, _ in STATE:
        np.testing.assert_array_equal(
            check.words(start[k]) if k == "key" else start[k],
            getattr(ref, k), k)
    assert ((8 <= ref.num) & (ref.num <= 12)).all()
    np.testing.assert_array_equal(env.observe(ref, "image"),
                                  ts.observation["image"].numpy())
    sts, rws, ims, end, key = harness.Layout().loop("runner").simulate(
        env, ref, threefry.blocks(threefry.key(SEED), 1), idx, steps,
        "image")
    np.testing.assert_array_equal(sts, tss.step_type.numpy())
    np.testing.assert_array_equal(rws, tss.reward.numpy())
    np.testing.assert_array_equal(
        ims, tss.observation["image"].numpy().reshape(ims.shape))
    for k, f in STATE:
        got = getattr(state2, f).numpy()
        np.testing.assert_array_equal(
            check.words(got) if k == "key" else got, getattr(end, k), k)
    np.testing.assert_array_equal(key, check.words(runner.action_key))
    assert (sts == 2).any(0).all() and (sts == 0).any(0).all()
    assert np.isfinite(rws).all()


def test_adapter_episode_equals_the_reference():
    from perfbench.dm_env_stand_in import dm_env_stand_in

    with dm_env_stand_in():
        from spriteworld_torch.adapters import dm_env_adapter

        adapter = dm_env_adapter.Environment(**_config(), seed=SEED,
                                             device="cpu")
        adapter.reset()
        first = adapter.reset()
        actions = np.random.default_rng(5).random((8, 4), dtype=np.float32)
        got = [adapter.step(a) for a in actions]
    env = _reference().build()
    loop = harness.Layout().loop("adapter")
    want = loop.simulate(env, loop.reset_keys(SEED, 2)[2], actions, "image")
    np.testing.assert_array_equal(want[0][0], first.observation["image"])
    np.testing.assert_array_equal(want[1], [int(t.step_type) for t in got])
    np.testing.assert_array_equal(want[2], [np.float32(t.reward)
                                            for t in got])
    np.testing.assert_array_equal(want[3][:, 0], [t.observation["image"]
                                                  for t in got])
    torch.testing.assert_close(torch.from_numpy(want[4].factors),
                               adapter._state.factors, rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# The Davies-Bouldin index and the Clustering task.

def _reference_db(pos, member):
    """The reference's index of each lane of a masked clustering."""
    out = []
    for p, m in zip(pos, member):
        keep = m.any(-1)
        out.append(compositional.davies_bouldin(p[keep],
                                                m[keep].argmax(-1)))
    return np.array(out, np.float32)


def _port_db(pos, member):
    return tclustering_ops.davies_bouldin_index(
        torch.from_numpy(pos), torch.from_numpy(member)).numpy()


def test_davies_bouldin_equals_the_reference_on_random_12_slot_memberships():
    """Off any grid, where the order of the float32 sums shows: the port's
    slot-order folds give the reference's bits."""
    rng = np.random.default_rng(0)
    b, k, c = 2048, 12, 3
    pos = rng.random((b, k, 2), dtype=np.float32)
    label = rng.integers(-1, c, (b, k))
    member = label[..., None] == np.arange(c)
    got, want = _port_db(pos, member), _reference_db(pos, member)
    np.testing.assert_array_equal(got, want)
    present = member.any(1).sum(-1)
    assert np.isnan(got[present < 2]).all()
    assert np.isfinite(got[present >= 2]).all() and (present == 3).any()


def _degenerate(case):
    """(positions f32[1, 6, 2], membership bool[1, 6, 3]) of a case."""
    pos = np.array([[0.1, 0.2], [0.3, 0.7], [0.6, 0.6], [0.8, 0.1],
                    [0.5, 0.9], [0.25, 0.5]], np.float32)
    label = np.array([0, 0, 1, 1, 2, 2])
    if case == "one cluster":
        label = np.array([1, 1, 1, -1, 1, -1])
    elif case == "no member":
        label = np.full(6, -1)
    elif case == "zero spreads":
        pos = pos[[0, 0, 2, 2, 4, 4]]
    elif case == "coincident centroids":
        pos = np.array([[0.2, 0.5], [0.8, 0.5], [0.5, 0.2], [0.5, 0.8],
                        [0.25, 0.25], [0.75, 0.75]], np.float32)
    elif case == "a cluster a sprite":
        label = np.array([0, -1, 1, -1, 2, -1])
    member = label[:, None] == np.arange(3)
    return pos[None], member[None]


@pytest.mark.parametrize("case", ["one cluster", "no member", "zero spreads",
                                  "coincident centroids",
                                  "a cluster a sprite", "sound"])
def test_davies_bouldin_degenerate_cases_equal_the_reference(case):
    pos, member = _degenerate(case)
    got, want = _port_db(pos, member), _reference_db(pos, member)
    np.testing.assert_array_equal(got, want)
    if case in ("one cluster", "no member"):
        assert np.isnan(got).all()
    elif case != "sound":
        assert (got == 0).all()  # sklearn's zero short-circuits
    else:
        assert (got > 0).all()


def test_reference_davies_bouldin_is_sklearns():
    metrics = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(1)
    for _ in range(200):
        n = int(rng.integers(3, 13))
        pos = rng.random((n, 2), dtype=np.float32)
        labels = rng.integers(0, 3, n)
        if not 1 < len(np.unique(labels)) < n:
            continue
        want = metrics.davies_bouldin_score(pos.astype(np.float64), labels)
        got = compositional.davies_bouldin(pos, labels)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    for case in ("zero spreads", "coincident centroids"):
        pos, member = _degenerate(case)
        labels = member[0].argmax(-1)
        assert metrics.davies_bouldin_score(pos[0], labels) == 0.0
        assert compositional.davies_bouldin(pos[0], labels) == 0.0
    pos, member = _degenerate("one cluster")
    keep = member[0].any(-1)
    with pytest.raises(ValueError):
        metrics.davies_bouldin_score(pos[0, keep],
                                     member[0, keep].argmax(-1))
    assert np.isnan(compositional.davies_bouldin(
        pos[0, keep], member[0, keep].argmax(-1)))


def test_clustering_task_equals_the_reference():
    """The port's Clustering (first containing cluster, dead and
    unclustered slots left out) against the reference's on random scenes
    of five shapes: reward and success, bit for bit."""
    rng = np.random.default_rng(2)
    b, k = 1024, 12
    ids = [constants.ShapeType[s].value for s in
           ("triangle", "square", "pentagon", "circle", "star_4")]
    f = np.tile(np.array([0.5, 0.5, 2, 0, 0.1, 0, 0, 0, 0, 0], np.float32),
                (b, k, 1))
    f[..., 0:2] = rng.random((b, k, 2), dtype=np.float32)
    f[..., 2] = rng.choice(ids, (b, k))
    num = rng.integers(0, k + 1, b).astype(np.int32)
    names = ("triangle", "square", "pentagon")
    port = ttasks.Clustering([tdistribs.Discrete("shape", [s])
                              for s in names], reward_range=10.0)
    ref = compositional.Clustering(
        [compositional.engine.Discrete("shape", compositional.shape_ids([s]))
         for s in names], reward_range=10.0)
    ft, nt = torch.from_numpy(f), torch.from_numpy(num)
    np.testing.assert_array_equal(port.reward(ft, nt).numpy(),
                                  ref.reward(f, num))
    np.testing.assert_array_equal(port.success(ft, nt).numpy(),
                                  ref.success(f, num))


def test_the_bfloat16_reference_disagrees_with_the_port():
    """The cell's own loop and comparison at a few lanes: the port's run
    reads 0 in every count; the reference computed in bfloat16 in its
    place reads off in each of the three."""
    layout = harness.Layout()
    config = layout.config(NAME)
    mix = dict(layout.traffic("rollout"), lanes=4, steps_per_call=3,
               warmup_calls=1, check={"lanes": 4, "calls": 2})
    feed = traffic.build(layout, mix, harness.env_kwargs(config),
                         config["observation"], "cpu", SEED)
    feed.setup(0.2)
    feed.window(0.2, False)
    rec = feed.records()
    feed.free()
    reference = _reference()
    correct, rows = check.verdict(
        feed.check(rec, reference, config["observation"]), config["limits"])
    assert correct, rows
    correct, rows = check.verdict(
        feed.check(rec, reference, config["observation"], control=True),
        config["limits"])
    assert not correct
    assert all(value > 0 for _, value, _ in rows), rows
