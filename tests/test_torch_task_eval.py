"""The task kernel: `csrc/task_eval.cu` and its table (`core.tasks.task_table`,
`ops/task_eval.py`) against the tasks' own methods, its plain twin.

On the CPU: every task tree of `spriteworld_torch/configs/` has a table in
both modes, and trees with a `mean` aggregator, an unknown task or an
unknown distribution have none; the table holds the float32 bits of the
configs' values; a reading of the table in numpy float32, operation for
operation as the kernel computes it (`read_table`), equals the methods
bit for bit on seeded states of every config and on the edge states (an
empty filter, three or more filtered sprites, all-singleton clusters,
fewer than two populated clusters, factors on a `Continuous` bound); a
step asks `Evaluator.evaluate` once a call site, and the census counts its
route. A goal task's dense reward is the left fold of its sprites in slot
order.

The `cuda` cases hold the kernel against the methods on the card, bit for
bit, at 2048 lanes of every config's seeded scenes and on the edge states,
eagerly and in a captured step. They skip without a card; on the card's
machine run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_task_eval.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine
lacks).
"""

import importlib
import pathlib

import numpy as np
import pytest
import torch

from spriteworld_torch.core import distributions as distribs
from spriteworld_torch.core import environment as env_lib
from spriteworld_torch.core import renderers
from spriteworld_torch.core import state as state_lib
from spriteworld_torch.core import tasks
from spriteworld_torch.ops import task_eval
from spriteworld_torch.utils import profiling

F32 = np.float32
CONFIGS = sorted(
    f"{p.parent.name}.{p.stem}" for p in pathlib.Path(
        tasks.__file__).parents[1].glob("configs/*/*.py")
    if p.stem not in ("__init__", "common"))
ALL = task_eval.REWARD | task_eval.SUCCESS | task_eval.VALID


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the task_eval kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def config(name, mode="train"):
    mod = importlib.import_module(f"spriteworld_torch.configs.{name}")
    return mod.get_config(mode)


# ---------------------------------------------------------------------- #
# A reading of the table, as csrc/task_eval.cu computes it.

def _f(word):
    return np.int32(word).view(F32)


NAN = np.uint32(0x7FC00000).view(F32)  # torch.nan as float32


def _root(x):
    return F32(np.sqrt(np.float64(x)))


def _contains(t, pc, f):
    stack = []
    while True:
        op = t[pc]
        if op == task_eval.P_TRUE:
            stack.append(True)
            pc += 1
        elif op == task_eval.P_CONTINUOUS:
            v = f[t[pc + 1]]
            stack.append(bool(v >= _f(t[pc + 2])) and bool(v < _f(t[pc + 3])))
            pc += 4
        elif op == task_eval.P_DISCRETE:
            v, n = f[t[pc + 1]], t[pc + 2]
            stack.append(any(bool(v == _f(w)) for w in t[pc + 3:pc + 3 + n]))
            pc += 3 + n
        elif op in (task_eval.P_ALL, task_eval.P_ANY):
            n = t[pc + 1]
            top = stack[len(stack) - n:]
            del stack[len(stack) - n:]
            stack.append(all(top) if op == task_eval.P_ALL else any(top))
            pc += 2
        elif op == task_eval.P_AND_NOT:
            hold = stack.pop()
            stack.append(stack.pop() and not hold)
            pc += 1
        else:
            assert op == task_eval.P_END and len(stack) == 1
            return stack[0]


def _goal(t, pc, rows, num):
    gx, gy, wx, wy, dist, mult, bonus = (_f(w) for w in t[pc + 2:pc + 9])
    dense, any_, ok = F32(0), False, True
    for k, f in enumerate(rows):
        term = F32(0)
        if k < num and _contains(t, t[pc + 1], f):
            dx, dy = f[0] - gx, f[1] - gy
            term = mult * (dist - _root(wx * (dx * dx) + wy * (dy * dy)))
            any_, ok = True, ok and bool(term >= 0)
        dense = term if k == 0 else dense + term
    reward = (NAN if not any_ else dense + bonus if ok
              else F32(0) if t[pc + 9] else dense)
    return reward, ok, True


def _davies_bouldin(member, rows):
    nc, k_max = len(member), len(rows)
    cx, cy, intra, safe, present = [], [], [], [], []
    for c in range(nc):
        count = F32(sum(member[c]))
        present.append(count > 0)
        safe.append(max(count, F32(1)))
        ax = ay = F32(0)
        for k, f in enumerate(rows):
            m = F32(member[c][k])
            ax = m * f[0] if k == 0 else ax + m * f[0]
            ay = m * f[1] if k == 0 else ay + m * f[1]
        cx.append(ax / safe[c])
        cy.append(ay / safe[c])
        acc = F32(0)
        for k, f in enumerate(rows):
            ex, ey = f[0] - cx[c], f[1] - cy[c]
            term = _root(ex * ex + ey * ey) * F32(member[c][k])
            acc = term if k == 0 else acc + term
        intra.append(acc / safe[c])
    intra_zero = all(bool(x <= F32(1e-8)) for x in intra)
    cdist_zero, total = True, F32(0)
    for i in range(nc):
        score = F32(0)
        for j in range(nc):
            ex, ey = cx[i] - cx[j], cy[i] - cy[j]
            cd = _root(ex * ex + ey * ey)
            pair = present[i] and present[j]
            cdist_zero &= bool(cd <= F32(1e-8)) or not (pair and i != j)
            ratio = (intra[i] + intra[j]) / (F32(np.inf) if cd == 0 else cd)
            v = ratio if pair else F32(0)
            score = v if j == 0 else (score if np.isnan(score) else
                                      v if np.isnan(v) else max(score, v))
        total = score if i == 0 else total + score
    num_present = sum(present)
    db = total / F32(max(num_present, 1))
    if intra_zero or cdist_zero:
        db = F32(0)
    return db if num_present >= 2 else NAN


def _cluster(t, pc, rows, num):
    nc = t[pc + 1]
    threshold, bonus, range_ = (_f(w) for w in t[pc + 2:pc + 5])
    member = [[0] * len(rows) for _ in range(nc)]
    for k, f in enumerate(rows[:max(num, 0)]):
        for c in range(nc):
            if _contains(t, t[pc + 6 + c], f):
                member[c][k] = 1
                break
    labels = sum(any(m) for m in member)
    samples = sum(map(sum, member))
    with np.errstate(divide="ignore", invalid="ignore"):
        metric = F32(1) / _davies_bouldin(member, rows) * F32(1)
        dense = (metric - threshold) * range_ * F32(0.5)
    success = bool(metric >= threshold)
    reward = (dense + bonus if success else F32(0) if t[pc + 5] else dense)
    return reward, success, 2 <= labels < samples


def _meta(t, pc, kids):
    aggregator, all_, has_bonus = t[pc + 2], t[pc + 3] == task_eval.C_ALL, \
        t[pc + 4]
    rewards = [r for r, _, _ in kids]
    success = (all if all_ else any)(s for _, s, _ in kids)
    if aggregator == task_eval.A_SUM:
        clean = [F32(0) if np.isnan(r) else r for r in rewards]
        agg = clean[0]
        for r in clean[1:]:
            agg = agg + r
    elif all(np.isnan(r) for r in rewards):
        agg = NAN
    else:
        fill = F32(-np.inf if aggregator == task_eval.A_MAX else np.inf)
        pick = max if aggregator == task_eval.A_MAX else min
        agg = pick(fill if np.isnan(r) else r for r in rewards)
    if has_bonus:
        agg = agg + _f(t[pc + 5]) * F32(success)
    return agg, success, all(v for _, _, v in kids)


def read_table(table, factors, num_sprites):
    """(reward f32[B], success bool[B], valid bool[B]) of the task that
    `table` describes, lane by lane in numpy float32, one rounding an
    operation in the kernel's order."""
    t = table.tolist()
    factors = np.asarray(factors, F32)
    out = []
    for rows, num in zip(factors, np.asarray(num_sprites).tolist()):
        stack, pc = [], task_eval.HEADER
        with np.errstate(invalid="ignore", over="ignore"):
            for _ in range(t[0]):
                op = t[pc]
                if op == task_eval.T_GOAL:
                    stack.append(_goal(t, pc, rows, num))
                    pc += 10
                elif op == task_eval.T_CLUSTER:
                    stack.append(_cluster(t, pc, rows, num))
                    pc += 6 + t[pc + 1]
                elif op == task_eval.T_NO_REWARD:
                    stack.append((F32(0), False, True))
                    pc += 1
                else:
                    n = t[pc + 1]
                    kids = stack[len(stack) - n:]
                    del stack[len(stack) - n:]
                    stack.append(_meta(t, pc, kids))
                    pc += 6
        assert len(stack) == 1
        out.append(stack[0])
    reward, success, valid = zip(*out) if out else ((), (), ())
    return (np.array(reward, F32), np.array(success, bool),
            np.array(valid, bool))


def methods(task, factors, num):
    """(reward, success, valid) from the task's own methods, as numpy."""
    return (task.reward(factors, num).cpu().numpy(),
            task.success(factors, num).cpu().numpy(),
            tasks.task_valid(task, factors, num).cpu().numpy())


def words_apart(got, want):
    """Words in which two (reward, success, valid) differ, rewards by
    their bits."""
    return (int((np.asarray(got[0], F32).view(np.int32)
                 != np.asarray(want[0], F32).view(np.int32)).sum())
            + int((np.asarray(got[1]) != np.asarray(want[1])).sum())
            + int((np.asarray(got[2]) != np.asarray(want[2])).sum()))


# ---------------------------------------------------------------------- #
# States.

def seeded_states(name, mode, lanes, device="cpu", seed=7):
    """Factors and counts of `lanes` fresh scenes of a config, then the
    same scenes with their sprites moved onto a grid of quarter steps
    (the goals and cluster centres of the configs lie on it) and onto the
    `Continuous` bounds of their colours: successes, ties and boundary
    values besides the random scenes."""
    cfg = config(name, mode)
    env = env_lib.Environment(**cfg, device=device, seed=seed)
    gen = cfg["init_sprites"]
    from spriteworld_torch.ops import lane_random

    keys = lane_random.split(lane_random.key(seed, device), lanes)
    factors, num, _ = gen.sample_with_status(keys)
    rng = np.random.default_rng(seed)
    grid = factors.clone()
    b, k, _ = grid.shape
    grid[..., 0:2] = torch.from_numpy(
        rng.integers(0, 5, (b, k, 2)).astype(F32) / 4).to(device)
    edges = grid.clone()
    edges[..., 5] = torch.from_numpy(rng.choice(
        np.array([0.0, 0.1, 0.2, 0.27, 0.37, 0.4, 0.5, 0.55, 0.65, 0.9,
                  1.0, 64, 128, 192, 256], F32), (b, k))).to(device)
    return env, [(factors, num), (grid, num), (edges, num)]


def edge_states(device="cpu"):
    """(name, task, factors, num) of the edge cases, one lane each: an
    empty filter, four filtered sprites (the slot-order fold), all
    singleton clusters, one populated cluster, none, and factors on a
    filter's `Continuous` bounds."""
    hue = distribs.Continuous("c0", 0.25, 0.5)
    goal = tasks.FindGoalPosition(filter_distrib=hue,
                                  terminate_distance=0.3, terminate_bonus=1.5)
    clusters = tasks.Clustering([distribs.Continuous("c0", 0.0, 0.3),
                                 distribs.Continuous("c0", 0.3, 0.6),
                                 distribs.Continuous("c0", 0.6, 1.0)])
    both = tasks.MetaAggregated([clusters, goal], terminate_bonus=2.0)
    rng = np.random.default_rng(5)

    def row(c0s, xy=None):
        f = np.tile(state_lib.DEFAULT_FACTORS, (1, 6, 1))
        f[0, :, 0:2] = rng.uniform(0, 1, (6, 2)) if xy is None else xy
        f[0, :len(c0s), 5] = c0s
        return (torch.from_numpy(f).to(device),
                torch.tensor([len(c0s)], dtype=torch.int32, device=device))

    cases = {
        "empty_filter": (goal, row([0.1, 0.6, 0.9])),
        "four_filtered": (goal, row([0.3, 0.31, 0.4, 0.45, 0.9])),
        "four_filtered_at_goal": (goal, row(
            [0.3, 0.31, 0.4, 0.45], np.full((6, 2), 0.5, F32))),
        "singletons": (clusters, row([0.1, 0.4, 0.7])),
        "one_cluster": (clusters, row([0.1, 0.2, 0.05])),
        "no_cluster": (clusters, row([])),
        "on_bounds": (both, row([0.25, 0.5, 0.3, 0.6, 0.0, 1.0])),
        "coincident": (clusters, row([0.1, 0.2, 0.4, 0.5],
                                     np.full((6, 2), 0.25, F32))),
    }
    return [(name, task, *state) for name, (task, state) in cases.items()]


# ---------------------------------------------------------------------- #
# CPU: routes, tables, the reading of the table, the call sites.

@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", CONFIGS)
def test_every_config_task_has_a_table(name, mode):
    task = config(name, mode)["task"]
    table = tasks.task_table(task)
    assert table is not None
    assert table.dtype == np.int32
    assert 1 <= table[1] <= task_eval.MAX_TASK_DEPTH
    assert len(table) <= task_eval.MAX_WORDS
    assert tasks.Evaluator(task).table.tolist() == table.tolist()


class OtherTask(tasks.FindGoalPosition):
    """A FindGoalPosition subclass: the table cannot know what it
    overrides."""


class OtherDistribution(distribs.Continuous):
    """A Continuous subclass: the same, for a filter."""


@pytest.mark.parametrize("build", [
    lambda: tasks.MetaAggregated([tasks.FindGoalPosition()], "mean"),
    lambda: tasks.MetaAggregated([tasks.NoReward(), OtherTask()]),
    lambda: OtherTask(),
    lambda: tasks.FindGoalPosition(OtherDistribution("c0", 0, 1)),
    lambda: tasks.Clustering([distribs.Continuous("c0", 0, 1),
                              OtherDistribution("c0", 1, 2)]),
    lambda: tasks.FindGoalPosition(distribs.Continuous("not_a_factor", 0,
                                                       1)),
    lambda: tasks.FindGoalPosition(distribs.Continuous("c0", np.float32(0),
                                                       1)),
    lambda: tasks.Clustering([distribs.Continuous("c0", i, i + 1)
                              for i in range(task_eval.MAX_CLUSTERS + 1)]),
], ids=["mean", "unknown_subtask", "unknown_task", "unknown_filter",
        "unknown_cluster", "unknown_column", "numpy_bound", "many_clusters"])
def test_trees_the_kernel_cannot_evaluate_take_the_methods(build):
    task = build()
    assert tasks.task_table(task) is None
    f = torch.from_numpy(np.tile(state_lib.DEFAULT_FACTORS, (2, 3, 1)))
    evaluator = tasks.Evaluator(task)
    with profiling.capture("plain") as rec:
        try:
            evaluator.evaluate(f, torch.tensor([3, 1], dtype=torch.int32),
                               task_eval.SUCCESS, "test")
        except KeyError:  # the methods' own error for an unknown column
            pass
    assert rec.task_routes == {(type(task).__name__, "plain"): 1}


def test_the_table_holds_the_float32_bits_of_the_config_values():
    table = tasks.task_table(config("cobra.sorting")["task"])
    from spriteworld_torch.configs.cobra import sorting

    assert table[0] == len(sorting.SUBTASKS) + 1  # five goals, the meta
    pc = task_eval.HEADER
    for sub in sorting.SUBTASKS:
        assert table[pc] == task_eval.T_GOAL
        assert table[pc + 2:pc + 9].tolist() == [
            task_eval.f32_bits(v) for v in (
                *sub["goal_position"], 1, 1, sorting.TERMINATE_DISTANCE,
                sorting.RAW_REWARD_MULTIPLIER, 0.0)]
        hue = table[table[pc + 1]:table[pc + 1] + 5].tolist()
        assert hue == [task_eval.P_CONTINUOUS, state_lib.C0,
                       task_eval.f32_bits(sub["hue"][0]),
                       task_eval.f32_bits(sub["hue"][1]), task_eval.P_END]
        pc += 10
    assert table[pc:pc + 6].tolist() == [task_eval.T_META, 5,
                                         task_eval.A_SUM, task_eval.C_ALL,
                                         0, 0]
    # The compositional example: its Clustering's scalars and a shape.
    words = tasks.task_table(
        config("examples.goal_finding_clustering")["task"])
    pc = task_eval.HEADER
    assert words[pc:pc + 6].tolist() == [
        task_eval.T_CLUSTER, 3, task_eval.f32_bits(2.5),
        task_eval.f32_bits(0.0), task_eval.f32_bits(10.0), 0]
    tri = words[words[pc + 6]:words[pc + 6] + 5].tolist()
    assert tri == [task_eval.P_DISCRETE, state_lib.SHAPE, 1,
                   task_eval.f32_bits(1.0), task_eval.P_END]
    # A bound that float32 rounds down: the table keeps the float32 value,
    # which torch's float32 comparison uses too.
    table = tasks.task_table(tasks.FindGoalPosition(
        distribs.Continuous("c0", 0.9, 1.1)))
    assert table[table[task_eval.HEADER + 1] + 2] == task_eval.f32_bits(0.9)
    assert float(F32(0.9)) < 0.9


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", CONFIGS)
def test_the_table_read_in_float32_equals_the_methods(name, mode):
    env, states = seeded_states(name, mode, 64)
    table = tasks.task_table(env.task)
    for factors, num in states:
        got = read_table(table, factors.numpy(), num.numpy())
        assert words_apart(got, methods(env.task, factors, num)) == 0


@pytest.mark.parametrize("case", edge_states(), ids=lambda c: c[0])
def test_the_table_read_in_float32_equals_the_methods_at_the_edges(case):
    name, task, factors, num = case
    table = tasks.task_table(task)
    want = methods(task, factors, num)
    assert words_apart(read_table(table, factors, num), want) == 0
    if name == "empty_filter":
        assert np.isnan(want[0][0]) and want[1][0]
    if name in ("singletons", "one_cluster", "no_cluster"):
        assert not want[2][0]
    if name == "singletons":
        assert torch.isinf(tasks.Clustering._metric(task, factors, num)[0])


def test_a_goal_reward_folds_its_sprites_in_slot_order():
    """Four filtered sprites: ((r0 + r1) + r2) + r3 in float32, whatever
    order a reduction kernel would take."""
    task = tasks.FindGoalPosition(terminate_distance=0.4)
    rng = np.random.default_rng(11)
    f = np.tile(state_lib.DEFAULT_FACTORS, (256, 4, 1))
    f[..., 0:2] = rng.uniform(0, 1, (256, 4, 2))
    num = torch.full((256,), 4, dtype=torch.int32)
    per = task._per_sprite_rewards(torch.from_numpy(f)).numpy()
    fold = ((per[:, 0] + per[:, 1]) + per[:, 2]) + per[:, 3]
    got = task.reward(torch.from_numpy(f), num).numpy()
    ok = (per >= 0).all(-1)
    np.testing.assert_array_equal(got[~ok], fold[~ok])
    assert (~ok).sum() > 100


def _env(name="examples.goal_finding_clustering", lanes=3):
    cfg = config(name)
    cfg["renderers"] = {"image": renderers.ImageRenderer(
        image_size=(16, 16), anti_aliasing=1)}
    env = env_lib.Environment(**cfg, device="cpu")
    state, _ = env.reset_batch(lanes)
    return env, state, env.sample_action(env.lane_keys(lanes))


def test_a_step_evaluates_the_task_once_a_call_site(monkeypatch):
    """The transition asks for all three outputs, the fresh scene for its
    validity, the render for its success: three kernel launches, and no
    task method runs."""
    env, state, actions = _env()
    calls = []

    def fake(table, factors, num, want, site):
        calls.append((want, site))
        b = factors.shape[0]
        return (torch.zeros(b) if want & task_eval.REWARD else None,
                torch.zeros(b, dtype=torch.bool)
                if want & task_eval.SUCCESS else None,
                torch.ones(b, dtype=torch.bool)
                if want & task_eval.VALID else None)

    monkeypatch.setattr(task_eval, "takes", lambda factors: True)
    monkeypatch.setattr(task_eval, "task_eval", fake)
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    with profiling.capture("step") as rec:
        env.step_batch(state, actions)
    assert calls == [(ALL, "transition"), (task_eval.VALID, "fresh"),
                     (task_eval.SUCCESS, "render")]
    assert rec.evaluations == {}
    assert rec.census_table()["task_route.MetaAggregated"] == {
        "kernel": {"evaluations": 3}}


def test_the_cpu_route_counts_plain_and_runs_the_methods(monkeypatch):
    env, state, actions = _env()
    monkeypatch.setattr(profiling, "_driver", lambda: None)
    with profiling.capture("step") as rec:
        new, ts = env.step_batch(state, actions)
    assert rec.census_table()["task_route.MetaAggregated"] == {
        "plain": {"evaluations": 3}}
    assert rec.evaluations[("MetaAggregated", "reward")] == 1
    want = methods(env.task, new.factors, new.num_sprites)
    assert (new.task_valid.numpy() == want[2]).all()


def test_the_launch_wrapper_refuses_what_the_kernel_cannot_take():
    table = tasks.task_table(tasks.NoReward())
    f = torch.zeros(2, 3, 10)
    with pytest.raises(ValueError, match="CUDA factors"):
        task_eval.task_eval(table, f, torch.zeros(2, dtype=torch.int32),
                            ALL, "test")
    assert not task_eval.takes(f)
    assert not task_eval.takes(torch.zeros(2, 3, 10, dtype=torch.float64))


# ---------------------------------------------------------------------- #
# The card: the kernel against the methods.

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", CONFIGS)
def test_the_kernel_equals_the_methods_on_every_config(card, name, mode):
    env, states = seeded_states(name, mode, 2048, device=card)
    table = tasks.task_table(env.task)
    for factors, num in states:
        want = methods(env.task, factors, num)
        for ask in (ALL, task_eval.VALID, task_eval.SUCCESS):
            got = task_eval.task_eval(table, factors, num, ask, "test")
            for i, bit in enumerate((task_eval.REWARD, task_eval.SUCCESS,
                                     task_eval.VALID)):
                assert (got[i] is None) == (not ask & bit)
            got = [g.cpu().numpy() if g is not None else w
                   for g, w in zip(got, want)]
            assert words_apart(got, want) == 0, (name, mode, ask)


@pytest.mark.cuda
@pytest.mark.parametrize("case", edge_states(), ids=lambda c: c[0])
def test_the_kernel_equals_the_methods_at_the_edges(card, case):
    _, task, factors, num = case
    factors, num = factors.to(card), num.to(card)
    got = task_eval.task_eval(tasks.task_table(task), factors, num, ALL,
                              "test")
    assert words_apart([g.cpu().numpy() for g in got],
                       methods(task, factors, num)) == 0


@pytest.mark.cuda
def test_a_captured_step_launches_the_kernel_three_times(card):
    cfg = config("examples.goal_finding_clustering")
    env = env_lib.Environment(**cfg, device=card)
    state, _ = env.reset_batch(64)
    actions = env.sample_action(env.lane_keys(64))
    env.step_batch(state, actions)
    torch.cuda.synchronize()
    task_eval.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    pending = torch.zeros((), dtype=torch.bool, device=card)
    with torch.cuda.graph(graph), distribs.defer_rejection(pending):
        with profiling.capture("task_eval_test") as rec:
            new, ts = env.step_batch(state, actions)
    assert task_eval.task_eval.by_site == {"transition": 1, "fresh": 1,
                                           "render": 1}
    census = rec.census_table()
    assert census["task_route.MetaAggregated"] == {
        "kernel": {"evaluations": 3}}
    assert sum(v["launches"] for v in census["task_eval"].values()) == 3
    assert not any(k.startswith("task.") for k in census)
    if rec.nodes is not None:
        names = [fn for kind, _, fn in rec.nodes if kind == "kernel"]
        assert sum("task_eval" in (n or "") for n in names) == 3
    graph.replay()
    torch.cuda.synchronize()
    want = methods(env.task, new.factors, new.num_sprites)
    assert (new.task_valid.cpu().numpy() == want[2]).all()
