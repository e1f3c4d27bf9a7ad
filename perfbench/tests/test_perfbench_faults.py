"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place) and the timed path broken underneath a
whole run (the harness's look for a card skipped, the rest run on the CPU
at a tiny size). The cells run on one card, so no exchange between cards
can be left out."""

import pytest

from perfbench import check, harness, traffic

ROLLOUT = ("goal_finding.rollout", "sorting.rollout")
SINGLE = ("goal_finding.single", "sorting.single")


def _run(layout, cell, seed=11):
    result, _, rows = harness.run(layout, cell, seed, 0.3, False, "cpu")
    return result, dict((n, v) for n, v, _ in rows)


@pytest.mark.parametrize("cell", ROLLOUT + SINGLE)
def test_sound_run_is_correct_and_control_is_not(tiny_layout, cell):
    result, counts = _run(tiny_layout, cell)
    assert result["correct"], counts
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = tiny_layout.cell(cell)
    config = tiny_layout.config(spec["config"])
    feed = traffic.build(tiny_layout, tiny_layout.traffic(spec["traffic"]),
                         harness.env_kwargs(config), config["observation"],
                         "cpu", 12)
    feed.setup(0.3)
    feed.window(0.3, False)
    rec = feed.records()
    feed.free()
    reference = check.reference_module(tiny_layout.reference(spec["config"]))
    tally = feed.check(rec, reference, config["observation"], control=True)
    correct, _ = check.verdict(tally, config["limits"])
    assert not correct, tally.counts


def _unchanged(orig):
    def step_batch(self, state, actions):
        _, ts = orig(self, state, actions)
        return state, ts
    return step_batch


def _half_batch(orig):
    def step_batch(self, state, actions):
        new, ts = orig(self, state, actions)
        half = state.num_sprites.shape[0] // 2
        for name in ("factors", "num_sprites", "step_count", "reset_next",
                     "key"):
            getattr(new, name)[half:] = getattr(state, name)[half:]
        return new, ts
    return step_batch


def _altered_answer(orig):
    def observation_batch(self, factors, num_sprites, success):
        obs = orig(self, factors, num_sprites, success)
        obs["image"] = obs["image"].clone()
        obs["image"][:, 0, 0, 0] += 1
        return obs
    return observation_batch


FAULTS = {
    "state unchanged": ("step_batch", _unchanged),
    "half the batch": ("step_batch", _half_batch),
    "answer altered": ("observation_batch", _altered_answer),
}


# A single env steps a batch of one: no half of it can be left out.
CASES = [(cell, fault) for cell in ROLLOUT + SINGLE for fault in FAULTS
         if not (fault == "half the batch" and cell in SINGLE)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_timed_path_is_not_correct(tiny_layout, monkeypatch, cell,
                                          fault):
    from spriteworld_torch.core import environment as env_lib

    attr, wrap = FAULTS[fault]
    monkeypatch.setattr(env_lib.Environment, attr,
                        wrap(getattr(env_lib.Environment, attr)))
    result, counts = _run(tiny_layout, cell)
    assert not result["correct"], counts
    assert result["failed"] > 0


@pytest.mark.parametrize("cell", ROLLOUT)
def test_a_fault_in_the_warm_up_carried_into_the_window_is_caught(
        tiny_layout, monkeypatch, cell):
    """The first rollout call (a warm-up call) moves every sprite; every
    later call steps soundly from that state, so only the reference's own
    chain from the seed, through the warm-up, sees it."""
    from spriteworld_torch.parallel import ShardedRunner

    orig, calls = ShardedRunner.rollout, []

    def rollout(self, state, num_steps, **kwargs):
        out = orig(self, state, num_steps, **kwargs)
        calls.append(num_steps)
        if len(calls) == 1:
            out[0].factors[..., 0] += 0.01
        return out

    monkeypatch.setattr(ShardedRunner, "rollout", rollout)
    result, counts = _run(tiny_layout, cell)
    assert not result["correct"], counts
    assert counts["state_values_off"] > 0
