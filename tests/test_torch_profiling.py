"""Profiling/debug helpers of the port (`spriteworld_torch.utils.profiling`),
mirroring tests/test_profiling.py."""

import json

import pytest
import torch

from spriteworld_torch.utils import profiling


def test_step_timer_accumulates_across_chunks():
    t = profiling.StepTimer()
    x = torch.arange(8.0)
    for _ in range(3):
        t.start()
        y = torch.sin(x).sum()
        t.stop(100, sync_on=y)
    assert t.steps_per_sec > 0
    # 300 steps over a strictly positive elapsed time.
    assert t._steps == 300 and t._elapsed > 0


def test_annotate_names_a_range_in_the_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("square"):
            y = torch.arange(4.0) * torch.arange(4.0)
    assert torch.equal(y, torch.arange(4.0) ** 2)
    assert any(e.key == "square" for e in prof.key_averages())
    events = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "square" for e in events["traceEvents"])


def test_trace_writes_profile(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones((8, 8)).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_enable_debug_checks_flags_nan_and_inf():
    profiling.enable_debug_checks(nans=True, infs=False)
    try:
        with pytest.raises(FloatingPointError):
            torch.tensor(1.0) / 0.0 * 0.0
        torch.tensor(1.0) / 0.0  # an Inf passes with infs=False
    finally:
        profiling.enable_debug_checks(nans=False, infs=False)
    assert torch.isnan(torch.tensor(1.0) / 0.0 * 0.0)  # checks are off
    profiling.enable_debug_checks(nans=False, infs=True)
    try:
        with pytest.raises(FloatingPointError):
            torch.tensor(1.0) / 0.0
    finally:
        profiling.enable_debug_checks(nans=False, infs=False)


def test_sync_takes_a_tensor_or_a_tree():
    profiling.sync(torch.tensor(3.0))
    profiling.sync({"a": torch.arange(6).reshape(2, 3)})
    profiling.sync({})
