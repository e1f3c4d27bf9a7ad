"""perfbench's own tests: on the CPU, at sizes a test run holds.

Run from the repository's root: `python -m pytest perfbench/tests -q`.
`tiny_layout` is a copy of the benchmark's files whose traffic mixes hold
a few lanes and short calls, so that a whole run of a cell (set-up, window,
comparison with the reference) takes seconds on the CPU.
"""

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "rollout": {"lanes": 4, "steps_per_call": 3, "warmup_calls": 1,
                "check": {"lanes": 4, "calls": 2},
                "trace": {"calls": 2}},
    "single": {"warmup_steps": 2, "check": {"episodes": 2},
               "trace": {"steps": 4}},
}


def make_tiny_layout(dest: pathlib.Path) -> pathlib.Path:
    """A copy of BENCHMARK.json and perfbench/ under `dest` with tiny
    traffic mixes; returns `dest`."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("out", "tests",
                                                  "__pycache__"))
    for name, update in TINY.items():
        path = dest / "perfbench" / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(update)
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture
def tiny_layout(tmp_path):
    from perfbench import harness

    return harness.Layout(make_tiny_layout(tmp_path))
