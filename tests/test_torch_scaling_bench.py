"""scaling_bench_torch.py's weak-scaling mode on the CPU: one and two gloo
processes of the factors workload, rows into a temporary --out that
already holds another metric's rows."""

import json
import os
import subprocess
import sys

import scaling_bench_torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_weak_scaling_on_gloo_writes_rows_and_keeps_others(tmp_path):
    out = tmp_path / "scaling.jsonl"
    other = {"metric": scaling_bench_torch.SWEEP_METRIC, "devices": 1,
             "num_envs": 256, "steps_per_sec": 1.0}
    stale = {"metric": scaling_bench_torch.WEAK_METRIC, "devices": 9}
    out.write_text(json.dumps(other) + "\n" + json.dumps(stale) + "\n")
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES" and not k.startswith("JAX_")}
    res = subprocess.run(
        [sys.executable, "scaling_bench_torch.py", "--device", "cpu",
         "--devices", "2", "--envs_per_device", "8", "--steps", "3",
         "--out", str(out)],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    assert rows[0] == other
    weak = rows[1:]
    assert [r["devices"] for r in weak] == [1, 2]
    assert [r["num_envs"] for r in weak] == [8, 16]
    for r in weak:
        assert r["metric"] == scaling_bench_torch.WEAK_METRIC
        assert r["steps_per_sec"] > 0 and r["card"] == "cpu"
        assert "virtual devices share host cores" in r["note"]
        assert abs(r["efficiency"] * r["devices"] - r["speedup_vs_1dev"]) \
            < 1e-9
    assert weak[0]["speedup_vs_1dev"] == 1.0
    printed = [json.loads(l) for l in res.stdout.splitlines()
               if l.startswith("{")]
    assert printed == weak


def test_batch_sweep_rows(tmp_path):
    """The sweep's rows on the CPU at two small batches."""
    out = tmp_path / "sweep.jsonl"
    rows = scaling_bench_torch.batch_sweep(str(out), 2, batches=(4, 8),
                                           device="cpu")
    assert [r["num_envs"] for r in rows] == [4, 8]
    assert all(r["steps_per_sec"] > 0 and r["card"] == "cpu" for r in rows)
    assert [json.loads(l) for l in out.read_text().splitlines()] == rows
