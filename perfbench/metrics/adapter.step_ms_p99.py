"""adapter.step_ms_p99: the 99th percentile of the host-clock ms of one
step() call over the window's calls outside the profiled slice; None with
fewer than 1,000 calls (ten beyond it). Moves step_ms."""

import numpy as np


def read(ctx):
    ms = ctx.host_step_ms
    if len(ms) < 1000:
        return None
    return float(np.quantile(np.asarray(ms, np.float64), 0.99))
