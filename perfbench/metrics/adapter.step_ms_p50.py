"""adapter.step_ms_p50: the median host-clock ms of one step() call, from
the call to the returned host TimeStep, over the window's calls outside
the profiled slice. Moves step_ms."""

import statistics


def read(ctx):
    ms = ctx.host_step_ms
    return statistics.median(ms) if ms else None
