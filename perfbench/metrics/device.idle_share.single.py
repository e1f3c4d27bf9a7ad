"""device.idle_share.single: the share of the profiled slice, in %, in
which no operation ran on the device. Moves step_ms."""


def read(ctx):
    t = ctx.trace
    if not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
