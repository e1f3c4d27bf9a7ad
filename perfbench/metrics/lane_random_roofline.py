"""lane_random_roofline: the step's random draws' share of their
roofline, in %: the least time of a step's draws
(`perfbench/roofline/lane_random.py`, from the threefry blocks the plain
reference needed a lane step, times the lanes, plus the action key's split)
over the measured device time of `lane_random` launches a step in rollout
calls. None where the kernel did not run. Moves env_steps_per_s."""


def read(ctx):
    ks = [o for o in ctx.trace.span_ops("rollout") if o.kind == "kernel"
          and "lane_random" in o.name]
    tally = ctx.tally
    if not ks or not ctx.steps or not tally.lane_steps:
        return None
    measured = sum(o.end - o.start for o in ks) / 1e9 / ctx.steps
    blocks = tally.blocks / tally.lane_steps * ctx.lanes + 2
    least = ctx.roofline("lane_random").least_seconds(blocks, ctx.lanes)
    return 100.0 * least / measured
