"""lane_random.useful_blocks.rollout: the share, in %, of the threefry
blocks that the port's `lane_random` launches compute a step that the
step's outputs need: the blocks the plain reference computed a lane step
(`Tally.blocks`: a fresh scene only for the lanes that reset, a rejection
node's rounds only until it accepts), times the lanes, plus the action
key's split (the numerator of `lane_random_roofline`), over the blocks
the runner graph's launches compute a replay, one step (its census,
counted at capture by the kernel's wrapper). None where the program
keeps no census. Moves env_steps_per_s."""

from perfbench import nodemap


def read(ctx):
    g = nodemap.runner_graph(with_nodes=False)
    tally = ctx.tally
    if g is None or not tally.lane_steps:
        return None
    computed = sum(blocks for (kernel, _), (_, blocks) in g.census.items()
                   if kernel == "lane_random")
    if not computed:
        return None
    needed = tally.blocks / tally.lane_steps * ctx.lanes + 2
    return 100.0 * needed / computed
