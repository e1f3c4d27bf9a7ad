"""The least time of a step's random draws (`lane_random`'s launches).

Counted from what the step's outputs need, whatever implements them: the
threefry2x32-20 blocks of the keys and draws that the outputs depend on,
as the plain reference computes them (`Tally.blocks`: a fresh scene only
for the lanes that reset, a rejection node's rounds only until it
accepts), at 72 integer operations a block (20 rounds of an add, a rotate
and an xor; six key injections of two adds) at 67e12 operations a second,
the H100's published float32 rate outside the tensor cores, which is above
its integer rate, so the time is a lower bound; and the bytes of each
stepping lane's key read and written once and its four action floats
written once, at 3.35 TB/s.
"""

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
OPS_PER_BLOCK = 72
BYTES_PER_LANE = 8 + 8 + 16


def least_seconds(blocks: float, lanes: int) -> float:
    """The least time of one step's draws: `blocks` threefry blocks over
    `lanes` lanes."""
    return max(blocks * OPS_PER_BLOCK / INT_OPS_PER_S,
               lanes * BYTES_PER_LANE / HBM_BYTES_PER_S)
