"""scene_raster.live_share.rollout: the share, in %, of the scene kernel's
v-pass units (16 output rows by 8 output columns of a scene) that its
Lanczos instantiation computed in the last replay of the runner graph's
step; the others it wrote from the taps' sums as background. Read from
the graph's census (`live_units`: a counter the kernel keeps on the card,
read when the census is taken). Lower means more units skipped. None where
the program keeps no such counter. Moves env_steps_per_s."""

from perfbench import nodemap


def read(ctx):
    g = nodemap.runner_graph(with_nodes=False)
    if g is None:
        return None
    rows = g.census_table().get("scene_raster", {}).values()
    counts = [r["live_units"] for r in rows if "live_units" in r]
    if not counts:
        return None
    return 100.0 * sum(c[0] for c in counts) / sum(c[1] for c in counts)
