"""scene_raster_roofline: the scene kernel's share of its roofline, in %:
the least time of one launch (`perfbench/roofline/scene_raster.py`, from
the cell's lanes, image size, anti_aliasing and sprites) over the mean
measured device time of its launches in rollout calls. None where the
kernel did not run. Moves env_steps_per_s."""


def read(ctx):
    ks = [o for o in ctx.trace.span_ops("rollout") if o.kind == "kernel"
          and "scene_raster" in o.name]
    if not ks:
        return None
    measured = sum(o.end - o.start for o in ks) / 1e9 / len(ks)
    c = ctx.config
    least = ctx.roofline("scene_raster").least_seconds(
        ctx.lanes, c["image_size"], c["anti_aliasing"], c["max_sprites"])
    return 100.0 * least / measured
