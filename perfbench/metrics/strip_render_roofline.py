"""strip_render_roofline: the row-strip render's share of its roofline, in
%: the least time of one frame batch, counted from the cell's inputs and
outputs whatever implements the render (`perfbench/roofline/scene_raster.py`:
the lanes' factors read once, their u8 images written once, Pillow's two
Lanczos passes at the int8 tensor-core rate), over the mean device time a
step of the `strip_raster` and `strip_vpass` launches in rollout calls. One
share covers the pair: the h-pass buffer between them is the
implementation's choice. None where no strip kernel ran. Moves
env_steps_per_s."""

KERNELS = ("strip_raster", "strip_vpass")


def read(ctx):
    ks = [o for o in ctx.trace.span_ops("rollout") if o.kind == "kernel"
          and any(k in o.name for k in KERNELS)]
    if not ks or not ctx.steps:
        return None
    measured = sum(o.end - o.start for o in ks) / 1e9 / ctx.steps
    c = ctx.config
    least = ctx.roofline("scene_raster").least_seconds(
        ctx.lanes, c["image_size"], c["anti_aliasing"], c["max_sprites"])
    return 100.0 * least / measured
