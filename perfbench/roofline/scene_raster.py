"""The least time of one launch of the scene kernel: rendering a batch of
scenes to u8 images at anti_aliasing > 1 (Pillow's polygon fill on the
anti_aliasing-times canvas, then Pillow's two-pass Lanczos resize).

Counted from the cell's inputs and outputs, whatever implements them:
each lane's sprite factors (float32[K, 10]) read once and its image
(u8[H, W, 3]) written once, at 3.35 TB/s; the multiply-adds that Pillow's
Lanczos passes need (two operations each) at 1,979 TOP/s, the H100's int8
tensor-core rate. The fill counts no operation, so the time is a lower
bound. Published peaks of one H100 SXM at its 700 W limit.
"""

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
LANCZOS_SUPPORT = 3.0


def lanczos_taps(in_size: int, out_size: int) -> int:
    """The taps of all outputs of one Lanczos pass from `in_size` to
    `out_size` samples: Pillow's `precompute_coeffs` bounds."""
    scale = in_size / out_size
    support = LANCZOS_SUPPORT * max(scale, 1.0)
    taps = 0
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        taps += hi - lo
    return taps


def work(lanes: int, image_size, anti_aliasing: int, sprites: int):
    """(bytes, operations) of one launch over `lanes` scenes."""
    h, w = image_size
    hc, wc = h * anti_aliasing, w * anti_aliasing
    bytes_ = lanes * (sprites * 10 * 4 + h * w * 3)
    macs = 3 * (hc * lanczos_taps(wc, w) + w * lanczos_taps(hc, h))
    return bytes_, 2 * lanes * macs


def least_seconds(lanes: int, image_size, anti_aliasing: int,
                  sprites: int) -> float:
    bytes_, ops = work(lanes, image_size, anti_aliasing, sprites)
    return max(bytes_ / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)
