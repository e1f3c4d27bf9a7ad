"""Port parity, the tensor-core Lanczos passes' arithmetic.

The scene and strip kernels run Pillow's two Lanczos passes as banded
integer products on the int8 tensor cores (csrc/lanczos_mma.cuh): each
22-bit tap q is split into limbs lo + mid * 2^8 + hi * 2^16 (u8, u8, s8),
each limb's product is an exact int32 sum, and 2^21 + S_lo + (S_mid << 8) +
(S_hi << 16) is combined in wrapping 32-bit arithmetic. The tiles come from
`rasterize_cuda.lanczos_tiles`. These tests hold the tiles to Pillow's taps
(and the JAX package's tap matrix), and a torch emulation of the tile-wise
product to the plain passes, bit for bit, on the CPU; the kernels
themselves are held to the plain passes on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from spriteworld_tpu.ops import resample as jresample

from spriteworld_torch.ops import rasterize_cuda as tcuda
from spriteworld_torch.ops import resample as tresample

from test_torch_rasterize import _sprites

# (in_size, out_size): image64/AA=5, demo256/AA=10, 32x32/AA=3, a
# non-integer ratio, the other Lanczos size of the mosaic-parity CASES
# (32x32/AA=2), chip_smoke.py's 128x128/AA=5 and 96x160/AA=3, and a canvas
# narrower than one tile's window (its windows start earlier).
SIZES = [(320, 64), (2560, 256), (96, 32), (160, 64), (64, 32), (640, 128),
         (288, 96), (480, 160), (20, 10)]


def _dense(tiles, in_size, out_size):
    """i64[out, in]: the tiles' taps scattered back, recombined from the
    limbs."""
    q = (tiles.limbs[:, 0] + (tiles.limbs[:, 1] << 8)
         + (tiles.limbs[:, 2] << 16))  # [mt, 16, KT]
    dense = np.zeros((q.shape[0] * tcuda.MMA_M, tiles.pitch), np.int64)
    window = tcuda.MMA_K * tiles.ksteps
    for m, k0 in enumerate(tiles.kstart):
        dense[m * tcuda.MMA_M:(m + 1) * tcuda.MMA_M, k0:k0 + window] = q[m]
    assert not dense[out_size:].any() and not dense[:, in_size:].any()
    return dense[:out_size, :in_size]


@pytest.mark.parametrize("in_size,out_size", SIZES)
def test_limbs_lie_in_their_types_and_recombine_to_the_taps(in_size,
                                                            out_size):
    tiles = tcuda.lanczos_tiles(in_size, out_size)
    lo, mid, hi = (tiles.limbs[:, i] for i in range(3))
    assert lo.min() >= 0 and lo.max() <= 255
    assert mid.min() >= 0 and mid.max() <= 255
    assert hi.min() >= -128 and hi.max() <= 127
    want = tresample.pil_lanczos_matrix_q(in_size, out_size)
    np.testing.assert_array_equal(_dense(tiles, in_size, out_size), want)
    # Each output's tap sum, for windows of one colour; none past out_size.
    np.testing.assert_array_equal(tiles.qsum[:out_size], want.sum(1))
    assert not tiles.qsum[out_size:].any()
    # The JAX package's tap matrix, q / 2^22.
    np.testing.assert_array_equal(
        _dense(tiles, in_size, out_size).astype(np.float64) / 2.0 ** 22,
        jresample.pil_lanczos_matrix(in_size, out_size).astype(np.float64))


@pytest.mark.parametrize("in_size,out_size", SIZES)
def test_every_tap_lies_in_its_tiles_aligned_window(in_size, out_size):
    tiles = tcuda.lanczos_tiles(in_size, out_size)
    window = tcuda.MMA_K * tiles.ksteps
    mt = -(-out_size // tcuda.MMA_M)
    assert tiles.kstart.shape == (mt,)
    assert (tiles.kstart % 16 == 0).all() and (tiles.kstart >= 0).all()
    assert (tiles.kstart + window <= tiles.pitch).all()
    assert tiles.pitch >= in_size and tiles.pitch % 16 == 0
    assert (tiles.pitch // 16) % 2 == 1  # conflict-free fragment loads
    xmins, taps = tresample.pil_lanczos_fixed(in_size, out_size)
    for o, (xmin, t) in enumerate(zip(xmins, taps)):
        nz = xmin + np.flatnonzero(t)
        k0 = tiles.kstart[o // tcuda.MMA_M]
        assert nz.min() >= k0 and nz.max() < k0 + window, o


@pytest.mark.parametrize("in_size,out_size", SIZES)
def test_fragments_hold_the_limb_bytes_in_mma_order(in_size, out_size):
    """A fragment register r of lane 4 * group + t holds rows group + 8 *
    (r & 1) and inputs 16 * (r >> 1) + 4t .. + 3 of the K step, little
    endian (mma.m16n8k32's A layout for 8-bit types)."""
    tiles = tcuda.lanczos_tiles(in_size, out_size)
    mt, ks = tiles.kstart.shape[0], tiles.ksteps
    assert tiles.frags.shape == (mt, ks, 3, 32, 4)
    assert tiles.frags.dtype == np.int32 and tiles.frags.flags.c_contiguous
    frag_bytes = tiles.frags.view(np.uint8).reshape(mt, ks, 3, 32, 4, 4)
    u8 = (tiles.limbs & 255).astype(np.uint8)
    for lane in (0, 5, 18, 31):
        g, t = lane >> 2, lane & 3
        for r in range(4):
            row = g + 8 * (r & 1)
            col = 16 * (r >> 1) + 4 * t
            for s in range(ks):
                np.testing.assert_array_equal(
                    frag_bytes[:, s, :, lane, r],
                    u8[:, :, row, 32 * s + col:32 * s + col + 4])


def _tile_pass(tiles, x, out_size):
    """The kernels' pass on the tensor cores, emulated: x i64[..., in, C]
    (the pass runs along dim -2) -> u8[..., out, C]. Each m-tile reads its
    window of the input padded to the pitch; three limb products in int64,
    combined mod 2^32 as the kernels' uint32 arithmetic does."""
    in_size = x.shape[-2]
    pad = torch.zeros(x.shape[:-2] + (tiles.pitch - in_size, x.shape[-1]),
                      dtype=torch.int64)
    xp = torch.cat([x, pad], -2)
    window = tcuda.MMA_K * tiles.ksteps
    outs = []
    for m, k0 in enumerate(tiles.kstart):
        xw = xp[..., k0:k0 + window, :]
        s = [torch.einsum("ok,...kc->...oc",
                          torch.from_numpy(tiles.limbs[m, i]), xw)
             for i in range(3)]
        acc = ((1 << 21) + s[0] + (s[1] << 8) + (s[2] << 16)) & 0xFFFFFFFF
        acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)
        outs.append((acc >> 22).clamp(0, 255))
    return torch.cat(outs, -2)[..., :out_size, :].to(torch.uint8)


@pytest.mark.parametrize("k", [6, 8, 16])  # K + 1 = 7, 9, 17 slots
@pytest.mark.parametrize("h,w,aa", [(32, 32, 2), (64, 64, 5), (24, 40, 3),
                                    (10, 10, 2)])
def test_tile_products_equal_the_plain_passes(k, h, w, aa):
    """The emulated tile-wise h-pass and v-pass equal resample.lanczos_h /
    lanczos_v and hpass_plain / vpass_plain bit for bit on seeded canvases
    of every slot-count route of the kernels, and so does the whole
    render."""
    rng = np.random.default_rng(100 * k + aa)
    b = 3
    f = torch.from_numpy(_sprites(rng, (b, k)))
    n = torch.full((b,), k, dtype=torch.int32)
    hc, wc = h * aa, w * aa
    tables = tcuda.prepare(f, n, hc, wc, None)
    bg = (7, 200, 31)
    pix = tcuda._plain_pixels(tables, bg)  # i64[B, hc, wc, 3]
    # Slots: every live sprite, and the background, reach the canvas.
    assert len(torch.unique(pix.reshape(-1, 3), dim=0)) > k // 2

    hp = _tile_pass(tcuda.lanczos_tiles(wc, w), pix, w)  # u8[B, hc, w, 3]
    assert torch.equal(hp, tresample.lanczos_h(pix, w))
    assert torch.equal(hp, tcuda.hpass_plain(tables, w, bg))

    # The v-pass reads the h-pass transposed, as the kernels' buffer holds
    # it (canvas rows contiguous).
    img = _tile_pass(tcuda.lanczos_tiles(hc, h),
                     hp.to(torch.int64).transpose(-2, -3),
                     h).transpose(-2, -3)  # u8[B, h, w, 3]
    assert torch.equal(img, tresample.lanczos_v(hp, h))
    assert torch.equal(torch.flip(img, dims=(1,)), tcuda.vpass_plain(hp, h))
    assert torch.equal(torch.flip(img, dims=(1,)),
                       tcuda.render_rgb_batch_plain(tables, (h, w), bg))


def test_hpass_buffer_is_the_transposed_planar_layout():
    """strip_raster's h-pass: a view u8[B, hc, w, 3] of the buffer
    u8[B, 3, wp, hp] that the v-pass reads, output column x's canvas rows
    at bytes 0..hc-1 of row x."""
    hc, h, w = 96, 32, 40
    buf, view = tcuda.hpass_buffer(2, hc, h, w, "cpu")
    wp, hp = tcuda.hpass_geometry(hc, h, w)
    assert (wp, hp) == (48, tcuda.lanczos_tiles(hc, h).pitch)
    assert buf.shape == (2, 3, wp, hp) and view.shape == (2, hc, w, 3)
    assert view.stride() == (3 * wp * hp, 1, hp, wp * hp)
    assert view.data_ptr() == buf.data_ptr()
    vals = torch.arange(2 * hc * w * 3, dtype=torch.int64) % 251
    view.copy_(vals.reshape(2, hc, w, 3).to(torch.uint8))
    assert buf[1, 2, 5, 7] == view[1, 7, 5, 2]


def test_scene_layout_holds_a_band_of_the_canvas():
    """With the Lanczos filter the scene kernel fills and h-passes the
    canvas in bands of at most 80 rows: the layout grows with the canvas
    width, the h-pass buffer and the plan of its live units (a few words a
    group of 8 canvas rows), not with a band of the canvas height."""
    k, v = 6, 30
    tall = tcuda.scene_smem_bytes(k, v, 640, 320, 128, 64, tcuda.DS_LANCZOS)
    square = tcuda.scene_smem_bytes(k, v, 320, 320, 64, 64,
                                    tcuda.DS_LANCZOS)
    wp, hp_tall = tcuda.hpass_geometry(640, 128, 64)
    _, hp_square = tcuda.hpass_geometry(320, 64, 64)
    plans = (tcuda.plan_bytes(k, 640, 128, 64)
             - tcuda.plan_bytes(k, 320, 64, 64))
    assert tall - square == 3 * wp * (hp_tall - hp_square) + plans
    assert 0 < plans < 2048
