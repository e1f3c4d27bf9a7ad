"""Port parity, row-strip rasterizer: the plain version that both kernels
are held against, the dispatch between them, and the build cache.

The JAX strip kernel runs as the JAX package's tests run it on the CPU (in
interpret mode). Pillow is the independent reference where JAX on the CPU
legitimately differs from it (XLA contracts the crossing into an FMA).
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spriteworld_tpu.ops import rasterize_pallas as jpallas

from spriteworld_torch import constants as tconstants
from spriteworld_torch.core import renderers as trenderers
from spriteworld_torch.core import state as tstate
from spriteworld_torch.ops import _build
from spriteworld_torch.ops import geometry as tgeometry
from spriteworld_torch.ops import rasterize as trasterize
from spriteworld_torch.ops import rasterize_cuda as tcuda
from spriteworld_torch.utils import colors as tcolors

import bench_torch
from test_torch_rasterize import _pillow_scene, _sprites

H100_SMEM_PER_BLOCK = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin


def _pillow_batch(f, n, h, w, aa, color_to_rgb=None):
    """Pillow's draw + resize(LANCZOS) + flip of every scene."""
    verts = (tgeometry.world_vertices(torch.from_numpy(f))
             * torch.tensor([w * aa, h * aa], dtype=torch.float32)).numpy()
    counts = tconstants.VERTEX_COUNTS[f[..., tstate.SHAPE].astype(int)]
    colors = trasterize.sprite_colors(torch.from_numpy(f),
                                      color_to_rgb).numpy().astype(np.uint8)
    return np.stack([
        _pillow_scene(verts[i], counts[i], colors[i], n[i], h * aa, w * aa,
                      h, w) for i in range(len(f))])


@functools.lru_cache(maxsize=None)
def _jax_strips(size, aa, strip_limit):
    return functools.partial(
        jpallas.render_rgb_batch, image_size=(size, size), anti_aliasing=aa,
        interpret=True, kernel_mode="strips", strip_limit=strip_limit)


@pytest.mark.parametrize("size,aa,strip_limit", [(32, 5, 4000),
                                                 (24, 3, 1000)])
def test_strip_plain_matches_pallas_strips_and_pillow(size, aa, strip_limit):
    """The plain version against the JAX strip kernel with several strips
    (strip_limit forces 8-row strips) within +-1 (the JAX Lanczos sums in
    float32), and against Pillow exactly."""
    assert jpallas._pick_strip(size, aa, size * aa, strip_limit) < size
    rng = np.random.default_rng(size + aa)
    f = _sprites(rng, (6, 3))
    n = np.array([3, 2, 1, 3, 3, 0], np.int32)
    want = np.asarray(_jax_strips(size, aa, strip_limit)(
        jnp.asarray(f), jnp.asarray(n))).astype(int)
    got = tcuda.render_rgb_batch(
        torch.from_numpy(f), torch.from_numpy(n), image_size=(size, size),
        anti_aliasing=aa, kernel_mode="strips").numpy()
    assert np.abs(got.astype(int) - want).max() <= 1
    np.testing.assert_array_equal(got, _pillow_batch(f, n, size, size, aa))


def test_demo_scenes_bitexact_vs_pillow():
    """Two scenes of the demo's clustering config at 256x256/AA=10 (the
    2560x2560 canvas the strip kernels take) equal Pillow's draw +
    resize(LANCZOS) + flip."""
    env = bench_torch.build_demo_env(device="cpu", seed=1)
    state = env.initial_state(2)
    f, n = state.factors, state.num_sprites
    got = tcuda.render_rgb_batch(f, n, image_size=(256, 256),
                                 anti_aliasing=10,
                                 color_to_rgb=tcolors.hsv_to_rgb).numpy()
    want = _pillow_batch(f.numpy(), n.numpy(), 256, 256, 10,
                         tcolors.hsv_to_rgb)
    np.testing.assert_array_equal(got, want)
    assert (got.reshape(2, -1, 3).max(1) > 0).all()


@pytest.mark.parametrize("aa", [1, 3])
def test_plain_results_do_not_depend_on_chunk_size(aa):
    rng = np.random.default_rng(60 + aa)
    f = torch.from_numpy(_sprites(rng, (5, 4), hsv=True))
    n = torch.tensor([4, 3, 0, 1, 4], dtype=torch.int32)
    h, w = 24, 40
    tables = tcuda.prepare(f, n, h * aa, w * aa, tcolors.hsv_to_rgb)
    whole = tcuda.render_rgb_batch_plain(tables, (h, w), (1, 2, 3))
    for max_pixels in (1, 2 * h * w * aa * aa, 10 ** 9):
        np.testing.assert_array_equal(
            tcuda.render_rgb_batch_plain(tables, (h, w), (1, 2, 3),
                                         max_pixels=max_pixels).numpy(),
            whole.numpy())
    if aa > 1:
        # The plain render is the plain v-pass of the plain h-pass.
        hp = tcuda.hpass_plain(tables, w, (1, 2, 3), max_pixels=1)
        assert hp.shape == (5, h * aa, w, 3) and hp.dtype == torch.uint8
        np.testing.assert_array_equal(
            hp.numpy(), tcuda.hpass_plain(tables, w, (1, 2, 3)).numpy())
        np.testing.assert_array_equal(tcuda.vpass_plain(hp, h).numpy(),
                                      whole.numpy())


def test_dispatch_picks_strips_exactly_when_the_scene_layout_overflows():
    budget = 100_000
    for scene_bytes in (1, budget - 1, budget):
        assert tcuda.resolve_kernel_mode("auto", scene_bytes,
                                         budget) == "scene"
        assert tcuda.resolve_kernel_mode("scene", scene_bytes,
                                         budget) == "scene"
    for scene_bytes in (budget + 1, 10 * budget):
        assert tcuda.resolve_kernel_mode("auto", scene_bytes,
                                         budget) == "strips"
        with pytest.raises(ValueError, match="kernel_mode='scene'"):
            tcuda.resolve_kernel_mode("scene", scene_bytes, budget)
    for scene_bytes in (1, 10 * budget):
        assert tcuda.resolve_kernel_mode("strips", scene_bytes,
                                         budget) == "strips"
    with pytest.raises(ValueError, match="Unknown kernel_mode"):
        tcuda.resolve_kernel_mode("tiles", 1, budget)
    with pytest.raises(ValueError, match="Unknown kernel_mode"):
        trenderers.ImageRenderer(kernel_mode="tiles")


@pytest.mark.parametrize("size,aa,k,fits", [
    (64, 5, 6, True),  # the image64 main path
    (64, 1, 6, True),
    (64, 6, 6, True),  # the Lanczos canvas is held in bands of rows
    (128, 5, 4, False),
    (256, 10, 4, False),  # the demo
    (1024, 1, 8, False),
])
def test_scene_layout_against_the_h100_budget(size, aa, k, fits):
    """Which canvases the scene kernel holds on an H100, and that a strip
    of the default height fits every one of them."""
    hc = size * aa
    scene = tcuda.scene_smem_bytes(k, 30, hc, hc, size, size,
                                   tcuda.downsample_mode(aa, True, "auto"))
    assert (scene <= H100_SMEM_PER_BLOCK) == fits
    mode = tcuda.resolve_kernel_mode("auto", scene, H100_SMEM_PER_BLOCK)
    assert mode == ("scene" if fits else "strips")
    rows = tcuda.default_strip_rows(hc, hc)
    assert 1 <= rows <= hc
    assert tcuda.strip_smem_bytes(k, rows, hc) <= H100_SMEM_PER_BLOCK // 3
    assert tcuda.strip_smem_bytes(254, 1, 200_000) <= H100_SMEM_PER_BLOCK


def test_strip_wrappers_refuse_cpu_tensors():
    f = torch.from_numpy(_sprites(np.random.default_rng(0), (1, 2)))
    n = torch.tensor([2], dtype=torch.int32)
    tables = tcuda.prepare(f, n, 96, 96, None)
    counts = (tcuda.strip_raster.launches, tcuda.strip_vpass.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tcuda.strip_raster(tables, (32, 32))
    with pytest.raises(ValueError, match="CUDA"):
        tcuda.strip_vpass(torch.zeros((1, 96, 32, 3), dtype=torch.uint8), 32)
    assert (tcuda.strip_raster.launches,
            tcuda.strip_vpass.launches) == counts
    # A CPU batch takes the plain version whatever the mode.
    for mode in ("auto", "scene", "strips"):
        out = trenderers.ImageRenderer((32, 32), anti_aliasing=3,
                                       kernel_mode=mode).render_batch(
                                           f, n, None)
        np.testing.assert_array_equal(
            out.numpy(), tcuda.render_rgb_batch_plain(tables, (32, 32)))


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """An edited header builds every kernel anew."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    assert set(_build.KERNELS) == {"scene_raster", "strip_raster",
                                   "packed_raster", "lane_random",
                                   "scene_tables", "task_eval"}
    header = csrc / "raster_fill.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    for name in _build.KERNELS:
        assert before[name] != after[name]
        assert after[name].name.startswith(f"lib{name}-")
