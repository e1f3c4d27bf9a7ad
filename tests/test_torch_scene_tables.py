"""The render's scene tables: the kernel `csrc/scene_tables.cu` against its
plain twin `rasterize_cuda.prepare_plain`.

On a CUDA tensor `rasterize_cuda.prepare` is one launch of the kernel,
which has no CPU mode: the `cuda` cases hold its table bit for bit
(`torch.equal`) against the twin's on the card, over every shape, angles,
scales, positions inside and outside the unit square, dead slots, 1 to 254
sprite slots, 1 and 2048 scenes, both fills and every colour route, and
the images that the scene, strip and packed kernels render from either
table. They skip without a card; on the card's machine run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_scene_tables.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine lacks).
The CPU cases check the colour routes, the launch counter and the
features' order the kernel's stable partition reproduces. Inputs come
from numpy seeds.
"""

import numpy as np
import pytest
import torch

from spriteworld_torch import constants
from spriteworld_torch.ops import rasterize
from spriteworld_torch.ops import rasterize_cuda as tcuda
from spriteworld_torch.utils import colors
from spriteworld_torch.utils import profiling

ANGLES = (0.0, 90.0, 45.0, -30.0)
ROUTES = {"none": None, "hsv": "hsv", "hsv_fn": colors.hsv_to_rgb,
          "given": lambda c: 255.0 * c.flip(-1) ** 2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the scene_tables kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def scenes(seed, b, k, colour_scale=1.0):
    """Factors f32[b, k, 10] and live counts i32[b]: every shape in turn,
    angles 0, 90, 45, -30 or uniform, scales 0.05-0.4, positions in
    [-0.25, 1.25]^2 (some on a grid of half canvas pixels), colours
    uniform in [0, colour_scale), counts 0..k with 0 and k present."""
    rng = np.random.default_rng(seed)
    f = np.zeros((b, k, 10), np.float32)
    n = b * k
    f[..., 0:2] = rng.uniform(-0.25, 1.25, (b, k, 2))
    grid = rng.random((b, k)) < 0.25
    f[grid, 0:2] = np.round(f[grid, 0:2] * 128) / 128
    f[..., 2] = (np.arange(n) % len(constants.VERTEX_COUNTS)).reshape(b, k)
    angles = np.array(ANGLES, np.float32)[np.arange(n) % 5 % 4]
    angles = np.where(np.arange(n) % 5 == 4,
                      rng.uniform(-360, 360, n), angles)
    f[..., 3] = angles.reshape(b, k)
    f[..., 4] = rng.uniform(0.05, 0.4, (b, k))
    f[..., 5:8] = rng.uniform(0, colour_scale, (b, k, 3))
    f[..., 8:10] = rng.normal(0, 0.01, (b, k, 2))
    live = rng.integers(0, k + 1, b).astype(np.int32)
    live[0] = k
    if b > 1:
        live[1] = 0
    return f, live


def on(device, f, live):
    return torch.from_numpy(f).to(device), torch.from_numpy(live).to(device)


# ---------------------------------------------------------------------- #
# CPU: the colour routes, the counter, the features' order.

@pytest.mark.parametrize("name,want", [
    ("none", "none"), ("hsv", "hsv"), ("hsv_fn", "hsv"),
    ("given", "given")])
def test_color_route_of_each_colour_map(name, want):
    assert tcuda.color_route(ROUTES[name]) == want
    assert tcuda.color_route(colors.identity_255) == "given"
    assert tcuda.tables_mode(True, ROUTES[name]) == f"exact+{want}"
    assert tcuda.tables_mode(False, ROUTES[name]) == f"centroid+{want}"


def test_color_route_refuses_other_strings():
    with pytest.raises(ValueError, match="color_to_rgb"):
        tcuda.color_route("rgb")


def test_plain_twin_takes_hsv_by_name():
    f, live = scenes(0, 4, 3)
    ft, nt = on("cpu", f, live)
    by_name = tcuda.prepare_plain(ft, nt, 64, 64, "hsv")
    by_fn = tcuda.prepare(ft, nt, 64, 64, colors.hsv_to_rgb)
    assert torch.equal(by_name.tab, by_fn.tab)


def test_cpu_factors_take_the_plain_twin_and_count_no_launch(monkeypatch):
    tcuda.reset_launch_counts()
    f, live = scenes(1, 3, 4)
    ft, nt = on("cpu", f, live)

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran on CPU factors")

    monkeypatch.setattr(tcuda, "scene_tables", refuse)
    tables = tcuda.prepare(ft, nt, 96, 96, None)
    assert tables.tab.shape == (3, 4, tcuda.table_width(30))
    monkeypatch.undo()
    assert tcuda.scene_tables.launches == 0
    assert tcuda.scene_tables.by_mode == {}
    with pytest.raises(ValueError, match="CUDA"):
        tcuda.scene_tables(ft, nt, 96, 96, None)


def test_launch_counter_counts_by_mode_and_batch_and_resets(monkeypatch):
    counted = []
    monkeypatch.setattr(profiling, "count",
                        lambda kernel, mode, blocks=0: counted.append(
                            (kernel, mode)))
    tcuda.reset_launch_counts()
    tcuda._count_launch(tcuda.scene_tables, "exact+hsv", 2048)
    tcuda._count_launch(tcuda.scene_tables, "exact+hsv", 1)
    tcuda._count_launch(tcuda.scene_tables, "centroid+given", 1)
    assert tcuda.scene_tables.launches == 3
    assert tcuda.scene_tables.by_mode == {"exact+hsv": 2,
                                          "centroid+given": 1}
    assert tcuda.scene_tables.by_batch == {2048: 1, 1: 2}
    assert counted == [("scene_tables", "exact+hsv")] * 2 + [
        ("scene_tables", "centroid+given")]
    tcuda.reset_launch_counts()
    assert (tcuda.scene_tables.launches, tcuda.scene_tables.by_mode,
            tcuda.scene_tables.by_batch) == (0, {}, {})


def test_bank_fits_a_warp_and_the_table_width():
    """The kernel holds vertex v in lane v: the bank's V fits 32 lanes."""
    v = constants.VERTEX_BANK.shape[1]
    assert v <= 32
    assert tcuda.table_width(v) == 8 + 11 * v == 338


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_features_are_active_edges_then_wedges_in_vertex_order(seed):
    """The order the kernel's ballot and popc prefix write: the active
    horizontal edges in vertex order, then the active wedges in vertex
    order, then zeros; dead slots have count 0 and no features."""
    f, live = scenes(seed, 6, 5)
    f[..., 4] = np.float32(0.08)  # small: truncation collides vertices
    ft, nt = on("cpu", f, live)
    hc = 64
    tables = tcuda.prepare_plain(ft, nt, hc, hc, None)
    verts = torch.trunc(rasterize._canvas_vertices(ft, hc, hc))
    x0, y0 = verts[..., 0], verts[..., 1]
    x1, y1 = torch.roll(x0, -1, -1), torch.roll(y0, -1, -1)
    feats = tables.features()
    vmax = x0.shape[-1]
    for b in range(6):
        for k in range(5):
            t = tables.tab[b, k]
            count = int(t[tcuda.T_COUNT])
            if k >= live[b]:
                assert count == 0 and int(t[tcuda.T_NF]) == 0
                assert not feats[b, k].any()
                continue
            valid = torch.arange(vmax) < count
            horiz = valid & (y0[b, k] == y1[b, k])
            wact, wlo, whi = rasterize.wedge_intervals(
                x0[b, k], y0[b, k], valid, torch.tensor(count),
                t[tcuda.T_GYMAX])
            want = [(y0[b, k, i], min(x0[b, k, i], x1[b, k, i]),
                     max(x0[b, k, i], x1[b, k, i]))
                    for i in range(vmax) if horiz[i]]
            want += [(y0[b, k, i], wlo[i], whi[i])
                     for i in range(vmax) if wact[i]]
            nf = int(t[tcuda.T_NF])
            assert nf == len(want)
            got = feats[b, k]
            if want:
                assert torch.equal(got[:nf], torch.tensor(
                    [[float(a) for a in w] for w in want]))
            assert not got[nf:].any()


# ---------------------------------------------------------------------- #
# The card: the kernel against the twin.

# (scenes, slots, canvas): one scene and one slot (a single env's first
# sprite), the rollout cells' 2048 scenes of 2, and wide scenes.
SIZES = ((1, 1, 64), (1, 2, 320), (2048, 2, 320), (64, 16, 64),
         (4, 254, 320), (3, 13, 1280))


def assert_tables_equal(got, want):
    assert got.tab.shape == want.tab.shape
    assert got.num_vertices == want.num_vertices
    assert (got.hc, got.wc, got.pil_exact) == (want.hc, want.wc,
                                                want.pil_exact)
    want_tab = want.tab.to(got.tab.device)
    bad = got.tab != want_tab
    assert not bad.any(), (
        f"{int(bad.sum())} values differ, first at "
        f"{tuple(bad.nonzero()[0].tolist())}")
    assert torch.equal(got.tab, want_tab)


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("pil_exact", [True, False])
@pytest.mark.parametrize("b,k,canvas", SIZES)
def test_kernel_tables_equal_the_plain_twin(card, b, k, canvas, pil_exact,
                                            route):
    scale = 300.0 if route == "none" else 1.1
    f, live = scenes(b * 1000 + k, b, k, scale)
    ft, nt = on(card, f, live)
    cmap = ROUTES[route]
    before = tcuda.scene_tables.launches
    got = tcuda.prepare(ft, nt, canvas, canvas, cmap, pil_exact)
    torch.cuda.synchronize()
    assert tcuda.scene_tables.launches == before + 1
    assert_tables_equal(got, tcuda.prepare_plain(ft, nt, canvas, canvas,
                                                 cmap, pil_exact))
    # The CPU twin: the same table but where float64 sine or cosine round
    # across a float32 tie (one in ~10^8), which none of these do.
    assert_tables_equal(got, tcuda.prepare_plain(
        *on("cpu", f, live), canvas, canvas, cmap, pil_exact))


@pytest.mark.cuda
@pytest.mark.parametrize("angle", ANGLES + (None,))
@pytest.mark.parametrize("scale", [0.05, 0.1, 0.4])
def test_kernel_tables_equal_the_plain_twin_at_each_shape(card, angle,
                                                          scale):
    """Every shape at one angle (None: random) and scale, at the canvas
    positions where truncation and Pillow's wedges bite: integers, halves
    and off the canvas."""
    shapes = len(constants.VERTEX_COUNTS)
    rng = np.random.default_rng(int(scale * 100) + 7)
    f = np.zeros((shapes, 4, 10), np.float32)
    f[..., 2] = np.arange(shapes)[:, None]
    f[..., 3] = rng.uniform(-180, 180, (shapes, 4)) if angle is None \
        else angle
    f[..., 4] = scale
    f[:, 0, 0:2] = 0.5
    f[:, 1, 0:2] = np.array([17.5, 40.0]) / 64
    f[:, 2, 0:2] = np.array([-0.1, 1.05])
    f[:, 3, 0:2] = rng.uniform(0, 1, (shapes, 2))
    f[..., 5:8] = rng.uniform(0, 1, (shapes, 4, 3))
    live = np.full(shapes, 4, np.int32)
    ft, nt = on(card, f, live)
    for canvas in (64, 320):
        for pil_exact in (True, False):
            assert_tables_equal(
                tcuda.prepare(ft, nt, canvas, canvas, "hsv", pil_exact),
                tcuda.prepare_plain(ft, nt, canvas, canvas, "hsv",
                                    pil_exact))


@pytest.mark.cuda
def test_kernel_takes_strided_factors_and_int64_counts(card):
    f, live = scenes(5, 8, 6)
    ft, nt = on(card, f, live)
    wide = torch.zeros((8, 12, 10), device=card)
    wide[:, ::2] = ft
    view = wide[:, ::2]
    assert not view.is_contiguous()
    got = tcuda.prepare(view, nt.to(torch.int64), 320, 320, "hsv")
    assert_tables_equal(got, tcuda.prepare_plain(ft, nt, 320, 320, "hsv"))


@pytest.mark.cuda
def test_cuda_path_never_calls_the_plain_twin(card, monkeypatch):
    from spriteworld_torch.core import renderers

    def refuse(*args, **kwargs):
        raise AssertionError("the plain twin ran on CUDA factors")

    f, live = scenes(6, 16, 4)
    ft, nt = on(card, f, live)
    monkeypatch.setattr(tcuda, "prepare_plain", refuse)
    for aa, exact in ((5, True), (1, True), (1, False), (5, False)):
        renderers.ImageRenderer((64, 64), anti_aliasing=aa,
                                color_to_rgb="hsv",
                                pil_exact=exact).render_batch(ft, nt, None)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_inputs_the_kernel_cannot_take_raise(card):
    f, live = scenes(7, 2, 3)
    ft, nt = on(card, f, live)
    with pytest.raises(ValueError, match="f32"):
        tcuda.prepare(ft.double(), nt, 64, 64, None)
    with pytest.raises(ValueError, match="f32"):
        tcuda.prepare(ft[..., :9], nt, 64, 64, None)
    with pytest.raises(ValueError, match="num_sprites"):
        tcuda.prepare(ft, nt[:1], 64, 64, None)
    with pytest.raises(ValueError, match="num_sprites"):
        tcuda.prepare(ft, nt.cpu(), 64, 64, None)


@pytest.mark.cuda
def test_empty_batches_launch_nothing(card):
    before = tcuda.scene_tables.launches
    for b, k in ((0, 3), (2, 0)):
        f = torch.zeros((b, k, 10), device=card)
        got = tcuda.prepare(f, torch.zeros(b, dtype=torch.int32,
                                           device=card), 64, 64, None)
        assert got.tab.shape == (b, k, tcuda.table_width(30))
    assert tcuda.scene_tables.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["scene", "strips", "packed"])
@pytest.mark.parametrize("pil_exact", [True, False])
def test_images_equal_from_either_table(card, path, pil_exact):
    """The scene, strip and packed kernels render the kernel's tables as
    they render the twin's."""
    aa = 1 if path == "packed" else 5
    f, live = scenes(8, 64, 6)
    ft, nt = on(card, f, live)
    size = (64, 64)
    kernel = tcuda.prepare(ft, nt, 64 * aa, 64 * aa, "hsv", pil_exact)
    plain = tcuda.prepare_plain(ft, nt, 64 * aa, 64 * aa, "hsv", pil_exact)
    render = {"scene": tcuda.scene_raster, "strips": tcuda.render_strips,
              "packed": tcuda.packed_raster}[path]
    got = render(kernel, size)
    assert torch.equal(got, render(plain, size))
    assert torch.equal(got.cpu(), tcuda.render_rgb_batch_plain(
        tcuda.prepare_plain(*on("cpu", f, live), 64 * aa, 64 * aa, "hsv",
                            pil_exact), size))


@pytest.mark.cuda
def test_a_captured_render_counts_one_table_launch_in_its_census(card):
    """In a CUDA graph the tables are one node, counted once in the
    capture's census; a replay writes what an eager launch writes."""
    f, live = scenes(9, 32, 2)
    ft, nt = on(card, f, live)
    tcuda.prepare(ft, nt, 320, 320, "hsv")  # loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with profiling.capture("scene_tables_test") as rec:
            out = tcuda.prepare(ft, nt, 320, 320, "hsv")
    census = rec.census_table()
    assert census["scene_tables"] == {"exact+hsv": {"launches": 1,
                                                    "blocks": 0}}
    if rec.nodes is not None:
        names = [fn for kind, _, fn in rec.nodes if kind == "kernel"]
        assert len(names) == 1 and "scene_tables" in (names[0] or "")
    out.tab.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert_tables_equal(out, tcuda.prepare_plain(ft, nt, 320, 320, "hsv"))
