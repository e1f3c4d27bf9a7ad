"""The roofline counts against bytes and operations worked by hand, and the
shares they give."""

import pytest

from perfbench import harness
from perfbench.devtrace import Op, Trace


@pytest.fixture
def layout():
    return harness.Layout()


def test_lanczos_taps_by_hand(layout):
    r = layout.roofline("scene_raster")
    # 10 -> 2: scale 5, support 15; both outputs' windows clip to [0, 10).
    assert r.lanczos_taps(10, 2) == 20
    # 20 -> 4: scale 5, support 15. Centres 2.5, 7.5, 12.5, 17.5: windows
    # [0, 18), [0, 20), [0, 20), [3, 20) -> 18 + 20 + 20 + 17.
    assert r.lanczos_taps(20, 4) == 75
    # No downscale: scale 1, support 3: centre xx + 0.5, window
    # [int(xx - 2), int(xx + 4)) clipped to [0, 4).
    assert r.lanczos_taps(4, 4) == 4 + 4 + 4 + 3


def test_scene_raster_work_by_hand(layout):
    r = layout.roofline("scene_raster")
    # 2 lanes, 2 sprites, 2x2 images at anti_aliasing 5 (10x10 canvas):
    # bytes = 2 * (2 * 10 * 4 + 2 * 2 * 3) = 184; multiply-adds a lane =
    # 3 * (10 rows * 20 taps + 2 columns * 20 taps) = 720; ops = 2 * 2 *
    # 720.
    assert r.work(2, (2, 2), 5, 2) == (184, 2880)
    assert r.least_seconds(2, (2, 2), 5, 2) == pytest.approx(
        max(184 / 3.35e12, 2880 / 1979e12))
    # The cell's size: bytes bound, 7.6 us.
    bytes_, ops = r.work(2048, (64, 64), 5, 2)
    assert bytes_ == 2048 * (80 + 12288)
    assert r.least_seconds(2048, (64, 64), 5, 2) == pytest.approx(
        bytes_ / 3.35e12)


def test_lane_random_least_by_hand(layout):
    r = layout.roofline("lane_random")
    assert r.least_seconds(1000, 2) == pytest.approx(
        max(1000 * 72 / 67e12, 2 * 32 / 3.35e12))
    assert r.least_seconds(0, 2048) == pytest.approx(2048 * 32 / 3.35e12)


def _ctx(layout, ops, steps, lanes, tally=None):
    from perfbench import check

    spans = [("rollout", 0, 10**9), ("sync", 10**9, 10**9 + 1)]
    trace = Trace([Op(n, s, e, "kernel", 0, "cudaGraphLaunch")
                   for n, s, e in ops], spans, [], {})
    config = layout.config("cobra.goal_finding_new_position")
    return harness.Context(trace=trace, steps=steps, calls=1, lanes=lanes,
                           config=config, tally=tally or check.Tally(),
                           host_step_ms=[], layout=layout)


def test_shares_read_100_at_the_least_time(layout):
    least = layout.roofline("scene_raster").least_seconds(
        2048, (64, 64), 5, 2)
    ns = least * 1e9
    ctx = _ctx(layout, [("scene_raster_kernel<true>", 0, ns),
                        ("scene_raster_kernel<true>", 10**6, 10**6 + ns)],
               2, 2048)
    share = layout.reader("scene_raster_roofline").read(ctx)
    assert share == pytest.approx(100.0, rel=1e-6)
    # Twice the least time reads 50%; no kernel reads nothing.
    ctx.trace.ops[0].end = 2 * ns
    ctx.trace.ops[1].end = 10**6 + 2 * ns
    assert layout.reader("scene_raster_roofline").read(ctx) == \
        pytest.approx(50.0, rel=1e-6)
    assert layout.reader("scene_raster_roofline").read(
        _ctx(layout, [("other", 0, 5)], 1, 2048)) is None


def test_lane_random_share_from_the_reference_blocks(layout):
    from perfbench import check

    tally = check.Tally(blocks=600, lane_steps=100)
    blocks = 600 / 100 * 2048 + 2
    least = layout.roofline("lane_random").least_seconds(blocks, 2048)
    ctx = _ctx(layout, [("lane_random_kernel", 0, 2 * least * 1e9)], 1,
               2048, tally)
    assert layout.reader("lane_random_roofline").read(ctx) == \
        pytest.approx(50.0, rel=1e-6)
