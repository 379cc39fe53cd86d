"""The metric arithmetic on synthetic numbers."""

import pytest

from avbench import roofline, stats


def test_whole_gop_rate_and_mean_first_frame_with_a_stalled_gop():
    # window opens at t=10; four GOPs of 8 frames end at these times; the
    # third GOP stalled (its first frame took 9 s, not 1 s)
    ends = [(12.0, 8), (14.0, 8), (23.0, 8), (25.0, 8)]
    assert stats.whole_unit_rate(ends, 10.0) == pytest.approx(32 / 15)
    first = [1.0, 1.0, 9.0, 1.0]
    assert stats.mean_ms(first) == pytest.approx(3000.0)
    # the stall moves the mean, where a median would hide it
    assert stats.mean_ms(first) > 1e3 * sorted(first)[1]


def test_rate_counts_whole_units_only():
    with pytest.raises(ValueError):
        stats.whole_unit_rate([], 0.0)
    with pytest.raises(ValueError):
        stats.whole_unit_rate([(1.0, 8)], 1.0)


def test_idle_share_from_device_intervals():
    # overlapping kernels and a copy in a 10 ms window
    iv = [(0.0, 1.0), (0.5, 2.0), (4.0, 5.0), (9.5, 12.0), (-3.0, -1.0)]
    assert stats.union(iv) == [(-3.0, -1.0), (0.0, 2.0), (4.0, 5.0),
                               (9.5, 12.0)]
    busy = stats.busy(iv, 0.0, 10.0)
    assert busy == pytest.approx(3.5)
    assert stats.idle_share(busy, 10.0) == pytest.approx(65.0)
    assert stats.gaps(iv, 0.0, 10.0) == [(2.0, 4.0), (5.0, 9.5)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    with pytest.raises(ValueError):
        stats.idle_share(1.0, 0.0)


@pytest.mark.parametrize("kernel, nbytes, ms, share", [
    # K1 on one 1080p frame: 29,438,336 B are 8.788 us at 3.35 TB/s
    ("k1", roofline.k1_bytes(120, 68), 1.1148, 0.78824),
    # K2 at 48,960 blocks: 25,067,520 B, 7.483 us
    ("k2", roofline.k2_bytes(48960), 0.0116, 64.5077),
])
def test_roofline_share(kernel, nbytes, ms, share):
    assert {"k1": 29438336, "k2": 25067520}[kernel] == nbytes
    got = stats.roofline_share(nbytes, ms, roofline.hbm_bytes_per_ms())
    assert got == pytest.approx(share, rel=1e-4)


def test_k2_bytes_at_the_field_picture():
    assert roofline.k2_bytes(24480) == 24480 * 512 == 12533760


def test_top_keeps_the_largest():
    got = stats.top({str(i): float(i) for i in range(20)}, 3)
    assert got == [["19", 19.0], ["18", 18.0], ["17", 17.0]]
