"""The trace reduction on synthetic Chrome-trace events: units that lost
hand-kernel launches are left out, the kernel timer's own flush is not
busy time, idle stretches are named by the host spans over them."""

import pytest
import torch

from avbench.spans import Spans
from avbench.trace import DeviceTrace


def ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def trace_with_span(records):
    spans = Spans()
    span = spans.patch("entropy", "avbench.stats:mean_ms")
    spans.restore()
    for r in records:
        span.add(*r)
    return DeviceTrace(torch.device("cpu"), spans,
                       [("deblock_frame_kernel", lambda: 0)])


def test_kept_unit_busy_idle_and_kernel_time():
    # host: the unit runs from t=10 s to t=10.01 s; the trace's clock has
    # the marker at 5,000 us, so trace us = host us - 9,995,000
    t = trace_with_span([(10.002, 10.006, None)])
    events = [ev("stale from before the unit", 100, 50),
              ev("FillFunctor<double> marker", 5000, 1),
              ev("deblock_frame_kernel", 5100, 1000),
              ev("FillFunctor<int> flush", 6200, 40),    # the timer's flush
              ev("spin_kernel", 6240, 5),
              ev("deblock_frame_kernel", 6300, 1000),
              ev("Memcpy HtoD", 14000, 500, "gpu_memcpy")]
    assert t._add(events, [2], 10.0, 10.01)
    assert t.kept == 1 and t.dropped == 0
    assert t.window_s == pytest.approx(0.01)
    assert t.busy_s == pytest.approx((1 + 1000 + 1000 + 500) / 1e6)
    assert t.kernel_s["deblock_frame_kernel"] == pytest.approx(0.002)
    idle = dict(t.breakdown()["idle_gaps"])
    # 7,300..14,000 us is idle under the entropy span (host 10.0023 ..
    # 10.009 overlaps it at its middle); 6,100..6,300 (where the timer's
    # flush ran) and 14,500..15,000 lie outside it; 5,001..5,100 is a
    # launch gap
    assert idle["entropy"] == pytest.approx(0.0067)
    assert idle["outside the spans"] == pytest.approx(0.0007)
    assert idle["launch gaps under 0.1 ms"] == pytest.approx(0.000099)
    ops = dict(t.breakdown()["device_ops"])
    assert "spin_kernel" not in ops and "FillFunctor<int> flush" not in ops


def test_unit_that_lost_launches_is_left_out():
    t = trace_with_span([])
    events = [ev("FillFunctor<double>", 0, 1),
              ev("deblock_frame_kernel", 10, 5)]
    assert not t._add(events, [2], 0.0, 0.001)
    assert not t._add([ev("deblock_frame_kernel", 10, 5)], [1], 0.0, 0.001)
    assert t.kept == 0 and t.dropped == 2
    assert "deblock_frame_kernel: 1 of 2" in t.shortfall[0]
    assert "no marker" in t.shortfall[1]
