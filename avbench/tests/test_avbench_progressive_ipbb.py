"""The per-layer metrics of the MPEG-2 frame path (`mpeg2.b_recon_ms`,
`mpeg2.anchor_recon_ms`): only the cell `mpeg2_mp_1080p.progressive_ipbb`
lists them, and on a traced CPU run of a 64x64 I B B P B B P stream (the
configuration's fade GOP at 64x64, with its JAX md5s, under
`avbench/tests/data/`) each reads a number, as do the MPEG-2 and shared
metrics the cell also lists. A port without the recorder reads nothing."""

import time

import pytest
import torch

from avbench import harness, recorder, spec
from conftest import TEST_CELLS

CELL = "mpeg2_mp_1080p.progressive_ipbb"
TEST_CELL = "mpeg2_test_64x64.chunked"
NEW = ["mpeg2.b_recon_ms", "mpeg2.anchor_recon_ms"]
# the cell's other per-layer metrics that read the port on the CPU (the
# roofline and idle share need the card's profiler)
SHARED = ["mpeg2.entropy_ms", "mpeg2.native_slice_share", "mpeg2.recon_ms",
          "upload_ms"]


def test_only_the_new_cell_lists_them():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"] == [CELL]
    assert per_layer["mpeg2.b_recon_ms"]["moves"] == "decode_fps"
    assert per_layer["mpeg2.anchor_recon_ms"]["moves"] == "first_frame_ms"


@pytest.fixture(scope="module")
def traced():
    """One traced CPU run of the 64x64 test cell, asked for the metrics
    that the new cell lists; -> (result, the port's records over the
    window)."""
    from libav_tpu_torch.avutil import timer
    bench = spec.benchmark()
    bench = dict(bench, configs=bench["configs"] + [
        {"name": "mpeg2_test_64x64", "source": "tests",
         "file": "avbench/tests/data/mpeg2_test_64x64.json", "reduced": [],
         "why": "tests"}], workloads=bench["workloads"] + [
        {"name": TEST_CELL, "config": "mpeg2_test_64x64",
         "traffic": "chunked", "chips": 1, "why": "tests"}])
    bench["per_layer"] = [dict(m, workloads=[TEST_CELL])
                          for m in bench["per_layer"]
                          if m["name"] in NEW + SHARED]
    timer.disable()
    timer.reset()
    try:
        out = harness.run_cell(TEST_CELL, 2 ** 32 + 11, 0.01, True,
                               t0=time.perf_counter(),
                               device=torch.device("cpu"), bench=bench,
                               cells_dir=TEST_CELLS)
        return out, timer.records()
    finally:
        timer.disable()
        timer.reset()


@pytest.mark.parametrize("metric", NEW + SHARED)
def test_each_metric_reads_a_number(traced, metric):
    out = traced[0]
    assert out["correct"], out["checks"]
    assert out["metrics"][metric]["value"] > 0


def test_b_and_anchor_spans_split_the_frame_pictures(traced):
    """Each GOP is 7 frame pictures: 4 B, and 3 anchors (I, P, P), each
    span inside its picture's `mpeg2.recon`."""
    out, records = traced
    gops = out["checks"]["frames_compared"]["value"] // 7
    assert gops >= 1
    names = [r[0] for r in records]
    b = names.count("mpeg2.recon.b")
    anchor = names.count("mpeg2.recon.anchor")
    assert b == 4 * gops and anchor == 3 * gops
    assert names.count("mpeg2.recon") == b + anchor
    assert [r[5]["type"] for r in records
            if r[0] == "mpeg2.recon.anchor"] == ["I", "P", "P"] * gops
    assert all(r[1] == "mpeg2.recon" for r in records
               if r[0] in ("mpeg2.recon.b", "mpeg2.recon.anchor"))
    counted = {name: sum(r[5]["n"] for r in records if r[0] == name)
               for name in ("mpeg2.mb.b", "mpeg2.mb.bipred")}
    assert counted["mpeg2.mb.b"] == 4 * 16 * gops        # 4x4 MBs a picture
    assert 0 <= counted["mpeg2.mb.bipred"] <= counted["mpeg2.mb.b"]


def test_a_port_without_the_recorder_reads_nothing(monkeypatch):
    class Run:
        delivered = []
    from libav_tpu_torch.avutil import timer
    monkeypatch.delattr(timer, "enable")
    run = Run()
    for metric in NEW:
        reader = spec.reader(metric)
        reader.install(run)
        assert not hasattr(run, "recorder0")
        assert reader.read(run) is None
    assert recorder.counter(run, "mpeg2.mb.b") is None
