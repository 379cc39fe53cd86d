"""The control and the planted faults come out not correct; the program
comes out correct. The harness runs on the CPU here (its look for a
card skipped), at the 64x64 test configuration and at the 1080i cell's
own size."""

import os

import pytest
import torch

from avbench import control, reference, spec
from avbench.harness import read_packets
from conftest import ROOT, TEST_CELLS

CPU = torch.device("cpu")


def runs(bench, cell, mode, cells_dir=TEST_CELLS):
    return control.runs(cell, [2 ** 32 + 11], mode, 0.01, device=CPU,
                        bench=bench, cells_dir=cells_dir)[0][1]


@pytest.mark.parametrize("mode", control.MODES)
def test_h264_modes(test_bench, mode):
    r = runs(test_bench, "h264_test_64x64.chunked", mode)
    assert r["correct"] == (mode == "none"), r["checks"]
    if mode in ("control", "unchanged", "altered"):
        assert r["checks"]["frames_off"]["value"] > 0
    if mode == "half":
        assert r["checks"]["frames_missing"]["value"] > 0


@pytest.mark.parametrize("mode", control.MODES)
def test_mpeg2_modes_at_the_cell_size(mode):
    r = runs(None, "mpeg2_mp_1080i.broadcast_fields", mode, None)
    assert r["correct"] == (mode == "none"), r["checks"]


def test_float_idct_differs_from_the_exact_one():
    from libav_tpu_torch.ops.idct import idct8x8_int_plain
    g = torch.Generator().manual_seed(5)
    x = torch.randint(-300, 300, (256, 8, 8), generator=g,
                      dtype=torch.int32)
    x[:, 4:, :] = 0
    exact = idct8x8_int_plain(x)
    approx = control.float_idct8x8(x)
    d = (exact - approx).abs()
    assert 0 < int(d.max()) <= 2


def test_h264_control_skips_the_filter_on_b_pictures_only(test_bench):
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs import find_decoder
    gop = read_packets(os.path.join(
        ROOT, "avbench", "streams", "h264_64x64_bench.h264pkts"))
    want = spec.config(test_bench, "h264_test_64x64")["streams"][0][
        "frame_md5"]

    def md5s():
        dec = find_decoder("h264")(device=CPU)
        try:
            fr = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(gop))
        finally:
            dec.close()
        return [reference.md5(f.to_host().planes) for f in fr]
    assert md5s() == want
    with control.broken("h264"):
        got = md5s()
    # output order I B B P: the B pictures are the non-reference ones
    assert [g != w for g, w in zip(got, want)] == [False, True, True, False]
