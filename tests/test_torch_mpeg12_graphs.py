"""The MPEG-1/2 recon programs replayed from CUDA graphs
(`codecs/cudagraph.py`, `mpegvideo.recon_graphed`,
`recon_field_graphed`) against the same programs run eagerly.

Every program key the decoder reaches (frame I, P and B pictures with
bi-predicted MBs, MPEG-1, interlaced frame pictures with and without dual
prime, field I and P pictures with and without dual prime, the alternate
scan) runs on seeded random inputs, twice with different inputs: the
runner's outputs must equal the eager module's byte for byte, and the
first call's outputs must survive the second call's replay. Off the card
the runner is the eager module and counts `mpeg2.recon.eager`. The
benchmark's MPEG-2 control (a float IDCT set over `mpegvideo.idct8x8_int`)
reaches the runner on either path, also for a program captured before.

On the card (marked `cuda`; this file imports no JAX, so it runs there
without the suite's conftest: `python -m pytest --noconftest
tests/test_torch_mpeg12_graphs.py -q`) the same, and the frozen benchmark
streams decode to their configurations' frame md5s with their GOPs
interleaved on reused programs, K2 launching once per picture; two
GOP-parallel workers on one card give the same md5s.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from libav_tpu_torch import testdata
from libav_tpu_torch.avutil import hwdevice, timer
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs import find_decoder, mpegvideo
from libav_tpu_torch.ops import idct as tidct
from libav_tpu_torch.ops.mc import EDGE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB_W, MB_H = 5, 4

# key -> (factory, key arguments, flags); field keys take MB_H // 2 rows
KEYS = {
    "frame_i": (mpegvideo.recon, ("mpeg2", False, False), {}),
    "frame_p": (mpegvideo.recon, ("mpeg2", False, True), {}),
    "frame_b": (mpegvideo.recon, ("mpeg2", True, True), {}),
    "mpeg1_b": (mpegvideo.recon, ("mpeg1", False, True), {}),
    "frame_interlaced": (mpegvideo.recon, ("mpeg2", False, True),
                         {"interlaced": True}),
    "frame_dual": (mpegvideo.recon, ("mpeg2", False, True),
                   {"interlaced": True, "dual": True}),
    "field_i": (mpegvideo.recon_field, (False, False), {}),
    "field_p": (mpegvideo.recon_field, (True, True), {}),
    "field_dual": (mpegvideo.recon_field, (False, True), {"dual": True}),
}

_needs_cuda = [pytest.mark.cuda,
               pytest.mark.skipif("not torch.cuda.is_available()",
                                  reason="needs a CUDA device")]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _program(key, device):
    factory, args, flags = KEYS[key]
    if factory is mpegvideo.recon_field:
        return factory(MB_W, MB_H // 2, *args, device=device, **flags)
    return factory(MB_W, MB_H, *args, device=device, **flags)


def _graphed(key, device):
    """(the key's program, the decoder's graphed run of it)"""
    factory, args, flags = KEYS[key]
    graphed = {mpegvideo.recon: mpegvideo.recon_graphed,
               mpegvideo.recon_field: mpegvideo.recon_field_graphed}[factory]
    mb_h = MB_H // 2 if factory is mpegvideo.recon_field else MB_H
    return (_program(key, device),
            graphed(MB_W, mb_h, *args, device=device, **flags))


def _inputs(key, seed, device):
    """Seeded (args, kw) for the key's program, as the decoder passes
    them: the per-MB arrays uploaded from numpy, padded references."""
    factory, _, flags = KEYS[key]
    field = factory is mpegvideo.recon_field
    mb_h = MB_H // 2 if field else MB_H
    nmb = MB_W * mb_h
    rng = np.random.default_rng(seed)
    coeffs = (rng.integers(-60, 61, (nmb, 6, 64)) *
              (rng.random((nmb, 6, 64)) < 0.15)).astype(np.int16)
    qscale = rng.integers(1, 32, nmb).astype(np.int32)
    intra = rng.random(nmb) < 0.25
    use_fwd, use_bwd = rng.random(nmb) < 0.7, rng.random(nmb) < 0.5
    if key in ("frame_p", "frame_interlaced", "frame_dual", "field_p",
               "field_dual"):
        use_fwd, use_bwd = np.ones(nmb, bool), np.zeros(nmb, bool)

    def mv(*shape):
        return rng.integers(-40, 41, shape).astype(np.int32)

    def sel(*shape):
        return rng.integers(0, 2, shape).astype(np.int32)

    qm = [rng.integers(8, 80, 64).astype(np.int32) for _ in range(2)]
    h, w = mb_h * 16, MB_W * 16

    def ref():
        return (rng.integers(0, 256, (h + 2 * EDGE, w + 2 * EDGE), np.uint8),
                *(rng.integers(0, 256, (h // 2 + 2 * EDGE, w // 2 + 2 * EDGE),
                               np.uint8) for _ in range(2)))
    kw = {}
    if field:
        args = [coeffs, qscale, intra, use_fwd, use_bwd, mv(nmb, 2, 2),
                sel(nmb, 2), mv(nmb, 2, 2), sel(nmb, 2), *qm,
                *ref(), *ref(), *ref(), *ref()]
    else:
        args = [coeffs, qscale, intra, use_fwd, use_bwd, mv(nmb, 2),
                mv(nmb, 2), *qm, *ref(), *ref()]
        if flags.get("interlaced"):
            kw = dict(field_mc=rng.random(nmb) < 0.5,
                      dct_field=rng.random(nmb) < 0.5, mvf2=mv(nmb, 2, 2),
                      mvb2=mv(nmb, 2, 2), sel_f=sel(nmb, 2),
                      sel_b=sel(nmb, 2))
    if flags.get("dual"):
        kw.update(dp=rng.random(nmb) < 0.5, mv_dp2=mv(nmb, 2, 2),
                  sel_dp=sel(nmb, 2))
    return hwdevice.state_from_numpy((tuple(args), kw), device)


def _counts(before):
    now = timer.counters()
    return {k: now.get(k, 0) - before.get(k, 0)
            for k in ("mpeg2.recon.graph", "mpeg2.recon.eager",
                      "mpeg2.recon.capture")}


def _equal(a, b):
    return all(torch.equal(x, y) for ga, gb in zip(a, b)
               for x, y in zip(ga, gb))


@pytest.mark.parametrize("key", list(KEYS))
def test_graphed_off_the_card_is_the_eager_program(key):
    cpu = torch.device("cpu")
    prog, graphed = _graphed(key, cpu)
    args, kw = _inputs(key, 1, cpu)
    before = timer.counters()
    got = graphed(*args, **kw)
    assert _counts(before) == {"mpeg2.recon.graph": 0,
                               "mpeg2.recon.eager": 1,
                               "mpeg2.recon.capture": 0}
    assert _equal(got, prog(*args, **kw))
    assert not prog.graph_runner.graphs


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=_needs_cuda)])
def test_control_reaches_the_runner(device):
    """The control's float IDCT, set over `mpegvideo.idct8x8_int` after
    the program's first run (and capture, on the card), changes what the
    decoder's graphed run gives to what the eager program gives under it,
    launching no K2; once it is lifted the exact output is back."""
    from avbench import control
    dev = torch.device(device)
    prog, graphed = _graphed("frame_p", dev)
    args, kw = _inputs("frame_p", 21, dev)
    want = graphed(*args, **kw)
    k2 = tidct.idct8x8_int.launches
    with control.broken("mpeg2video"):
        got = graphed(*args, **kw)
        eager = prog(*args, **kw)
    assert tidct.idct8x8_int.launches == k2
    assert not _equal(got, want)
    assert _equal(got, eager)
    assert _equal(graphed(*args, **kw), want)


def _md5(planes):
    h = hashlib.md5()
    for p in planes:
        h.update(np.ascontiguousarray(p, np.uint8).tobytes())
    return h.hexdigest()


def _config_streams(config):
    """[(packets, frame md5s)] of a benchmark configuration's frozen
    streams."""
    with open(os.path.join(ROOT, "avbench", "configs", config + ".json")) as f:
        streams = json.load(f)["streams"]
    return [(testdata.read_packets(os.path.join(ROOT, s["file"])),
             s["frame_md5"]) for s in streams]


def _decode(datas, device):
    dec = find_decoder("mpeg2video")(device=device)
    try:
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
        return [_md5(f.to_host().planes) for f in frames]
    finally:
        dec.close()


class TestGraphsOnCard:
    pytestmark = _needs_cuda

    @pytest.mark.parametrize("key", list(KEYS))
    def test_graphed_equals_eager(self, key):
        """Two calls with different inputs: each equals the eager
        program; the first call's outputs are not overwritten by the
        second's replay; K2 launches once a call."""
        dev = torch.device("cuda", 0)
        prog, graphed = _graphed(key, dev)
        ins = [_inputs(key, seed, dev) for seed in (11, 12)]
        want = [prog(*a, **k) for a, k in ins]
        before = timer.counters()
        k2 = tidct.idct8x8_int.launches
        got = [graphed(*a, **k) for a, k in ins]
        torch.cuda.synchronize()
        assert tidct.idct8x8_int.launches == k2 + 2
        counts = _counts(before)
        assert counts["mpeg2.recon.graph"] == 2
        assert counts["mpeg2.recon.eager"] == 0
        assert counts["mpeg2.recon.capture"] <= 1
        assert len(prog.graph_runner.graphs) == 1
        for g, w in zip(got, want):
            assert _equal(g, w)
        again = graphed(*ins[0][0], **ins[0][1])
        assert _equal(again, want[0]) and _equal(got[1], want[1])

    def test_frozen_streams_interleaved(self):
        """Cell 2's field GOP and cell 4's two frame GOPs (pattern, fade,
        pattern), each on a fresh decoder and on the programs the earlier
        GOPs built: every frame has its configuration's md5, K2 launches
        once and the runner replays once per coded picture."""
        dev = torch.device("cuda", 0)
        fields = _config_streams("mpeg2_mp_1080i")[0]
        pattern, fade = _config_streams("mpeg2_mp_1080p")
        for datas, want in (pattern, fields, fade, pattern, fields):
            before = timer.counters()
            k2 = tidct.idct8x8_int.launches
            assert _decode(datas, dev) == want
            pictures = 2 * len(want) if want is fields[1] else len(want)
            assert tidct.idct8x8_int.launches - k2 == pictures
            counts = _counts(before)
            assert counts["mpeg2.recon.graph"] == pictures
            assert counts["mpeg2.recon.eager"] == 0

    def test_two_workers_on_one_card(self):
        """GOPParallelDecoder, two workers on cuda:0 over the frame and
        field GOPs in turn: the serial md5s, in stream order."""
        from libav_tpu_torch.parallel.gop import (GOPParallelDecoder,
                                                  split_gops)
        fields = _config_streams("mpeg2_mp_1080i")[0]
        pattern, fade = _config_streams("mpeg2_mp_1080p")
        order = (pattern, fields, fade, fields, pattern, fade)
        pkts = [Packet(data=d, pts=i) for i, d in
                enumerate(d for datas, _ in order for d in datas)]
        assert len(split_gops(pkts, "mpeg2video")) == len(order)
        dec = GOPParallelDecoder("mpeg2video", ["cuda:0", "cuda:0"])
        got = [_md5(f.planes) for f in dec.decode(pkts)]
        assert got == [h for _, want in order for h in want]
