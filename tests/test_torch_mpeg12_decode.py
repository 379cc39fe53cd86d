"""The PyTorch port's MPEG-1/2 decoders against the JAX package's, end to
end.

Small streams are encoded once per module with the JAX package's encoder:
128x96 field pictures for every `fieldstress` motion-type mix, and 64x48
IPB frame pictures for MPEG-1 and MPEG-2. The hand-packed interlaced
frame-picture streams of tests/test_mpeg12.py (field MC, field DCT) run
through both decoders too. The JAX decoder and the port's decoder on the
CPU must produce identical frames; the port must stay jax-free and run
one IDCT per coded picture.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libav_tpu.codecs.api import CodecParameters, MediaType
from libav_tpu.codecs.api import find_decoder as jax_find
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs import find_decoder, mpegvideo
from libav_tpu_torch.codecs.mpeg12 import MPEG1Decoder, MPEG2Decoder
from libav_tpu_torch.ops import idct as tidct
from tools.gen_torch_smoke_stream import decode_reference, encode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIELDSTRESS = ("same", "opp", "whole", "h16", "dponly", "full")
STREAMS = {
    **{f"field_{p}": ("mpeg2video", 128, 96, 2,
                      {"qscale": 6, "gop_size": 8, "fieldpic": 1,
                       "fieldstress": p}) for p in FIELDSTRESS},
    "mpeg1_ipb": ("mpeg1video", 64, 48, 7,
                  {"qscale": 4, "gop_size": 12, "b_frames": 2}),
    "mpeg2_ipb": ("mpeg2video", 64, 48, 7,
                  {"qscale": 6, "gop_size": 12, "b_frames": 2}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


_CACHE = {}


def stream(name):
    """(codec, packets, JAX-decoded host planes) of a test stream, encoded
    on first use."""
    if name not in _CACHE:
        codec, w, h, n, settings = STREAMS[name]
        datas = encode(w, h, n, codec, settings)
        _CACHE[name] = codec, datas, decode_reference(datas, codec)
    return _CACHE[name]


def _port_decode(codec, datas, device="cpu"):
    dec = find_decoder(codec)(device=device)
    try:
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
    finally:
        dec.close()
    return [f.to_host().planes for f in frames]


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for gp, rp in zip(g, r):
            assert gp.dtype == np.uint8
            np.testing.assert_array_equal(gp, rp)


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_jax(name):
    codec, datas, ref = stream(name)
    _assert_same(_port_decode(codec, datas), ref)


def test_one_idct_per_coded_picture(monkeypatch):
    """Every coded picture's residual goes through one idct8x8_int call:
    4 field pictures + 7 frame pictures."""
    calls = []

    def counted(blocks):
        calls.append(blocks.shape[0])
        return tidct.idct8x8_int(blocks)
    monkeypatch.setattr(mpegvideo, "idct8x8_int", counted)
    codec, datas, _ = stream("field_full")
    _port_decode(codec, datas)
    assert calls == [8 * 3 * 6] * 4          # 8x3 MBs per field
    calls.clear()
    codec, datas, _ = stream("mpeg2_ipb")
    _port_decode(codec, datas)
    assert calls == [4 * 3 * 6] * 7


def test_cpu_tensors_launch_no_kernel():
    codec, datas, _ = stream("mpeg2_ipb")
    before = tidct.idct8x8_int.launches
    _port_decode(codec, datas[:3])
    assert tidct.idct8x8_int.launches == before == 0


class _BothDecoders:
    """Stands in for the JAX registry's decoder in the hand-packed stream
    tests: decodes with the JAX decoder and the port's, asserts identical
    frames, and hands the port's frames to the test's own checks."""

    def __init__(self, codec):
        self.codec = codec

    def __call__(self, params=None):
        return self

    def decode_all(self, packets):
        packets = list(packets)
        par = CodecParameters(codec_type=MediaType.VIDEO,
                              codec_id=self.codec)
        ref = jax_find(self.codec)(par).decode_all(packets)
        got = find_decoder(self.codec)(par, device="cpu").decode_all(packets)
        _assert_same([f.to_host().planes for f in got],
                     [[np.asarray(p) for p in f.to_host().planes]
                      for f in ref])
        return got


@pytest.mark.parametrize("case", ["test_field_mc_field_swap",
                                  "test_field_dct_interleave"])
def test_interlaced_frame_pictures(case, monkeypatch):
    from test_mpeg12 import TestInterlacedTools
    monkeypatch.setattr("libav_tpu.codecs.api.find_decoder", _BothDecoders)
    getattr(TestInterlacedTools(), case)()


def test_port_runs_without_jax(tmp_path):
    digests = {}
    for name in ("field_full", "mpeg2_ipb"):
        codec, datas, ref = stream(name)
        testdata.write_packets(str(tmp_path / f"{name}.pkts"), datas)
        digests[name] = (codec, testdata.digest(ref))
    code = f"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(1)
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs import find_decoder
out = {{}}
for name, codec in {[(n, c) for n, (c, _) in digests.items()]!r}:
    datas = testdata.read_packets(name + ".pkts")
    dec = find_decoder(codec)(device="cpu")
    frames = dec.decode_all(Packet(data=d, pts=i)
                            for i, d in enumerate(datas))
    out[name] = testdata.digest([f.to_host().planes for f in frames])
assert not any(m == "jax" or m.startswith("jax.")
               for m, v in sys.modules.items() if v is not None)
print(json.dumps(out))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {n: d for n, (_, d) in digests.items()}


def test_registry_is_the_port_own():
    assert find_decoder("mpeg1video") is MPEG1Decoder
    assert find_decoder("mpeg2video") is MPEG2Decoder
    assert jax_find("mpeg2video") is not MPEG2Decoder
    with pytest.raises(TypeError):
        MPEG2Decoder()


@pytest.mark.parametrize("name", list(testdata.MPEG2_SMOKE))
@pytest.mark.slow
def test_committed_golden_is_the_jax_decode(name):
    """The committed 1080-line stream's golden equals a fresh JAX
    decode."""
    path, golden = testdata.stream_paths(name)
    datas = testdata.read_packets(path)
    assert testdata.digest(decode_reference(datas, "mpeg2video")) == \
        testdata.load_golden(golden)


@pytest.mark.parametrize("name", list(testdata.MPEG2_SMOKE))
@pytest.mark.slow
def test_committed_stream_port_decode_matches_golden(name):
    """The chip smoke's MPEG-2 main path, on the CPU."""
    path, golden = testdata.stream_paths(name)
    datas = testdata.read_packets(path)
    got = testdata.digest(_port_decode("mpeg2video", datas))
    assert got == testdata.load_golden(golden)
