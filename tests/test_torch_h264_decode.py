"""The PyTorch port's H.264 decoder against the JAX package's, end to end.

A 64x64 stream with the bench settings (CABAC, I_8x8 + 8x8 transform,
IPBB, 4 slices, deblocking) is encoded once per module with the JAX
package's encoder; the JAX decoder and the port's decoder on the CPU must
produce identical frames. The port must also stay jax-free, refuse a CUDA
device where there is none, and launch no kernel for CPU tensors.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from libav_tpu_torch import testdata
from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs import find_decoder
from libav_tpu_torch.codecs.h264 import H264Decoder
from libav_tpu_torch.ops import h264deblock as tdb
from tools.gen_torch_smoke_stream import decode_reference, encode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stream():
    """(access units, JAX-decoded host planes) of the 64x64 bench-settings
    stream."""
    datas = encode(64, 64, 8)
    return datas, decode_reference(datas)


def _port_decode(datas, device="cpu"):
    dec = H264Decoder(device=device)
    try:
        frames = dec.decode_all(Packet(data=d, pts=i)
                                for i, d in enumerate(datas))
    finally:
        dec.close()
    return [f.to_host().planes for f in frames]


def test_stream_has_the_three_bench_variants(stream):
    datas, ref = stream
    assert len(datas) == 8 and len(ref) == 8
    types = set()
    dec = H264Decoder(device="cpu")
    inner = dec._reconstruct

    def spy(fd, info):
        f = inner(fd, info)
        types.add(f.pict_type)
        return f
    dec._reconstruct = spy
    try:
        dec.decode_all(Packet(data=d, pts=i) for i, d in enumerate(datas))
    finally:
        dec.close()
    assert types == {1, 2, 3}          # I, P and B pictures


def test_decode_matches_jax(stream):
    datas, ref = stream
    got = _port_decode(datas)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for gp, rp in zip(g, r):
            assert gp.dtype == np.uint8
            np.testing.assert_array_equal(gp, rp)


def test_cpu_tensors_launch_no_kernel(stream):
    datas, _ = stream
    before = (tdb.h264_deblock_wave.launches,
              tdb.h264_edge_filter_lines.launches)
    _port_decode(datas[:3])
    assert (tdb.h264_deblock_wave.launches,
            tdb.h264_edge_filter_lines.launches) == before == (0, 0)


def test_port_runs_without_jax(stream, tmp_path):
    datas, ref = stream
    path = tmp_path / "s.h264pkts"
    testdata.write_packets(str(path), datas)
    code = f"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(1)
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs.h264 import H264Decoder
datas = testdata.read_packets({str(path)!r})
dec = H264Decoder(device="cpu")
frames = dec.decode_all(Packet(data=d, pts=i) for i, d in enumerate(datas))
dec.close()
assert not any(m == "jax" or m.startswith("jax.")
               for m, v in sys.modules.items() if v is not None)
print(json.dumps(testdata.digest([f.to_host().planes for f in frames])))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    import json
    assert json.loads(r.stdout.strip().splitlines()[-1]) == \
        testdata.digest(ref)


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="this host has a CUDA device")
def test_cuda_request_raises_without_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hwdevice.device("cuda")
    with pytest.raises(RuntimeError):
        H264Decoder(device="cuda:0")


def test_device_is_explicit():
    with pytest.raises(TypeError):
        H264Decoder()
    assert hwdevice.device("cpu") == torch.device("cpu")
    assert hwdevice.describe(torch.device("cpu")) == \
        {"platform": "cpu", "kind": "cpu", "count": 1}
    with pytest.raises(ValueError):
        hwdevice.device("meta")


def test_registry_is_the_port_own():
    from libav_tpu.codecs.api import find_decoder as jax_find
    assert find_decoder("h264") is H264Decoder
    assert jax_find("h264") is not H264Decoder


def test_frame_moves_between_host_and_device():
    from libav_tpu_torch.avutil.frame import Frame
    f = Frame(width=4, height=2, format="gray")
    f.planes = [np.arange(8, dtype=np.uint8).reshape(2, 4)]
    f.poc = 3
    d = f.to_device(torch.device("cpu"))
    assert isinstance(d, Frame) and isinstance(d.planes[0], torch.Tensor)
    h = d.to_host()
    assert isinstance(h, Frame) and h.width == 4
    np.testing.assert_array_equal(h.planes[0], f.planes[0])


@pytest.mark.slow
def test_committed_golden_is_the_jax_decode():
    """The committed smoke stream's golden equals a fresh JAX decode."""
    datas = testdata.read_packets(testdata.SMOKE_STREAM)
    assert testdata.digest(decode_reference(datas)) == testdata.load_golden()


@pytest.mark.slow
def test_committed_stream_port_decode_matches_golden():
    """The chip smoke's main path, on the CPU."""
    datas = testdata.read_packets(testdata.SMOKE_STREAM)
    got = testdata.digest(_port_decode(datas))
    assert got == testdata.load_golden()
