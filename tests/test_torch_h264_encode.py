"""The PyTorch port's H.264 encoder held against the JAX package's, packet
for packet.

The same frames of the moving test pattern (`testdata.pattern`) go
through the JAX encoder (on the CPU) and the port's H264Encoder on the
CPU, through the send/receive API and through both CLIs: at 64x64 with
the bench stream's settings (CABAC, I_8x8, 8x8 transform, B-frames,
deblock, 4 slices) and with the defaults (CAVLC, I_16x16, P). The
option sets of `testdata.H264_EXT` are in test_torch_h264_encode_ext.py;
I_4x4 with deblock, refs=2, scaling matrices and poc types in
test_torch_h264_encode_opts.py; the CLI and the decode of the port's own
packets in test_torch_h264_encode_cli.py. The codec is integer-exact
and the 8x8 transform sums in XLA's float32 order, so the tolerance is
exact equality: every packet byte for byte.
"""

import functools

import pytest
import torch

import bench
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import (CodecParameters, MediaType,
                                        find_encoder)
from libav_tpu_torch.codecs.h264 import H264Encoder
from libav_tpu_torch.ops import h264deblock
from tools.gen_torch_smoke_stream import encode as jax_encode

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def frames(w, h, n, tensors=False):
    out = []
    for t in range(n):
        f = Frame.alloc_video(w, h, "yuv420p")
        planes = testdata.pattern(w, h, t)
        f.planes[:3] = ([torch.as_tensor(p) for p in planes] if tensors
                        else planes)
        f.pts = t
        out.append(f)
    return out


def port_encode(w, h, n, settings, device="cpu", tensors=False):
    """n pattern frames through the port's encoder: packet bytes."""
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264",
                          width=w, height=h, pix_fmt="yuv420p",
                          framerate=Rational(25, 1))
    enc = find_encoder("h264")(par, device=device)
    for k, v in settings.items():
        enc.set_opt(k, v)
    return [p.data for p in enc.encode_all(frames(w, h, n, tensors))]


@functools.lru_cache(maxsize=None)
def jax_packets(w, h, n, items):
    return jax_encode(w, h, n, settings=dict(items))


def assert_packets_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"packet {i} differs"


def test_bench_settings_are_benchs():
    assert testdata.BENCH_SETTINGS == bench.ENC_SETTINGS
    assert testdata.BENCH_FRAMES == bench.NFRAMES
    assert (bench.W, bench.H) == testdata.ENCODE_SOURCES[0][:2]


@pytest.mark.parametrize("name,n,settings", [
    ("bench", 5, testdata.BENCH_SETTINGS),
    ("defaults", 4, {}),
])
def test_packets_match_jax(name, n, settings):
    want = jax_packets(64, 64, n, tuple(settings.items()))
    h264deblock.h264_deblock_frame.launches = 0
    got = port_encode(64, 64, n, settings)
    assert_packets_equal(got, want)
    # CPU tensors take the frame deblock's plain version: no launch
    assert h264deblock.h264_deblock_frame.launches == 0


def test_tensor_frames_and_odd_size():
    """Frames holding tensors give the same packets as numpy planes, and
    a size that is not whole macroblocks is padded on the device as the
    JAX encoder pads on the host."""
    settings = {"entropy": "cabac", "i8x8": 1, "dct8x8": 1, "deblock": 1}
    want = jax_packets(50, 38, 3, tuple(settings.items()))
    assert_packets_equal(port_encode(50, 38, 3, settings, tensors=True),
                         want)


def test_encoder_runs_on_the_card_unless_told():
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264",
                          width=32, height=32, pix_fmt="yuv420p")
    cls = find_encoder("h264")
    assert cls is H264Encoder and cls.DEVICE_PART
    assert cls(par, device="cpu").device == CPU
    if torch.cuda.is_available():
        assert cls(par).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(par)


def test_encode_probe_h264_stages():
    """The timing tool's H.264 stage wrappers see every stage of an
    I_8x8/P/B encode with deblock (K1's run too), change no byte, and
    leave the classes as they found them."""
    from libav_tpu_torch.codecs.h264 import device, encdev
    from libav_tpu_torch.tools import encode_probe as ep
    settings = dict(testdata.BENCH_SETTINGS, slices=2)
    before = (encdev.EncodeI8.forward, device.ReconH264Deblock.forward,
              H264Encoder._emit_slices)
    want = port_encode(48, 32, 4, settings)
    frames_ = ep.pattern_frames(CPU, 48, 32, 4)
    with ep.stages(CPU, "h264") as st:
        got, _ = ep.encode(CPU, frames_, settings, codec="h264")
    assert got == want
    assert len(st["I wavefront (EncodeI8)"]) == 1
    assert len(st["P search + transform/quant"]) == 1
    assert len(st["B search + transform/quant"]) == 2
    assert len(st["host packing (slice headers + entropy)"]) == 4
    assert len(st[ep.K1_LABEL]) == len(
        st["closed-loop reference (upload, recon, deblock)"]) == 2
    assert (encdev.EncodeI8.forward, device.ReconH264Deblock.forward,
            H264Encoder._emit_slices) == before


def test_encode_golden_sources():
    """encode_cli.golden.json's source adler32 are the pattern's planes
    here, and it holds an md5 for every ENCODE_CLI run."""
    gold = testdata.load_golden(testdata.encode_cli_golden_path())
    assert set(gold["cli"]) == set(testdata.ENCODE_CLI)
    for out, (name, args) in testdata.ENCODE_CLI.items():
        assert gold["cli"][out]["args"] == list(args)
    for w, h, n in testdata.ENCODE_SOURCES:
        assert [testdata.plane_adler32(testdata.pattern(w, h, t))
                for t in range(n)] == gold["source"][f"{w}x{h}"]
