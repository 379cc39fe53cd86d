"""The port's tools against the JAX package's: the plain versions of the
timing tool's kernels P1 and P2 against its Pallas kernels (interpret
mode) and the numpy references, and the port's avconv and avprobe on
the CPU against `libav_tpu.tools.avconv` / `avprobe`, byte for byte.

Inputs: the committed 64x64 H.264 file, a 64x48 MPEG-2 IPB stream and
two small JPEGs written by the JAX package's encoders; the MPEG-2 stream
is also transcoded to MPEG-4 by both CLIs. All comparisons are exact.
"""

import contextlib
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import libav_tpu.codecs.api as jax_codecs
from libav_tpu.ops.h264deblock import filter_edge_ref
from libav_tpu.ops.idct import idct8x8_int_ref
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu.tools import avprobe as jax_avprobe
from libav_tpu.tools import pallas_probe
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.error import AVError
from libav_tpu_torch.codecs import find_decoder, mpeg12
from libav_tpu_torch.formats import m4v
from libav_tpu_torch.ops import h264deblock as tdb
from libav_tpu_torch.ops import idct as tidct
from libav_tpu_torch.tools import avconv, avprobe, kernel_probe
from test_mjpeg import encode as jpeg_encode
from test_mjpeg import synth_frame
from tools.gen_torch_smoke_stream import encode

@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


# ---------------------------------------------------------------------- #
# P1 and P2: plain versions against the Pallas kernels and numpy
# ---------------------------------------------------------------------- #

def test_p1_plain_matches_pallas_and_reference():
    B = 256
    blocks = testdata.idct_blocks(31, B)          # the five input classes
    xT = blocks.reshape(B, 64).T.copy()
    _, pallas_fn = pallas_probe._build(B)
    want = np.asarray(pallas_fn(xT))
    np.testing.assert_array_equal(want.T.reshape(B, 8, 8),
                                  idct8x8_int_ref(blocks))
    got = tidct.idct8x8_int_cm(torch.as_tensor(xT))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_p2_plain_matches_pallas_and_reference():
    B = 1024
    rng = np.random.default_rng(32)
    lines = rng.integers(0, 256, (B, 8)).astype(np.int32)
    lines[::2] = np.clip(lines[::2, :1] + rng.integers(-6, 7, (B // 2, 8)),
                         0, 255)
    qp = rng.integers(0, 52, B).astype(np.int32)
    bs = rng.integers(0, 5, B).astype(np.int32)
    xT = lines.T.copy()
    _, pallas_fn = pallas_probe._build_deblock(B)
    want = np.asarray(pallas_fn(xT, qp, bs))
    ref = np.empty_like(lines)
    for q in np.unique(qp):
        sel = qp == q
        ref[sel] = filter_edge_ref(lines[sel], int(q), bs[sel])
    np.testing.assert_array_equal(want.T, ref)
    assert (want.T != lines).any(axis=1).sum() > B // 8   # filters fired
    got = tdb.h264_edge_filter_pm(*(torch.as_tensor(a) for a in (xT, qp, bs)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_probe_inputs_and_device():
    blocks = kernel_probe.idct_inputs(300)
    assert blocks.shape == (300, 8, 8) and (blocks[::3, :, 1:] == 0).all()
    lines, qp, bs = kernel_probe.deblock_inputs(513)
    assert lines.shape == (513, 8) and (qp == 30).all() and bs.max() == 4
    with pytest.raises(ValueError, match="CUDA"):
        kernel_probe.probe_idct(4, 1, device="cpu")


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """name -> path of a small CLI input."""
    d = tmp_path_factory.mktemp("cli")
    out = {"h264": testdata.SMALL_H264}
    m2v = encode(64, 48, 7, "mpeg2video",
                 {"qscale": 6, "gop_size": 12, "b_frames": 2})
    out["m2v"] = str(d / "ipb.m2v")
    with open(out["m2v"], "wb") as f:
        f.write(b"".join(m2v))
    for fmt in ("yuvj420p", "yuvj422p"):
        out[fmt] = str(d / f"{fmt}.jpg")
        with open(out[fmt], "wb") as f:
            f.write(jpeg_encode(synth_frame(48, 32, fmt), 85))
    return out


def _framecrc(tool, src, dst, *opts, **kw):
    assert tool.main([*opts, "-i", src, "-f", "framecrc", dst], **kw) == 0
    with open(dst) as f:
        return f.read()


@pytest.mark.parametrize("name", ["h264", "m2v", "yuvj420p", "yuvj422p"])
def test_avconv_framecrc_matches_jax(name, inputs, tmp_path):
    src = inputs[name]
    want = _framecrc(jax_avconv, src, str(tmp_path / "jax.crc"))
    got = _framecrc(avconv, src, str(tmp_path / "port.crc"), device="cpu")
    assert got == want
    assert want.count("\n0, ") >= 1


def test_avconv_leaves_the_jax_cli_alone(inputs, tmp_path):
    _framecrc(avconv, inputs["yuvj420p"], str(tmp_path / "o.crc"),
              device="cpu")
    assert jax_avconv.find_decoder is jax_codecs.find_decoder
    assert jax_avconv.find_encoder is jax_codecs.find_encoder


def _probe(tool, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tool.main(argv, **kw) == 0
    return out.getvalue()


@pytest.mark.parametrize("argv", [["-show_frames"], ["-show_streams"]])
def test_avprobe_matches_jax(argv, inputs):
    for name in ("m2v", "yuvj420p"):
        want = _probe(jax_avprobe, argv + [inputs[name]])
        got = _probe(avprobe, argv + [inputs[name]], device="cpu")
        assert got == want
        assert ("[frames.frame]" in got) == (argv == ["-show_frames"])


def test_avprobe_raises_device_faults(inputs, monkeypatch):
    """The host code swallows every exception of a trial decode; an error
    of the port's decoder that is not an AVError comes out of main."""
    def fault(self, *args):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(mpeg12.MPEG2Decoder, "_decode", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _probe(avprobe, ["-show_frames", inputs["m2v"]], device="cpu")


@pytest.mark.parametrize("opts,step", [
    (["-c:v", "mjpeg"], "step 9"),
    (["-c:v", "h264"], "step 7"),
    (["-c:v", "mpeg2video"], "step 8b"),
    (["-c:v", "prores"], "step 11"),
    (["-c:v", "ffv1"], "step 15"),
])
def test_unported_parts_name_their_step(opts, step, inputs, tmp_path,
                                        capsys):
    out = str(tmp_path / "o.avi" if "-c:v" in opts else tmp_path / "o.crc")
    argv = ["-i", inputs["yuvj420p"], *opts]
    argv += [out] if "-c:v" in opts else ["-f", "framecrc", out]
    assert avconv.main(argv, device="cpu") == 1
    err = capsys.readouterr().err
    assert step in err and "libav_tpu_torch" in err


def test_avconv_vf_yadif_matches_jax(inputs, tmp_path):
    """`-vf yadif` (step 12, filters) runs in the port's avconv: the
    deinterlaced MPEG-2 stream's framecrc equals the JAX CLI's."""
    out = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        dst = str(tmp_path / f"{name}.crc")
        assert tool.main(["-i", inputs["m2v"], "-vf", "yadif", "-f",
                          "framecrc", dst], **kw) == 0
        with open(dst) as f:
            out[name] = f.read()
    assert out["port"] == out["jax"]
    assert out["jax"].count("\n0, ") == 7


def test_avconv_mpeg4_transcode_matches_jax(inputs, tmp_path, capsys):
    """MPEG-2 in, MPEG-4 out through both CLIs: the same bytes. The H.264
    encoder is still refused, naming its step."""
    argv = ["-i", inputs["m2v"], "-c:v", "mpeg4", "-bf", "2", "-f", "m4v"]
    out = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        out[name] = str(tmp_path / f"{name}.m4v")
        assert tool.main(argv + [out[name]], **kw) == 0
    with open(out["jax"], "rb") as f, open(out["port"], "rb") as g:
        want, got = f.read(), g.read()
    assert got == want
    # coding order: I, then P B B twice (vop_coding_type 0 I, 1 P, 2 B)
    assert [m4v.M4VDemuxer._vop_type(c) for c in m4v.split_vops(got)] == \
        [0, 1, 2, 2, 1, 2, 2]
    capsys.readouterr()
    assert avconv.main(["-i", inputs["m2v"], "-c:v", "h264",
                        str(tmp_path / "o.avi")], device="cpu") == 1
    err = capsys.readouterr().err
    assert "Encoder not found" in err and "step 7" in err


def test_avconv_mpeg4_to_avi_matches_jax(inputs, tmp_path):
    """The AVI muxer tags the port's MPEG-4 stream FMP4, as the JAX one
    does: the two files are the same bytes."""
    argv = ["-i", inputs["m2v"], "-c:v", "mpeg4", "-g", "3"]
    assert jax_avconv.main(argv + [str(tmp_path / "jax.avi")]) == 0
    assert avconv.main(argv + [str(tmp_path / "port.avi")],
                       device="cpu") == 0
    want = (tmp_path / "jax.avi").read_bytes()
    assert (tmp_path / "port.avi").read_bytes() == want
    assert b"FMP4" in want


def test_unported_decoders_name_their_step():
    with pytest.raises(AVError, match="step 8b"):
        find_decoder("h263")
    with pytest.raises(AVError, match="step 11"):
        find_decoder("prores")
    with pytest.raises(AVError, match="step 15"):
        find_decoder("ffv1")
    dec = find_decoder("mjpeg")(device="cpu")
    assert dec.device == torch.device("cpu")


@pytest.mark.parametrize("name,data,step", [
    ("in.flv", b"FLV\x01\x05\x00\x00\x00\x09" + bytes(64), "step 8b"),
    ("live.m3u8", b"#EXTM3U\n#EXT-X-TARGETDURATION:2\nseg0.ts\n",
     "step 16"),
])
def test_unported_containers_name_their_step(name, data, step, tmp_path,
                                              capsys):
    """An FLV file and an HLS playlist: the JAX package has their
    demuxers and the port not yet; avconv says which step ports each."""
    src = tmp_path / name
    src.write_bytes(data)
    assert avconv.main(["-i", str(src), "-f", "framecrc",
                        str(tmp_path / "o.crc")], device="cpu") == 1
    err = capsys.readouterr().err
    assert step in err and "libav_tpu_torch" in err


def test_cuda_request_fails_cleanly(inputs, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    assert avconv.main(["-i", inputs["m2v"], "-f", "framecrc",
                        str(tmp_path / "o.crc")]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_prof_writes_trace_and_report(inputs, tmp_path, capsys):
    prof = tmp_path / "prof"
    crc = _framecrc(avconv, inputs["h264"], str(tmp_path / "o.crc"),
                    "-prof", str(prof), "-frames", "1", device="cpu")
    assert crc.count("\n0, ") == 1
    with open(prof / "avconv.pt.trace.json") as f:
        trace = f.read()
    assert trace.lstrip().startswith("{") and '"traceEvents"' in trace
    assert '"name": "aten::' in trace
    assert "us avg in h264.entropy" in capsys.readouterr().err


def test_cli_runs_without_jax(inputs, tmp_path):
    from test_torch_standalone import IMPORT_GUARD
    want = {name: _framecrc(jax_avconv, inputs[name],
                            str(tmp_path / f"{name}.jax"))
            for name in ("h264", "m2v", "yuvj420p")}
    code = IMPORT_GUARD + f"""
import contextlib, io, json
import torch
torch.set_num_threads(1)
from libav_tpu_torch.tools import avconv, avprobe
out = {{}}
for name, src in {[(n, inputs[n]) for n in want]!r}:
    dst = name + ".crc"
    assert avconv.main(["-i", src, "-f", "framecrc", dst], device="cpu") == 0
    out[name] = open(dst).read()
text = io.StringIO()
with contextlib.redirect_stdout(text):
    assert avprobe.main(["-show_frames", {inputs["m2v"]!r}],
                        device="cpu") == 0
assert text.getvalue().count("[frames.frame]") == 7
assert not any(m.split(".")[0] in ("jax", "libav_tpu")
               for m, v in sys.modules.items() if v is not None)
print(json.dumps(out))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == want


def test_timer_spans_share_the_jax_stats():
    """The port's timer is its own copy: every span of the port (the
    H.264 decoder's h264.entropy among them) lands in the port's one
    _STATS, reported in the JAX timer's format, and none in the JAX
    package's."""
    from libav_tpu.avutil import timer as jax_timer
    from libav_tpu_torch.avutil import timer
    from libav_tpu_torch.codecs.h264 import dec as h264dec
    assert timer.report is not jax_timer.report
    timer.reset()
    jax_before = dict(jax_timer._STATS)
    with timer.timer("port.span", sync=torch.zeros(2)):
        pass
    n0, _ = h264dec.host_entropy_stats()
    with timer.timer("h264.entropy"):
        pass
    assert h264dec.host_entropy_stats()[0] == n0 + 1
    assert timer._STATS["port.span"][0] == 1
    assert "us avg in port.span (n=1" in timer.report()
    assert dict(jax_timer._STATS) == jax_before
