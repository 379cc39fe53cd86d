"""The config-5 audio chain of the port against the JAX package's, on the
CPU: the AC-3 and AAC decoders, the MDCT ops, avresample's
AudioResampler, the wav/pcm/ac3/adts containers and the port's avconv
`-ar`/`-ac`/`-sample_fmt` against the JAX CLI. Streams are made from a
seed (`tools.gen_torch_smoke_stream.audio_signal`) and encoded by the
JAX package's encoders; the same packets and sample arrays go to both
packages.

The bars. AC-3 decodes on the host in float64 in both packages: its
fltp planes and the s16 after the chain are equal. AAC's IMDCT is a
float32 matrix product, an XLA dot in the JAX package and torch.matmul
in the port, which sum in another order: fltp within 2e-6 for AAC-LC at
a -12 dBFS peak (3.1e-7 measured), within 3e-5 with SBR or PS, whose
output peaks near 2 (1.1e-5 measured); after the chain each s16 sample
is within 1 LSB, and at most 1% (LC) or 2% (SBR) of them differ
(ROADMAP.md §3).
"""

import hashlib

import numpy as np
import pytest
import torch

from libav_tpu.avresample import AudioResampler as JaxResampler
from libav_tpu.avutil.error import AVError as JaxAVError
from libav_tpu.codecs.api import find_decoder as jax_find_decoder
from libav_tpu.formats.api import open_input as jax_open_input
from libav_tpu.ops import fftmdct as jax_fftmdct
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch.avresample import AudioResampler
from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.codecs import find_decoder
from libav_tpu_torch.formats.api import open_input
from libav_tpu_torch.ops import fftmdct
from libav_tpu_torch.tools import avconv
from tools.gen_torch_smoke_stream import audio_signal, encode_audio


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


# name -> (codec, channels, encoder options, core sample rate)
STREAMS = {
    "ac3_20": ("ac3", 2, {"bitrate_kbps": 192}, 48000),
    "ac3_50": ("ac3", 5, {"bitrate_kbps": 384}, 48000),
    "ac3_51": ("ac3", 6, {"bitrate_kbps": 448}, 48000),
    "aac_lc": ("aac", 2, {"quality": 10}, 48000),
    "aac_lc_mono": ("aac", 1, {"quality": 10}, 48000),
    "aac_sbr": ("aac", 2, {"sbr": 1}, 24000),
    "aac_ps": ("aac", 1, {"sbr": 1, "ps": 1}, 24000),
}


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """name -> path of a 0.5 s stream written by the JAX encoders."""
    d = tmp_path_factory.mktemp("audio")
    out = {}
    for i, (name, (codec, ch, opts, rate)) in enumerate(STREAMS.items()):
        data = encode_audio(codec, audio_signal(0.5, ch, 60 + i, rate),
                            opts, rate)
        out[name] = str(d / f"{name}.{codec}")
        with open(out[name], "wb") as f:
            f.write(data)
    return out


def _packets(fc):
    out = []
    while True:
        try:
            pkt = fc.read_frame()
        except Exception:
            return out
        if pkt is None:
            return out
        out.append(pkt)


def _decode(path, jax: bool):
    """Every frame's planes stacked: (channels, samples) float32."""
    fc = (jax_open_input if jax else open_input)(path)
    par = fc.streams[0].codecpar
    dec = jax_find_decoder(par.codec_id)(par) if jax else \
        find_decoder(par.codec_id)(par, device="cpu")
    frames = dec.decode_all(_packets(fc))
    return np.concatenate([np.stack([np.asarray(p) for p in f.planes])
                           for f in frames], axis=1)


@pytest.mark.parametrize("name", ["ac3_20", "ac3_50"])
def test_ac3_decoder_matches_jax(name, streams):
    want = _decode(streams[name], jax=True)
    got = _decode(streams[name], jax=False)
    assert want.shape == (STREAMS[name][1], 24576)
    np.testing.assert_array_equal(got, want)


def test_ac3_51_is_refused_by_both(streams):
    """The JAX package cannot decode its own 5.1 stream (LFE is outside
    its subset); the port reproduces the refusal."""
    with pytest.raises(JaxAVError) as jax_err:
        _decode(streams["ac3_51"], jax=True)
    with pytest.raises(AVError) as err:
        _decode(streams["ac3_51"], jax=False)
    assert err.value.code == jax_err.value.code == INVALIDDATA
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("name,tol", [("aac_lc", 2e-6), ("aac_lc_mono", 2e-6),
                                      ("aac_sbr", 3e-5), ("aac_ps", 3e-5)])
def test_aac_decoder_matches_jax(name, tol, streams):
    want = _decode(streams[name], jax=True)
    got = _decode(streams[name], jax=False)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.float64) - want).max() <= tol


def test_aac_decoder_runs_its_imdct_on_its_device(streams):
    calls = fftmdct.imdct.calls
    got = _decode(streams["aac_lc"], jax=False)
    # one per channel and frame (24 frames, the encoder's priming included)
    assert fftmdct.imdct.calls - calls == 2 * (got.shape[1] // 1024)


@pytest.mark.parametrize("shape", [(1, 1024), (8, 128), (3, 256)])
def test_mdct_ops_match_jax(shape):
    rng = np.random.default_rng(shape[1])
    spec = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_fftmdct.imdct(spec))
    got = fftmdct.imdct(torch.from_numpy(spec)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    x = rng.standard_normal((shape[0], 2 * shape[1])).astype(np.float32)
    np.testing.assert_allclose(fftmdct.mdct(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_fftmdct.mdct(x)),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(fftmdct.imdct_host(spec),
                                  jax_fftmdct.imdct_host(spec))
    L = 2 * shape[1]
    np.testing.assert_array_equal(fftmdct.kbd_window(L),
                                  jax_fftmdct.kbd_window(L))
    np.testing.assert_array_equal(fftmdct.sine_window(L),
                                  jax_fftmdct.sine_window(L))
    np.testing.assert_allclose(fftmdct.rfft(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_fftmdct.rfft(x)),
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------- #
# avresample
# ---------------------------------------------------------------------- #

CONVERSIONS = {"50to2_44k": (5, 2, 48000, 44100),
               "2to2_32k": (2, 2, 48000, 32000)}
FORMATS = [("s16", "s16", "none"), ("fltp", "fltp", "none"),
           ("fltp", "s16", "none"), ("dblp", "dbl", "none"),
           ("dblp", "s16", "none")] + \
    [("fltp", "s16", m) for m in ("rectangular", "triangular",
                                  "triangular_hp", "triangular_ns")]


def _frames(fmt, channels, seed, frame_class):
    """Three 1536-sample frames of audio_signal in fmt."""
    sig = audio_signal(3 * 1536 / 48000, channels, seed).astype(np.float64)
    out = []
    for i in range(3):
        x = sig[:, 1536 * i:1536 * (i + 1)]
        f = frame_class(nb_samples=1536, sample_rate=48000, format=fmt,
                        channels=channels)
        if fmt == "s16":
            f.planes = [np.ascontiguousarray(
                np.round(x.T * 32767).astype(np.int16).reshape(-1))]
        else:
            dt = np.float32 if fmt == "fltp" else np.float64
            f.planes = [x[c].astype(dt) for c in range(channels)]
        f.pts = 1536 * i
        out.append(f)
    return out


@pytest.mark.parametrize("in_fmt,out_fmt,dither", FORMATS)
@pytest.mark.parametrize("conv", list(CONVERSIONS))
def test_resampler_matches_jax(conv, in_fmt, out_fmt, dither):
    """Downmix 5.0 -> stereo at 48k -> 44.1k and stereo 48k -> 32k in
    the s16, flt and dbl internal formats, each dither method: the same
    samples, the flush included."""
    from libav_tpu.avutil.frame import Frame as JaxFrame
    from libav_tpu_torch.avutil.samplefmt import default_channel_layout
    cin, cout, rin, rout = CONVERSIONS[conv]
    opts = dict(in_sample_rate=rin, out_sample_rate=rout,
                in_sample_fmt=in_fmt, out_sample_fmt=out_fmt,
                in_channel_layout=default_channel_layout(cin),
                out_channel_layout=default_channel_layout(cout),
                dither_method=dither)
    outs = []
    for cls, frame_cls in ((JaxResampler, JaxFrame),
                           (AudioResampler, Frame)):
        rs = cls(**opts).open()
        got = [rs.convert(f) for f in _frames(in_fmt, cin, 70, frame_cls)]
        got.append(rs.flush_resampler())
        outs.append(got)
    want, got = outs
    assert len(got) == len(want) and want[-1] is not None
    for a, b in zip(want, got):
        assert (b.format, b.channels, b.sample_rate, b.nb_samples) == \
            (a.format, a.channels, a.sample_rate, a.nb_samples)
        for pa, pb in zip(a.planes, b.planes):
            np.testing.assert_array_equal(pb, pa)


# ---------------------------------------------------------------------- #
# containers and the CLI
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def files(streams, tmp_path_factory):
    """The AC-3 stereo stream also as wav and raw s16le (by the JAX
    CLI)."""
    d = tmp_path_factory.mktemp("pcm")
    out = {"ac3": streams["ac3_20"], "adts": streams["aac_lc"]}
    for fmt, name in (("wav", "a.wav"), ("s16le", "a.pcm")):
        out[fmt] = str(d / name)
        assert jax_avconv.main(["-i", streams["ac3_20"], "-f", fmt,
                                out[fmt]]) == 0
    return out


RAW_INPUT = {"s16le": ["-f", "s16le", "-ar", "48000", "-ac", "2"]}


@pytest.mark.parametrize("fmt", ["ac3", "adts", "wav", "s16le"])
def test_demuxers_match_jax(fmt, files):
    """The same packets (bytes, pts, duration) and stream parameters."""
    opts = {"sample_rate": 48000, "channels": 2} if fmt == "s16le" else {}
    want_fc = jax_open_input(files[fmt], fmt if fmt == "s16le" else None,
                             **({"options": opts} if opts else {}))
    fc = open_input(files[fmt], fmt if fmt == "s16le" else None,
                    **({"options": opts} if opts else {}))
    want = [(p.data, p.pts, p.duration) for p in _packets(want_fc)]
    got = [(p.data, p.pts, p.duration) for p in _packets(fc)]
    assert len(want) > 3 and got == want
    a, b = want_fc.streams[0].codecpar, fc.streams[0].codecpar
    assert (b.codec_id, b.sample_rate, b.channels) == \
        (a.codec_id, a.sample_rate, a.channels)


@pytest.mark.parametrize("src,opts", [
    ("ac3", ["-c:a", "copy", "-f", "ac3"]),
    ("adts", ["-c:a", "copy", "-f", "adts"]),
    ("ac3", ["-f", "wav"]),
    ("wav", ["-f", "s16le"]),
    ("s16le", ["-f", "wav"]),
])
def test_muxers_match_jax(src, opts, files, tmp_path):
    """Both CLIs write the same bytes (stream copy, or PCM re-encode)."""
    inp = RAW_INPUT.get(src, []) + ["-i", files[src]]
    out = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        out[name] = tmp_path / f"{name}.out"
        assert tool.main([*inp, *opts, str(out[name])], **kw) == 0
    assert out["port"].read_bytes() == out["jax"].read_bytes()


@pytest.mark.parametrize("name,args", [
    ("ac3_20", ["-ar", "44100", "-ac", "2"]),
    ("ac3_50", ["-ar", "44100", "-ac", "2"]),
    ("ac3_50", ["-ac", "2", "-sample_fmt", "flt"]),
    ("ac3_20", ["-ar", "32000", "-sample_fmt", "s16"]),
])
def test_avconv_ac3_chain_matches_jax(name, args, streams, tmp_path):
    """AC-3 decode, then avresample, then PCM: the JAX CLI's bytes."""
    out = {}
    for tag, tool, kw in (("jax", jax_avconv, {}),
                          ("port", avconv, {"device": "cpu"})):
        out[tag] = tmp_path / f"{tag}.raw"
        fmt = "f32le" if "flt" in args else "s16le"
        assert tool.main(["-i", streams[name], *args, "-f", fmt,
                          str(out[tag])], **kw) == 0
    want = out["jax"].read_bytes()
    assert len(want) > 40000
    assert hashlib.md5(out["port"].read_bytes()).hexdigest() == \
        hashlib.md5(want).hexdigest()


@pytest.mark.parametrize("name,share", [("aac_lc", 100), ("aac_sbr", 50)])
def test_avconv_aac_chain_within_one_lsb(name, share, streams, tmp_path):
    """At most 1 in `share` samples differ, each by 1 (measured: 0.1%
    for AAC-LC, 1.1% for SBR, whose output peaks near 2 and clips)."""
    out = {}
    for tag, tool, kw in (("jax", jax_avconv, {}),
                          ("port", avconv, {"device": "cpu"})):
        out[tag] = tmp_path / f"{tag}.raw"
        assert tool.main(["-i", streams[name], "-ar", "44100", "-f",
                          "s16le", str(out[tag])], **kw) == 0
    want = np.frombuffer(out["jax"].read_bytes(), np.int16).astype(int)
    got = np.frombuffer(out["port"].read_bytes(), np.int16).astype(int)
    assert got.shape == want.shape and want.size > 40000
    assert np.abs(got - want).max() <= 1
    assert (got != want).sum() <= want.size // share
