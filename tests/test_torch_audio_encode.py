"""The port's audio encoders and the decoders that come with them against
the JAX package's, on the CPU, on the same numpy signals made from a
seed (`tools.gen_torch_smoke_stream.audio_signal`).

The bars:
- MP1, MP2, MP3 (mono, stereo, joint stereo) and FLAC are host code in
  both packages: every packet's bytes equal, and both decoders give the
  same PCM, bit for bit.
- AC-3 and AAC quantise a float32 MDCT that the port computes with
  torch.matmul and the JAX package with an XLA dot, which sum in other
  orders. After the MDCT they are exact: with the JAX spectra injected
  (the port module's `mdct` patched in the test), every packet equals
  the JAX encoder's, for every option the JAX encoder offers (LTP, TNS,
  PNS, intensity, pulses, SBR and PS among them). With the port's own
  MDCT they give as many packets; the count that differ is printed, and
  the SNR against the source of the port's packets, decoded by the
  port's decoder, is within `containers.SNR_TOLERANCE_DB` (0.05 dB) of
  that of the JAX packets decoded the same way.
- `ops/float_dsp`: the elementwise ops equal the JAX ops; scalarproduct
  sums in torch's order, within 4 float32 ulps of the sum of |a*b|.
- `avutil/fifo`: the same answers.
- The whole slice through both avconvs at a small size: a 64x64 H.264
  stream and 1 s of AAC and AC-3 muxed into MP4, Matroska and MPEG-TS,
  their framecrc, and a Matroska -> MP4 transcode to MPEG-4 + AAC.
"""

import numpy as np
import pytest
import torch

from libav_tpu.avutil.error import AVError as JaxAVError
from libav_tpu.avutil.fifo import Fifo as JaxFifo
from libav_tpu.avutil.frame import Frame as JFrame
from libav_tpu.avutil.frame import Packet as JPacket
from libav_tpu.codecs import api as jax_api
from libav_tpu.formats import FormatContext as JFormatContext
from libav_tpu.ops import fftmdct as jax_fftmdct
from libav_tpu.ops import float_dsp as jax_dsp
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.fifo import Fifo
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.codecs import api
from libav_tpu_torch.codecs.aac import enc as aac_enc
from libav_tpu_torch.codecs.ac3 import enc as ac3_enc
from libav_tpu_torch.formats import FormatContext
from libav_tpu_torch.ops import fftmdct
from libav_tpu_torch.ops import float_dsp
from libav_tpu_torch.testdata import containers as C
from libav_tpu_torch.tools import avconv
from tools.gen_torch_smoke_stream import audio_signal, encode_audio


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def _encode(codec, x, rate, opts, port):
    """x through the port's encoder on the CPU or the JAX encoder: the
    packets' bytes (a FLAC stream's header first)."""
    if port:
        return C.encode(api, Frame, codec, opts, x, rate, device="cpu")
    return C.encode(jax_api, JFrame, codec, opts, x, rate)


def _decode(codec, datas, rate):
    """Packets through the port's decoder on the CPU: (planes, n)."""
    return C.decode_back(api, Packet, codec, datas, rate, device="cpu")


def _jax_mdct(x):
    """The JAX package's `fftmdct.mdct` (an XLA dot) on a tensor's
    values, as a tensor on its device."""
    return torch.from_numpy(np.array(jax_fftmdct.mdct(
        x.cpu().numpy()))).to(x.device)


def _transient(seconds, channels, rate):
    """A quiet tone with a click in its middle, so that the AAC encoder
    switches to EIGHT_SHORT."""
    n = int(seconds * rate)
    x = np.tile(0.05 * np.sin(2 * np.pi * 220 * np.arange(n) / rate),
                (channels, 1))
    x[:, n // 2:n // 2 + 20] += 0.8
    return x.astype(np.float32)


# name -> (codec, channels, rate, options, seconds)
INJECTED = {
    "ac3_stereo": ("ac3", 2, 48000, {"bitrate_kbps": 192}, 0.2),
    "ac3_mono": ("ac3", 1, 44100, {"bitrate_kbps": 96}, 0.2),
    "ac3_50": ("ac3", 5, 48000, {"bitrate_kbps": 384}, 0.15),
    "ac3_51": ("ac3", 6, 48000, {"bitrate_kbps": 448}, 0.15),
    "ac3_32k": ("ac3", 2, 32000, {"bitrate_kbps": 128}, 0.2),
    "aac_default": ("aac", 2, 48000, {}, 0.2),
    "aac_q1": ("aac", 2, 48000, {"quality": 1}, 0.15),
    "aac_q10_mono": ("aac", 1, 44100, {"quality": 10}, 0.15),
    "aac_tns": ("aac", 2, 48000, {"tns": 1}, 0.15),
    "aac_pns": ("aac", 1, 48000, {"pns": 1}, 0.15),
    "aac_intensity": ("aac", 2, 48000, {"intensity": 1}, 0.15),
    "aac_pulse": ("aac", 2, 48000, {"pulse": 1}, 0.15),
    "aac_intensity_pulse": ("aac", 2, 48000, {"intensity": 1, "pulse": 1},
                            0.15),
    "aac_ltp_mono": ("aac", 1, 48000, {"ltp": 1}, 0.2),
    "aac_ltp_stereo": ("aac", 2, 48000, {"ltp": 1}, 0.2),
    "aac_transient": ("aac", 1, 48000, {}, 0.15),
    "aac_transient_ltp": ("aac", 2, 48000, {"ltp": 1}, 0.15),
    **{f"aac_sbr{p}": ("aac", 1 if p < 5 else 2, 24000, {"sbr": p}, 0.3)
       for p in range(1, 6)},
    "aac_sbr3_stereo": ("aac", 2, 24000, {"sbr": 3}, 0.3),
    **{f"aac_ps{p}": ("aac", 1, 24000, {"sbr": p, "ps": p}, 0.3)
       for p in range(1, 4)},
}


@pytest.mark.parametrize("name", list(INJECTED))
def test_encoder_after_mdct_matches_jax(name, monkeypatch):
    """The port's AAC / AC-3 encoder with the JAX spectra injected: every
    packet equal to the JAX encoder's; the device MDCT is called once
    per frame."""
    codec, ch, rate, opts, seconds = INJECTED[name]
    x = (_transient(seconds, ch, rate) if "transient" in name else
         audio_signal(seconds, ch, 40 + len(name), rate))
    want = _encode(codec, x, rate, opts, port=False)
    module = aac_enc if codec == "aac" else ac3_enc
    calls = []
    monkeypatch.setattr(module, "mdct",
                        lambda t: calls.append(t.shape) or _jax_mdct(t))
    got = _encode(codec, x, rate, opts, port=True)
    assert len(got) == len(want) and len(want) > 3
    assert [i for i, (a, b) in enumerate(zip(got, want)) if a != b] == []
    assert len(calls) == len(want)


def test_transient_reaches_short_blocks(monkeypatch):
    """aac_transient's signal takes the eight-short path: a (8 ch, 256)
    MDCT batch."""
    x = _transient(0.15, 1, 48000)
    shapes = []
    monkeypatch.setattr(aac_enc, "mdct",
                        lambda t: shapes.append(tuple(t.shape)) or
                        _jax_mdct(t))
    _encode("aac", x, 48000, {}, port=True)
    assert (8, 256) in shapes and (1, 2048) in shapes


# name -> (codec, channels, options, seconds): end to end, the port's
# own MDCT
END_TO_END = {
    "ac3_stereo": ("ac3", 2, {"bitrate_kbps": 192}, 1.0),
    "ac3_mono": ("ac3", 1, {"bitrate_kbps": 96}, 1.0),
    "aac_default": ("aac", 2, {}, 1.0),
    "aac_tns": ("aac", 2, {"tns": 1}, 0.6),
    "aac_ltp": ("aac", 1, {"ltp": 1}, 0.6),
}


@pytest.mark.parametrize("name", list(END_TO_END))
def test_encoder_end_to_end_bar(name, capsys):
    """The port's encoder with its own MDCT: as many packets as the JAX
    encoder; the count of packets that differ printed; the SNR of the
    port's packets within 0.05 dB of the JAX packets', both decoded by
    the port's decoder."""
    codec, ch, opts, seconds = END_TO_END[name]
    x = audio_signal(seconds, ch, 70 + len(name))
    fftmdct.mdct.calls = 0
    got = _encode(codec, x, 48000, opts, port=True)
    assert fftmdct.mdct.calls == len(got)
    want = _encode(codec, x, 48000, opts, port=False)
    assert len(got) == len(want)
    differ = sum(a != b for a, b in zip(got, want))
    snr_port = C.snr_db(x, _decode(codec, got, 48000), C.DELAY[codec])
    snr_jax = C.snr_db(x, _decode(codec, want, 48000), C.DELAY[codec])
    with capsys.disabled():
        print(f"\n{name}: {differ} of {len(want)} packets differ from the "
              f"JAX encoder's; SNR {snr_port:.4f} dB (port) against "
              f"{snr_jax:.4f} dB (JAX)")
    assert snr_jax > 10
    assert abs(snr_port - snr_jax) <= C.SNR_TOLERANCE_DB


def test_encoders_take_the_device():
    """The AAC and AC-3 encoders have a device part and take a device,
    "cuda" by default; the host encoders take none."""
    for codec in ("aac", "ac3"):
        cls = api.find_encoder(codec)
        assert cls.DEVICE_PART
        assert cls(device="cpu").device == torch.device("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                cls()
    for codec in ("mp1", "mp2", "mp3", "flac"):
        assert not api.find_encoder(codec).DEVICE_PART
        dec = api.find_decoder(codec)(device="cpu")
        assert dec.device == torch.device("cpu")


# ---------------------------------------------------------------------- #
# MP1/2/3 and FLAC: host code in both packages, exact
# ---------------------------------------------------------------------- #

# name -> (codec, channels, rate, options)
HOST_CODECS = {
    "mp1_stereo": ("mp1", 2, 48000, {}),
    "mp1_mono": ("mp1", 1, 48000, {"bit_rate_kbps": 192}),
    "mp2_stereo": ("mp2", 2, 48000, {}),
    "mp2_mono": ("mp2", 1, 32000, {}),
    "mp2_384k": ("mp2", 2, 44100, {"bit_rate_kbps": 384}),
    "mp3_stereo": ("mp3", 2, 48000, {"bit_rate_kbps": 320}),
    "mp3_js": ("mp3", 2, 44100, {"bit_rate_kbps": 320, "js": 1}),
    "mp3_mono": ("mp3", 1, 48000, {"bit_rate_kbps": 192}),
    "flac_stereo": ("flac", 2, 48000, {}),
    "flac_mono": ("flac", 1, 44100, {"frame_size": 1152}),
}


def _host_codec(name):
    codec, ch, rate, opts = HOST_CODECS[name]
    x = audio_signal(0.25, ch, 90 + len(name), rate)
    return codec, rate, _encode(codec, x, rate, opts, port=False), \
        _encode(codec, x, rate, opts, port=True)


@pytest.mark.parametrize("name", list(HOST_CODECS))
def test_host_audio_codec_matches_jax(name):
    """The JAX and port encoders give the same packets; the JAX decoder
    and the port's give the same PCM on them."""
    codec, rate, want, got = _host_codec(name)
    assert got == want and len(want) > 2
    ref = C.decode_back(jax_api, JPacket, codec, want, rate)
    out = _decode(codec, want, rate)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_mp3_granule_overflow_raises_like_jax():
    """Broadband audio at MP3's default 192 kbit/s: the JAX encoder
    raises EINVAL ("granule does not fit"), and so does the port."""
    x = audio_signal(0.2, 2, 3)
    with pytest.raises(JaxAVError, match="granule does not fit"):
        _encode("mp3", x, 48000, {}, port=False)
    with pytest.raises(AVError, match="granule does not fit") as e:
        _encode("mp3", x, 48000, {}, port=True)
    assert e.value.code == EINVAL


# ---------------------------------------------------------------------- #
# float_dsp and fifo
# ---------------------------------------------------------------------- #

def _vectors(seed, n=1027):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((3, n)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("op", ["vector_fmul", "vector_fmac_scalar",
                                "vector_fmul_scalar", "vector_fmul_add",
                                "vector_fmul_reverse", "vector_fmul_window",
                                "butterflies", "vector_clip"])
def test_float_dsp_matches_jax(op):
    """Each elementwise op of the port on tensors against the JAX op on
    jax arrays: equal float32 bits."""
    import jax.numpy as jnp
    a, b, c = _vectors(len(op))
    args = {"vector_fmul": (a, b), "vector_fmac_scalar": (a, b, 0.37),
            "vector_fmul_scalar": (a, 1.7), "vector_fmul_add": (a, b, c),
            "vector_fmul_reverse": (a, b),
            "vector_fmul_window": (a[:, :512], b[:, :512], c[:, :1024]),
            "butterflies": (a, b), "vector_clip": (a, -0.5, 0.75)}[op]

    def conv(v, f):
        return f(v) if isinstance(v, np.ndarray) else v
    want = getattr(jax_dsp, op)(*(conv(v, jnp.asarray) for v in args))
    got = getattr(float_dsp, op)(*(conv(v, torch.from_numpy) for v in args))
    if op == "butterflies":
        want, got = np.stack(want), torch.stack(got)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_float_dsp_scalarproduct_within_ulps():
    """scalarproduct: torch's sum order against XLA's, within 4 float32
    ulps of sum |a*b| per row."""
    import jax.numpy as jnp
    a, b, _ = _vectors(7, 4099)
    want = np.asarray(jax_dsp.scalarproduct(jnp.asarray(a), jnp.asarray(b)))
    got = float_dsp.scalarproduct(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy()
    scale = np.abs(a.astype(np.float64) * b).sum(axis=-1)
    assert np.all(np.abs(got.astype(np.float64) - want) <=
                  4 * np.spacing(scale.astype(np.float32)))


def test_float_dsp_runs_on_the_tensors_device():
    a, b, _ = (torch.from_numpy(v) for v in _vectors(3))
    out = float_dsp.vector_fmul_window(a[:, :8], b[:, :8], a[:, :16])
    assert out.device == a.device and out.shape == (3, 16)


def test_fifo_matches_jax():
    """The same operations on both packages' Fifo: the same answers."""
    ours, theirs = Fifo(), JaxFifo()
    trace = []
    for f in (ours, theirs):
        out = []
        for i in range(5):
            f.write(i * 3, size=2)
        out += [f.size(), len(f), f.peek(), f.read(), f.read(), f.size()]
        out.append(f.drain())
        out += [f.read(), f.peek(), f.size()]
        f.write("x")
        f.reset()
        out.append(len(f))
        trace.append(out)
    assert trace[0] == trace[1]


# ---------------------------------------------------------------------- #
# the slice through both avconvs, small
# ---------------------------------------------------------------------- #

def test_container_transcode_cli_matches_jax(tmp_path, capsys):
    """A 64x64 H.264 stream with 1 s of AAC muxed into MP4, then with
    1 s of AC-3 into Matroska and MPEG-TS, the three framecrc, and the
    Matroska file transcoded to MPEG-4 + AAC in MP4, through both CLIs:
    muxes and framecrc byte-identical (the AAC framecrc lines within
    their 1 LSB, ROADMAP.md §3, so the MP4's video lines only), the
    transcode's video packets identical, its AAC packets to the end-to-end
    bar."""
    x = audio_signal(1.0, 2, 33)
    files = {"bench.h264": open(testdata.SMALL_H264, "rb").read(),
             "aac_lc_48k.aac": encode_audio("aac", x, {"quality": 10}),
             "ac3_20_48k.ac3": encode_audio("ac3", x,
                                            {"bitrate_kbps": 192})}
    out = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        for f, data in files.items():
            (d / f).write_bytes(data)

        def run(*args):
            assert tool.main(C.in_dir(args, str(d)), **kw) == 0
        for o, args in C.MUX:
            run(*args, o)
        for o, args in C.FRAMECRC.items():
            run("-i", o, *args, "-f", "framecrc", str(d / (o + ".crc")))
        src, args, dst = C.TRANSCODE
        run("-i", src, *args, dst)
        out[name] = {f: (d / f).read_bytes() for f in
                     ("out.mp4", "out.mkv", "out.ts", "out.mkv.crc",
                      "out.ts.crc")}
        out[name]["mp4.crc"] = [ln for ln in
                                (d / "out.mp4.crc").read_text().splitlines()
                                if not ln.startswith("1,")]
        out[name]["video"] = C.read_stream(
            JFormatContext if name == "jax" else FormatContext,
            str(d / dst), "video")[1]
        out[name]["audio"] = C.read_stream(
            JFormatContext if name == "jax" else FormatContext,
            str(d / dst), "audio")
    for key in ("out.mp4", "out.mkv", "out.ts", "out.mkv.crc", "out.ts.crc",
                "mp4.crc"):
        assert out["port"][key] == out["jax"][key], key
    assert [bytes(p.data) for p in out["port"]["video"]] == \
        [bytes(p.data) for p in out["jax"]["video"]]
    assert len(out["jax"]["video"]) == 4
    (ppar, ppk), (jpar, jpk) = out["port"]["audio"], out["jax"]["audio"]
    assert bytes(ppar.extradata) == bytes(jpar.extradata)
    assert len(ppk) == len(jpk) > 40
    differ = sum(bytes(a.data) != bytes(b.data) for a, b in zip(ppk, jpk))
    src = C.decode_pcm(api, *C.read_stream(
        FormatContext, str(tmp_path / "port" / "out.mkv"), "audio"),
        device="cpu")
    snr_port = C.snr_db(src, C.decode_pcm(api, ppar, ppk, device="cpu"),
                        C.DELAY["aac"])
    snr_jax = C.snr_db(src, C.decode_pcm(api, ppar, [
        Packet(data=bytes(p.data)) for p in jpk], device="cpu"),
        C.DELAY["aac"])
    with capsys.disabled():
        print(f"\ntranscode AAC: {differ} of {len(jpk)} packets differ; "
              f"SNR {snr_port:.4f} dB (port) against {snr_jax:.4f} (JAX)")
    assert snr_jax > 10
    assert abs(snr_port - snr_jax) <= C.SNR_TOLERANCE_DB
