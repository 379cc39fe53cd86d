"""The container and audio-encode path's runs and goldens (`chip_smoke.py`
phase 15, `tests/test_torch_audio_encode.py`).

Both packages go through the same runs: the JAX package on the CPU when
`tools/gen_torch_smoke_stream.py containers` writes the goldens, the port
on the card in the smoke run. Every input is a committed stream:

  MUX        the port's avconv muxes, with `-c copy`, the committed
             1080p H.264 stream (bench.h264) and the ADTS AAC-LC stream
             into out.mp4, then out.mp4's video and the stereo AC-3
             stream into out.mkv and out.ts (raw H.264 has no container
             timestamps, which the Matroska muxer cannot take, so both
             take the MP4's);
  FRAMECRC   `-f framecrc` on each (video copied for MKV and TS, the
             audio decoded);
  MP4_PCM    out.mp4's AAC decoded to s16 at 44.1 kHz, which is the
             committed `aac_lc_48k.s16.zlib` (config 5);
  TRANSCODE  out.mkv to MPEG-4 video and AAC audio in out2.mp4;
  ENCODES    the first SOURCE_SECONDS of the stereo AC-3 stream, decoded
             (fltp), through the MP1/MP2/MP3/FLAC encoders and back
             through their decoders; AC3 the same PCM through the AC-3
             encoder.

The JAX package's AAC packets of the transcode and its AC-3 packets are
committed too (`read_packets` format), so that the port's decoder can
decode both packet streams on one device for the SNR bar: the AAC and
AC-3 encoders' MDCT is a float32 matrix product whose sums round apart
from XLA's, so their packets are held by count, by how many differ, and
by SNR against the source within SNR_TOLERANCE_DB of the JAX packets'.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Sequence

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "containers.golden.json")
JAX_PACKETS = {"aac": os.path.join(HERE, "transcode_aac.jax.pkts"),
               "ac3": os.path.join(HERE, "encode_ac3.jax.pkts")}

# (output file, the argv before it); inputs by their CLI file names
MUX = (
    ("out.mp4", ("-i", "bench.h264", "-i", "aac_lc_48k.aac",
                 "-map", "0:0", "-map", "1:0", "-c", "copy")),
    ("out.mkv", ("-i", "out.mp4", "-i", "ac3_20_48k.ac3",
                 "-map", "0:0", "-map", "1:0", "-c", "copy")),
    ("out.ts", ("-i", "out.mp4", "-i", "ac3_20_48k.ac3",
                "-map", "0:0", "-map", "1:0", "-c", "copy")),
)
FRAMECRC = {"out.mp4": (), "out.mkv": ("-c:v", "copy", "-t", "3"),
            "out.ts": ("-c:v", "copy", "-t", "3")}
MP4_PCM = ("-vn", "-ar", "44100", "-f", "s16le")
TRANSCODE = ("out.mkv", ("-t", "3", "-c:v", "mpeg4", "-q:v", "6", "-g", "12",
                         "-bf", "2", "-c:a", "aac"), "out2.mp4")
SOURCE = "ac3_20_48k"
SOURCE_SECONDS = 3.0
# run -> (codec, encoder options); MP3 at its default 192 kbit/s cannot
# fit this broadband signal's granules (EINVAL in both packages)
ENCODES = {
    "mp2": ("mp2", {}),
    "mp1": ("mp1", {}),
    "mp3": ("mp3", {"bit_rate_kbps": 320}),
    "mp3_js": ("mp3", {"bit_rate_kbps": 320, "js": 1}),
    "flac": ("flac", {}),
}
AC3 = ("ac3", {"bitrate_kbps": 192})
# decoder output lag behind the encoder input (TDAC), in samples
DELAY = {"ac3": 256, "aac": 1024}
SNR_TOLERANCE_DB = 0.05


# the runs' CLI input files -> the committed stream each is written from
INPUTS = {"bench.h264": "h264_1080p_ipbb_cabac",
          "aac_lc_48k.aac": "aac_lc_48k", "ac3_20_48k.ac3": "ac3_20_48k"}
OUTPUTS = ("out.mp4", "out.mkv", "out.ts", "out2.mp4")


def write_inputs(work: str) -> None:
    """Write INPUTS into directory work."""
    import shutil
    from libav_tpu_torch import testdata
    for name, stream in INPUTS.items():
        if stream in testdata.CLI_INPUTS:
            testdata.write_cli_input(stream, work)
        else:
            shutil.copyfile(testdata.audio_path(stream),
                            os.path.join(work, name))


def in_dir(args: Sequence[str], work: str) -> List[str]:
    """args with every CLI file name of the runs put in directory work."""
    return [os.path.join(work, a) if a in INPUTS or a in OUTPUTS else a
            for a in args]


def framecrc_path(output: str) -> str:
    """The JAX CLI's framecrc of one of MUX's outputs."""
    return os.path.join(HERE, "container_" + output.split(".")[1] +
                        ".framecrc")


def md5(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


def read_stream(FormatContext, path: str, codec_type: str):
    """(codecpar, packets) of the first stream of codec_type in a file,
    through a package's demuxer."""
    ic = FormatContext.open_input(path)
    try:
        st = next(s for s in ic.streams
                  if s.codecpar.codec_type == codec_type)
        pkts = [p for p in ic.packets() if p.stream_index == st.index]
    finally:
        ic.close()
    return st.codecpar, pkts


def decode_pcm(api, params, packets, **kw) -> np.ndarray:
    """(planes, n) PCM of packets through a package's decoder, in the
    decoder's sample format (`kw`: the port's device)."""
    dec = api.find_decoder(params.codec_id)(params, **kw).open()
    frames = dec.decode_all(packets)
    return np.concatenate([np.stack([np.asarray(p) for p in f.planes])
                           for f in frames], axis=1)


def source_pcm(api, FormatContext, path: str, **kw) -> np.ndarray:
    """The first SOURCE_SECONDS of the stereo AC-3 stream at path,
    decoded: (2, n) float32, n a whole number of AC-3 frames."""
    par, pkts = read_stream(FormatContext, path, api.MediaType.AUDIO)
    n = int(np.ceil(SOURCE_SECONDS * 48000 / 1536))
    return decode_pcm(api, par, pkts[:n], **kw)


def audio_frames(Frame, pcm: np.ndarray, codec: str, rate: int = 48000):
    """pcm as the frames an encoder takes: fltp of 1536 samples, or
    interleaved s16 for FLAC (round half even, clipped)."""
    out = []
    for i in range(0, pcm.shape[1], 1536):
        x = pcm[:, i:i + 1536]
        if codec == "flac":
            f = Frame(nb_samples=x.shape[1], sample_rate=rate, format="s16",
                      channels=x.shape[0])
            f.planes = [np.clip(np.rint(x.T * 32768.0), -32768, 32767)
                        .astype(np.int16).reshape(-1)]
        else:
            f = Frame(nb_samples=x.shape[1], sample_rate=rate,
                      format="fltp", channels=x.shape[0])
            f.planes = [np.ascontiguousarray(c) for c in x]
        out.append(f)
    return out


def encode(api, Frame, codec: str, opts: Dict, pcm: np.ndarray,
           rate: int = 48000, **kw) -> List[bytes]:
    """pcm at `rate` through a package's encoder (`kw`: the port's device
    for the AAC and AC-3 encoders): the packets' bytes, a FLAC stream's
    header first."""
    par = api.CodecParameters(codec_type=api.MediaType.AUDIO,
                              codec_id=codec, sample_rate=rate,
                              channels=pcm.shape[0],
                              sample_fmt="s16" if codec == "flac"
                              else "fltp")
    cls = api.find_encoder(codec)
    enc = cls(par, **kw) if getattr(cls, "DEVICE_PART", False) else cls(par)
    for k, v in opts.items():
        enc.set_opt(k, v)
    datas = [bytes(p.data) for p in
             enc.encode_all(audio_frames(Frame, pcm, codec, rate))]
    return [enc.header_bytes()] + datas if codec == "flac" else datas


def decode_back(api, Packet, codec: str, datas: Sequence[bytes],
                rate: int = 48000, **kw) -> np.ndarray:
    """The packets of `encode` through the package's decoder."""
    par = api.CodecParameters(codec_type=api.MediaType.AUDIO,
                              codec_id=codec, sample_rate=rate)
    return decode_pcm(api, par, [Packet(data=d) for d in datas], **kw)


def snr_db(src: np.ndarray, got: np.ndarray, delay: int) -> float:
    """SNR in dB of decoded PCM against the encoder's source, got lagging
    src by `delay` samples, over the samples both cover less one
    transform block at each end."""
    n = min(src.shape[1], got.shape[1] - delay)
    ref = src[:, delay:n - delay].astype(np.float64)
    dec = got[:, 2 * delay:n].astype(np.float64)
    err = ((ref - dec) ** 2).mean()
    return float(10 * np.log10((ref ** 2).mean() / max(err, 1e-30)))


def pcm_md5(pcm: np.ndarray) -> str:
    return md5(np.ascontiguousarray(pcm).tobytes())
