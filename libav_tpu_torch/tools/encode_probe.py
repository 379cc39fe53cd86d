"""Helpers that time the MPEG-4 encoder on the committed 1080p IPB
stream, for chip_smoke.py's phase 10: `decode_source` decodes
`mpeg2_1080p_ipbb` (7 frames, 1920x1080) with the port's MPEG-2 decoder
on a device, `encode` runs the frames through MPEG4Encoder where they
lie (seconds, packets, optionally the anchors' reconstructions), and
`stages` times each stage of the encodes run inside it, synchronised
before and after: the P and B motion searches, FDCT + quant, the anchor
recon, the download for the packer, and host packing of I/P and of B
VOPs.
"""

from __future__ import annotations

import contextlib
import hashlib
import time

import torch

from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs import mpegvideo
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.codecs.mpeg12 import MPEG2Decoder
from libav_tpu_torch.codecs.mpeg4.enc import MPEG4Encoder
from libav_tpu_torch.ops.mc import EDGE


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_source(dev: torch.device):
    """The committed IPB stream decoded on dev: (frames, seconds)."""
    datas = testdata.read_packets(
        testdata.stream_paths(testdata.MPEG4_SOURCE)[0])
    sync(dev)
    t0 = time.perf_counter()
    frames = MPEG2Decoder(device=dev).decode_all(
        Packet(data=d, pts=i) for i, d in enumerate(datas))
    sync(dev)
    return frames, time.perf_counter() - t0


def encode(dev: torch.device, frames, settings, anchors=None):
    """frames through MPEG4Encoder on dev once: (packet bytes, seconds).
    With a list for anchors, each anchor's reconstructed coded (Y, U, V)
    planes are appended to it, on the host."""
    f0 = frames[0]
    enc = MPEG4Encoder(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="mpeg4", width=f0.width,
        height=f0.height, pix_fmt="yuv420p"), device=dev)
    for k, v in settings.items():
        enc.set_opt(k, v)
    if anchors is not None:
        code_anchor = enc._code_anchor

        def recorded(*args):
            pkt = code_anchor(*args)
            anchors.append([p[EDGE:-EDGE, EDGE:-EDGE].cpu().numpy()
                            for p in enc._refs])
            return pkt
        enc._code_anchor = recorded
    sync(dev)
    t0 = time.perf_counter()
    datas = [p.data for p in enc.encode_all(frames)]
    sync(dev)
    return datas, time.perf_counter() - t0


def packet_digests(datas):
    return [{"size": len(d), "md5": hashlib.md5(d).hexdigest()}
            for d in datas]


@contextlib.contextmanager
def stages(dev: torch.device):
    """Inside, the encoder's stages are timed, each synchronised before
    and after: yields {stage: [ms per call]}. Measurement only. It
    replaces methods of the classes for the whole process, so every
    encode or decode that runs inside (a decode's Recon too) is timed and
    synchronised: use it with nothing else running."""
    out = {}

    def search(module, *args):
        return ("P search (full + half pel)"
                if isinstance(module, mpegvideo.Encode)
                else "B search (full + half pel), per direction")
    patches = [(mpegvideo._EncodePicture, "motion", search),
               (mpegvideo._EncodePicture, "quantize", "FDCT + quant"),
               (mpegvideo.Recon, "forward", "anchor recon (one K2 launch)"),
               (MPEG4Encoder, "_download", "levels/MV/intra download"),
               (MPEG4Encoder, "_pack", "I/P host packing"),
               (MPEG4Encoder, "_b_layer", "B host packing")]
    saved = []
    for cls, name, label in patches:
        inner = cls.__dict__[name]
        saved.append((cls, name, inner))
        fn = inner.__func__ if isinstance(inner, staticmethod) else inner

        def timed(*args, _fn=fn, _label=label, **kw):
            sync(dev)
            t0 = time.perf_counter()
            result = _fn(*args, **kw)
            sync(dev)
            key = _label(*args) if callable(_label) else _label
            out.setdefault(key, []).append(1e3 * (time.perf_counter() - t0))
            return result
        setattr(cls, name, staticmethod(timed)
                if isinstance(inner, staticmethod) else timed)
    try:
        yield out
    finally:
        for cls, name, inner in saved:
            setattr(cls, name, inner)
