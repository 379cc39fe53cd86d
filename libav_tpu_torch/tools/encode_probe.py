"""Helpers that time the port's encoders, for chip_smoke.py's phases 10
(MPEG-4, on the committed 1080p IPB stream), 17 (MPEG-1/2, on the moving
test pattern) and 18 (H.264 and MJPEG, on the pattern): `decode_source`
decodes `mpeg2_1080p_ipbb` (7 frames, 1920x1080) with the port's MPEG-2
decoder on a device, `pattern_frames` puts frames of `testdata.pattern`
on a device, `encode` runs frames through an encoder (MPEG4Encoder by
default, or the MPEG-1/2, H.264 and MJPEG ones) where they lie (seconds,
packets, optionally the anchors' reconstructions), and `stages` times
each stage of the encodes run inside it, synchronised before and after:
for MPEG-1/2/4 the P and B motion searches (and the MPEG-2 field
search), FDCT + quant, the anchor recon, the download for the packer,
and host packing of I/P and of B pictures; for H.264 the intra
wavefront, the P and B search + transform/quant programs, the download,
the host packing (slice headers and CABAC/CAVLC), the closed-loop
reference (upload, recon and deblock) and in it kernel K1 alone.
"""

from __future__ import annotations

import contextlib
import hashlib
import time

import torch

from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs import mpegvideo
from libav_tpu_torch.codecs.api import (CodecParameters, MediaType,
                                        find_encoder)
from libav_tpu_torch.codecs.h264 import device as h264device
from libav_tpu_torch.codecs.h264 import encdev
from libav_tpu_torch.codecs.h264.enc import H264Encoder
from libav_tpu_torch.codecs.mpeg12 import MPEG1Encoder, MPEG2Decoder
from libav_tpu_torch.codecs.mpeg4.enc import MPEG4Encoder
from libav_tpu_torch.ops import h264deblock
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


def pattern_frames(dev: torch.device, width: int, height: int, n: int,
                   pix_fmt: str = "yuv420p"):
    """Frames 0..n-1 of testdata.pattern, their planes uint8 tensors on
    dev."""
    out = []
    for t in range(n):
        f = Frame(width=width, height=height, format=pix_fmt)
        f.planes = [torch.as_tensor(p).to(dev)
                    for p in testdata.pattern(width, height, t)]
        f.pts = t
        out.append(f)
    return out


def encode(dev: torch.device, frames, settings, anchors=None,
           codec: str = "mpeg4", encoders=None):
    """frames through the port's encoder of codec (MPEG4Encoder, or
    MPEG1Encoder / MPEG2Encoder / H264Encoder / MJPEGEncoder at 25 fps)
    on dev once: (packet bytes, seconds). With a list for anchors, each
    anchor's reconstructed coded (Y, U, V) planes are appended to it, on
    the host; with a list for encoders, the encoder is appended to it."""
    f0 = frames[0]
    par = CodecParameters(
        codec_type=MediaType.VIDEO, codec_id=codec, width=f0.width,
        height=f0.height, pix_fmt=f0.format)
    if codec != "mpeg4":
        par.framerate = Rational(25, 1)
    enc = find_encoder(codec)(par, device=dev)
    if encoders is not None:
        encoders.append(enc)
    for k, v in settings.items():
        enc.set_opt(k, v)
    if anchors is not None:
        hook = "_code_anchor" if codec == "mpeg4" else "_encode_anchor"
        code_anchor = getattr(enc, hook)

        def recorded(*args):
            pkt = code_anchor(*args)
            anchors.append([p[EDGE:-EDGE, EDGE:-EDGE].cpu().numpy()
                            for p in enc._refs])
            return pkt
        setattr(enc, hook, recorded)
    sync(dev)
    t0 = time.perf_counter()
    datas = [p.data for p in enc.encode_all(frames)]
    sync(dev)
    return datas, time.perf_counter() - t0


def packet_digests(datas):
    return [{"size": len(d), "md5": hashlib.md5(d).hexdigest()}
            for d in datas]


@contextlib.contextmanager
def stages(dev: torch.device, codec: str = "mpeg4"):
    """Inside, the stages of codec's encoder (the MPEG-4 one, or the
    MPEG-1/2 ones) are timed, each synchronised before and after: yields
    {stage: [ms per call]}. Measurement only. It replaces methods of the
    classes for the whole process, so every encode or decode that runs
    inside (a decode's Recon too) is timed and synchronised: use it with
    nothing else running."""
    out = {}
    if codec == "h264":
        with _h264_stages(dev, out):
            yield out
        return

    def search(module, *args):
        if isinstance(module, mpegvideo.EncodeFieldStress):
            return "P field search (full + half pel)"
        return ("P search (full + half pel)"
                if isinstance(module, mpegvideo.Encode)
                else "B search (full + half pel), per direction")
    def recon(module, *args):
        return ("field recon (one K2 launch)"
                if isinstance(module, mpegvideo.ReconField)
                else "anchor recon (one K2 launch)")
    patches = [(mpegvideo._EncodePicture, "motion", search),
               (mpegvideo._EncodePicture, "quantize", "FDCT + quant"),
               (mpegvideo._Recon, "forward", recon)]
    if codec == "mpeg4":
        patches += [(MPEG4Encoder, "_download", "levels/MV/intra download"),
                    (MPEG4Encoder, "_pack", "I/P host packing"),
                    (MPEG4Encoder, "_b_layer", "B host packing")]
    else:
        patches += [(MPEG1Encoder, "_download", "levels/MV/intra download"),
                    (MPEG1Encoder, "_pack", "I/P host packing"),
                    (MPEG1Encoder, "_slices_b", "B host packing")]
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


K1_LABEL = "K1 h264_deblock_frame (synchronised)"


@contextlib.contextmanager
def _h264_stages(dev: torch.device, out):
    """stages() for the H.264 encoder: each program, the download, the
    host packing and the closed-loop reference; in the reference's
    deblock, K1's launch alone (the run the module passes it)."""
    def timer(label, fn):
        def timed(*args, **kw):
            sync(dev)
            t0 = time.perf_counter()
            result = fn(*args, **kw)
            sync(dev)
            out.setdefault(label(*args) if callable(label) else label,
                           []).append(1e3 * (time.perf_counter() - t0))
            return result
        return timed

    def wavefront(module, *args):
        return f"I wavefront ({type(module).__name__})"

    patches = [(encdev.EncodeI16, "forward", wavefront),
               (encdev.EncodeI4, "forward", wavefront),
               (encdev.EncodeI8, "forward", wavefront),
               (encdev.EncodeP, "forward", "P search + transform/quant"),
               (encdev.EncodeB, "forward", "B search + transform/quant"),
               (H264Encoder, "_download", "levels/modes/MV download"),
               (H264Encoder, "_emit_slices",
                "host packing (slice headers + entropy)"),
               (H264Encoder, "_update_ref_from_levels",
                "closed-loop reference (upload, recon, deblock)")]
    saved = []
    for cls, name, label in patches:
        inner = cls.__dict__[name]
        saved.append((cls, name, inner))
        fn = inner.__func__ if isinstance(inner, staticmethod) else inner
        wrapped = timer(label, fn)
        setattr(cls, name, staticmethod(wrapped)
                if isinstance(inner, staticmethod) else wrapped)
    deblock_fwd = h264device.ReconH264Deblock.forward

    def forward(self, *args, run=h264deblock.h264_deblock_frame, **kw):
        return deblock_fwd(self, *args, run=timer(K1_LABEL, run), **kw)
    h264device.ReconH264Deblock.forward = forward
    saved.append((h264device.ReconH264Deblock, "forward", deblock_fwd))
    try:
        yield out
    finally:
        for cls, name, inner in saved:
            setattr(cls, name, inner)
