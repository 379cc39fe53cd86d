"""Public codec API: decoupled send/receive with draining semantics
(reference: libavcodec/avcodec.h:80-135 API doc, decode.c:441
avcodec_send_packet, decode.c:500 avcodec_receive_frame, encode.c:296
avcodec_send_frame, utils.c:343 avcodec_open2, allcodecs.c:54 registry).

State machine contract (same as the reference):
  send_packet(pkt)   -> may raise AVError(EAGAIN) if output must be drained
  receive_frame()    -> Frame | AGAIN (need more input) | EOF (drained)
  send_packet(None)  -> enter draining mode
  flush()            -> reset for seeking (avcodec.h:2959 AVCodec.flush)
"""

from __future__ import annotations

import struct
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Type

from libav_tpu_torch.avutil import log
from libav_tpu_torch.avutil.error import (AVError, EAGAIN, EINVAL, EOF_,
                                    DECODER_NOT_FOUND, ENCODER_NOT_FOUND)
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.avutil.opt import Option, OptionedObject
from libav_tpu_torch.avutil.rational import Rational


class MediaType:
    """reference: avutil.h AVMediaType"""
    VIDEO = "video"
    AUDIO = "audio"
    DATA = "data"
    SUBTITLE = "subtitle"


@dataclass
class CodecParameters:
    """reference: avcodec.h:3265 AVCodecParameters — the codec properties a
    container carries, used to open a matching decoder."""
    codec_type: str = MediaType.DATA
    codec_id: str = "none"
    codec_tag: int = 0
    extradata: bytes = b""
    bit_rate: int = 0
    # video
    width: int = 0
    height: int = 0
    pix_fmt: str = "none"
    sample_aspect_ratio: Rational = field(default_factory=lambda: Rational(0, 1))
    field_order: str = "progressive"
    framerate: Rational = field(default_factory=lambda: Rational(0, 1))
    # audio
    sample_fmt: str = "none"
    sample_rate: int = 0
    channels: int = 0
    channel_layout: int = 0
    frame_size: int = 0
    block_align: int = 0


# ---------------------------------------------------------------------- #
# Registry: the port's own codec table (reference: allcodecs.c:38-45
# REGISTER_DECODER/ENCODER macros); nothing of the JAX package runs in
# its place.
# ---------------------------------------------------------------------- #

_DECODERS: Dict[str, Type["Decoder"]] = {}
_ENCODERS: Dict[str, Type["Encoder"]] = {}


def register_codec(cls):
    """Class decorator; cls must define NAME (codec id) and is a Decoder or
    Encoder subclass."""
    if issubclass(cls, Decoder):
        _DECODERS[cls.NAME] = cls
        for alias in getattr(cls, "ALIASES", ()):
            _DECODERS[alias] = cls
    elif issubclass(cls, Encoder):
        _ENCODERS[cls.NAME] = cls
        for alias in getattr(cls, "ALIASES", ()):
            _ENCODERS[alias] = cls
    else:
        raise TypeError(cls)
    return cls


def find_decoder(codec_id: str) -> Type["Decoder"]:
    """reference: avcodec.h avcodec_find_decoder. The port's decoders take
    their torch device as a keyword: cls(params, device=...), "cuda" by
    default."""
    if codec_id not in _DECODERS:
        raise AVError(DECODER_NOT_FOUND, codec_id)
    return _DECODERS[codec_id]


def find_encoder(codec_id: str) -> Type["Encoder"]:
    """reference: avcodec.h avcodec_find_encoder. An encoder whose
    DEVICE_PART is set takes its torch device as a keyword:
    cls(params, device=...)."""
    if codec_id not in _ENCODERS:
        raise AVError(ENCODER_NOT_FOUND, codec_id)
    return _ENCODERS[codec_id]


def list_decoders() -> List[str]:
    return sorted(_DECODERS)


def list_encoders() -> List[str]:
    return sorted(_ENCODERS)


# ---------------------------------------------------------------------- #
# Context
# ---------------------------------------------------------------------- #

# codec flags (reference: avcodec.h AV_CODEC_FLAG_*)
FLAG_BITEXACT = 1 << 23
FLAG_QSCALE = 1 << 1
FLAG_PASS1 = 1 << 9
FLAG_PASS2 = 1 << 10
FLAG_GRAY = 1 << 13
FLAG_INTERLACED_DCT = 1 << 18
FLAG_LOW_DELAY = 1 << 19


class CodecContext(OptionedObject):
    """reference: avcodec.h:1216 AVCodecContext.

    Base for Decoder and Encoder. Subclasses implement the internal
    _decode(pkt)->[Frame] or _encode(frame)->[Packet] plus optional
    _drain() for delayed output.
    """

    NAME = "none"
    TYPE = MediaType.VIDEO
    LONG_NAME = ""
    CAPABILITIES: tuple = ()   # e.g. ("delay",) if codec buffers output

    OPTIONS = [
        Option("flags", "codec flags", "flags", 0, unit="avflags"),
        Option("bitexact", "", "const", unit="avflags", const_value=FLAG_BITEXACT),
        Option("gray", "", "const", unit="avflags", const_value=FLAG_GRAY),
        Option("threads", "host worker threads", "int", 1, 0, 64),
        Option("bit_rate", "bitrate", "int64", 0, 0, 2 ** 50),
        Option("batch", "device frame batch size", "int", 1, 1, 512),
    ]

    def __init__(self, params: Optional[CodecParameters] = None,
                 options: Optional[Dict[str, Any]] = None):
        self.init_defaults()
        self.params = params or CodecParameters()
        self.width = self.params.width
        self.height = self.params.height
        self.pix_fmt = self.params.pix_fmt
        self.sample_fmt = self.params.sample_fmt
        self.sample_rate = self.params.sample_rate
        self.channels = self.params.channels
        self.channel_layout = self.params.channel_layout
        self.extradata = self.params.extradata
        self.time_base = Rational(0, 1)
        self.framerate = self.params.framerate
        self.frame_number = 0
        self._opened = False
        self._draining = False
        self._eof_sent = False
        self._out: deque = deque()
        if options:
            self.set_opts(options)

    # -- lifecycle ------------------------------------------------------ #

    def open(self):
        """reference: utils.c:343 avcodec_open2"""
        if not self._opened:
            self._init()
            self._opened = True
        return self

    def _init(self):
        pass

    def close(self):
        self._opened = False

    def flush(self):
        """reference: avcodec.h:2959 flush callback (seek support)"""
        self._out.clear()
        self._draining = False
        self._eof_sent = False
        self._flush()

    def _flush(self):
        pass

    @property
    def log_name(self):
        return self.NAME


class Decoder(CodecContext):
    """reference: decode.c send/receive implementation"""

    def send_packet(self, pkt: Optional[Packet]):
        """reference: decode.c:441 avcodec_send_packet. pkt=None drains."""
        if not self._opened:
            self.open()
        from libav_tpu_torch.avutil.rational import NOPTS_VALUE
        if pkt is None:
            if self._draining:
                raise AVError(EINVAL, "already draining")
            self._draining = True
            for f in self._drain():
                # flushed frames have no triggering packet
                f.pkt_dts = NOPTS_VALUE
                self._out.append(f)
            return
        if self._draining:
            raise AVError(EINVAL, "send after drain")
        try:
            frames = self._decode(pkt)
        except AVError:
            raise
        except (IndexError, ValueError, KeyError, OverflowError,
                struct.error) as e:
            # corrupt input must surface as INVALIDDATA, never as a raw
            # parser exception (reference: err_recognition / AV_EF_EXPLODE
            # semantics — decoders return AVERROR_INVALIDDATA on garbage)
            from libav_tpu_torch.avutil.error import INVALIDDATA
            log.warning(self, "decode error on corrupt input: %s", e)
            raise AVError(INVALIDDATA, str(e))
        for f in frames:
            # dts of the packet whose decode RETURNED the frame — for
            # reorder-delayed decoders this is a later packet than the
            # one the frame was coded in (reference decode.c sets
            # frame->pkt_dts the same way; avconv's pts guessing and
            # raw-ES timestamp parity depend on it)
            f.pkt_dts = pkt.dts
            self._out.append(f)

    def receive_frame(self):
        """reference: decode.c:500 avcodec_receive_frame.
        Returns a Frame, or raises AVError(EAGAIN)/AVError(EOF_)."""
        if self._out:
            f = self._out.popleft()
            self.frame_number += 1
            return f
        if self._draining:
            raise AVError(EOF_)
        raise AVError(EAGAIN)

    def decode_all(self, packets) -> List[Frame]:
        """Convenience: run the full state machine over an iterable."""
        frames = []
        for pkt in packets:
            self.send_packet(pkt)
            frames.extend(self._pump())
        self.send_packet(None)
        frames.extend(self._pump(drain=True))
        return frames

    def _pump(self, drain=False):
        out = []
        while True:
            try:
                out.append(self.receive_frame())
            except AVError as e:
                if e.code == EAGAIN or e.code == EOF_:
                    break
                raise
        return out

    # subclass interface
    def _decode(self, pkt: Packet) -> List[Frame]:
        raise NotImplementedError

    def _drain(self) -> List[Frame]:
        return []


class Encoder(CodecContext):
    """reference: encode.c:296 avcodec_send_frame path"""

    # True for an encoder with device programs: its constructor takes
    # device= (the host encoders, rawvideo and pcm_*, take none)
    DEVICE_PART = False

    def send_frame(self, frame: Optional[Frame]):
        if not self._opened:
            self.open()
        if frame is None:
            if self._draining:
                raise AVError(EINVAL, "already draining")
            self._draining = True
            for p in self._drain():
                self._out.append(p)
            return
        if self._draining:
            raise AVError(EINVAL, "send after drain")
        for p in self._encode(frame):
            self._out.append(p)

    def receive_packet(self) -> Packet:
        if self._out:
            p = self._out.popleft()
            self.frame_number += 1
            return p
        if self._draining:
            raise AVError(EOF_)
        raise AVError(EAGAIN)

    def encode_all(self, frames) -> List[Packet]:
        pkts = []
        for f in frames:
            self.send_frame(f)
            pkts.extend(self._pump())
        self.send_frame(None)
        pkts.extend(self._pump())
        return pkts

    def _pump(self):
        out = []
        while True:
            try:
                out.append(self.receive_packet())
            except AVError as e:
                if e.code in (EAGAIN, EOF_):
                    break
                raise
        return out

    def _encode(self, frame: Frame) -> List[Packet]:
        raise NotImplementedError

    def _drain(self) -> List[Packet]:
        return []
