"""Parsers: packetize raw byte streams into frame-sized packets
(reference: libavcodec/parser.c:316 av_parser_parse2 + the ~35 per-codec
parsers — h264_parser.c, mpeg4video_parser.c, aac_parser.c, ac3_parser.c,
mpegvideo parser).

The raw-format demuxers use the same split functions; this module exposes
them behind the AVCodecParser-style push API for callers that feed
arbitrary byte chunks. The port's copy holds the parsers of the video
codecs it decodes (MPEG-1/2 video, MPEG-4 part 2, H.264); the AC-3 and
AAC streams are split by their demuxers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Type

from libav_tpu_torch.avutil.error import AVError

_PARSERS: Dict[str, Type["Parser"]] = {}


def register_parser(cls):
    _PARSERS[cls.NAME] = cls
    return cls


def find_parser(codec_id: str) -> Optional[Type["Parser"]]:
    return _PARSERS.get(codec_id)


class Parser:
    """reference: avcodec.h:4410 AVCodecParser (push bytes, pop frames)."""

    NAME = "none"

    def __init__(self):
        self._buf = bytearray()

    def parse(self, data: bytes, eof: bool = False) -> List[bytes]:
        """Feed bytes; returns zero or more complete frames."""
        self._buf += data
        frames, consumed = self._split(bytes(self._buf), eof)
        del self._buf[:consumed]
        return frames

    def _split(self, buf: bytes, eof: bool) -> Tuple[List[bytes], int]:
        raise NotImplementedError


def _chunked_split(chunks: List[bytes], buf: bytes, eof: bool):
    """Common logic: a splitter produced complete chunks covering a prefix
    of buf; hold the last one back unless eof."""
    if not chunks:
        return [], 0
    if not eof:
        held = chunks.pop()
        consumed = len(buf) - len(held)
        return chunks, consumed
    return chunks, len(buf)


@register_parser
class MpegVideoParser(Parser):
    """reference: mpegvideo_parser.c — split at picture start codes."""
    NAME = "mpeg1video"

    def _split(self, buf, eof):
        from libav_tpu_torch.formats.mpegvideo_raw import split_pictures
        return _chunked_split(list(split_pictures(buf)), buf, eof)


@register_parser
class Mpeg2VideoParser(MpegVideoParser):
    NAME = "mpeg2video"


@register_parser
class MPEG4VideoParser(Parser):
    """reference: mpeg4video_parser.c — split at VOP start codes."""
    NAME = "mpeg4"

    def _split(self, buf, eof):
        from libav_tpu_torch.formats.m4v import split_vops
        return _chunked_split(list(split_vops(buf)), buf, eof)


@register_parser
class H264Parser(Parser):
    """reference: h264_parser.c — split at access-unit boundaries."""
    NAME = "h264"

    def _split(self, buf, eof):
        from libav_tpu_torch.formats.h264raw import split_access_units
        return _chunked_split(list(split_access_units(buf)), buf, eof)
