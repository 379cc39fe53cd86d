"""Format (de)mux core (reference: libavformat/utils.c:284
avformat_open_input, :1021 av_read_frame, :2200 avformat_find_stream_info;
mux.c:234 avformat_write_header, :644 av_interleaved_write_frame;
avformat.h:912 AVFormatContext, :686 AVStream, :505 AVInputFormat, :430
AVOutputFormat).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Type

from libav_tpu_torch.avutil import log
from libav_tpu_torch.avutil.error import (AVError, DEMUXER_NOT_FOUND, EAGAIN, EOF_,
                                    EINVAL, MUXER_NOT_FOUND, INVALIDDATA)
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.avutil.opt import OptionedObject
from libav_tpu_torch.avutil.rational import NOPTS_VALUE, Rational, rescale_q
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.io import IOContext, url_open


@dataclass
class Stream:
    """reference: avformat.h:686 AVStream"""
    index: int = 0
    id: int = 0
    codecpar: CodecParameters = field(default_factory=CodecParameters)
    time_base: Rational = field(default_factory=lambda: Rational(1, 90000))
    start_time: int = NOPTS_VALUE
    duration: int = NOPTS_VALUE
    nb_frames: int = 0
    avg_frame_rate: Rational = field(default_factory=lambda: Rational(0, 1))
    metadata: Dict[str, str] = field(default_factory=dict)
    # demuxer requests frame-boundary parsing (reference: AVStream
    # need_parsing + utils.c:816 parse_packet)
    need_parsing: bool = False
    # mux state (reference: mux.c dts continuity checks)
    cur_dts: int = NOPTS_VALUE
    # mux interleave: stream has no more packets coming (reference:
    # mux.c:644 flush semantics for EOF-ed streams)
    eof: bool = False
    # index for seeking (reference: avformat.h:644 AVIndexEntry)
    index_entries: List[Tuple[int, int, int]] = field(default_factory=list)
    # (timestamp, pos, flags)


# ---------------------------------------------------------------------- #
# Registries (reference: allformats.c)
# ---------------------------------------------------------------------- #

_INPUT_FORMATS: Dict[str, Type["InputFormat"]] = {}
_OUTPUT_FORMATS: Dict[str, Type["OutputFormat"]] = {}


def register_input(cls):
    _INPUT_FORMATS[cls.NAME] = cls
    return cls


def register_output(cls):
    _OUTPUT_FORMATS[cls.NAME] = cls
    return cls


def find_input_format(name: str) -> Type["InputFormat"]:
    for key, cls in _INPUT_FORMATS.items():
        if name in key.split(","):
            return cls
    raise AVError(DEMUXER_NOT_FOUND, name)


def guess_format(name: Optional[str] = None, url: Optional[str] = None):
    """reference: avformat.h av_guess_format"""
    if name:
        for key, cls in _OUTPUT_FORMATS.items():
            if name in key.split(","):
                return cls
        raise AVError(MUXER_NOT_FOUND, name)
    if url:
        ext = url.rsplit(".", 1)[-1].lower() if "." in url else ""
        for cls in _OUTPUT_FORMATS.values():
            if ext and ext in getattr(cls, "EXTENSIONS", ()):
                return cls
    raise AVError(MUXER_NOT_FOUND, url or "?")


def probe_input(data: bytes, url: str = ""):
    """reference: utils.c av_probe_input_format2 — score-based probing."""
    best, best_score = None, 0
    for cls in _INPUT_FORMATS.values():
        score = cls.probe(data, url)
        if score > best_score:
            best, best_score = cls, score
    if best is None:
        raise AVError(DEMUXER_NOT_FOUND, f"cannot probe format of {url!r}")
    return best


def sniff_key(codec_id: str, payload: bytes) -> bool:
    """Keyframe detection from the first payload bytes (used by demuxers
    without an index; reference: per-codec parsers set AV_PKT_FLAG_KEY)."""
    if codec_id == "mpeg4":
        i = payload.find(b"\x00\x00\x01\xb6")
        if i >= 0 and i + 4 < len(payload):
            return (payload[i + 4] >> 6) == 0     # VOP coding type I
        return payload[:4] == b"\x00\x00\x01\xb0"  # VOS header
    if codec_id in ("mpeg1video", "mpeg2video"):
        return b"\x00\x00\x01\xb3" in payload[:64]  # sequence header
    if codec_id == "h264":
        i = 0
        while True:
            i = payload.find(b"\x00\x00\x01", i)
            if i < 0 or i + 3 >= len(payload):
                return False
            if payload[i + 3] & 0x1F == 5:
                return True
            if payload[i + 3] & 0x1F == 1:
                return False
            i += 3
    return True      # intra-only codecs (mjpeg, rawvideo, pcm)


class _DoneParser:
    """Sentinel: parsing finished/unavailable for this stream."""

    def parse(self, data, eof=False):
        return [data] if data else []


class InputFormat(OptionedObject):
    """reference: avformat.h:505 AVInputFormat"""
    NAME = "none"
    LONG_NAME = ""
    EXTENSIONS: tuple = ()
    FLAG_NOFILE = False

    def __init__(self, options: Optional[Dict[str, Any]] = None):
        self.init_defaults()
        if options:
            # input options that this demuxer has no table entry for
            # are warned about and dropped, like the reference's
            # leftover-dict convention for avformat_open_input
            # (avconv routes e.g. -ar to raw demuxers that declare it;
            # on containers that carry their own rate it's ignored)
            leftover = self.set_opts(options, ignore_unknown=True)
            for k in leftover:
                log.warning(None, "input option '%s' not consumed by "
                            "demuxer %s", k, self.NAME)
        self.streams: List[Stream] = []
        self.pb: Optional[IOContext] = None
        self.url = ""

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        """Return probe score 0..100 (reference: AVPROBE_SCORE_MAX)."""
        ext = url.rsplit(".", 1)[-1].lower() if "." in url else ""
        if ext and ext in cls.EXTENSIONS:
            return 50
        return 0

    def read_header(self, pb: IOContext):
        raise NotImplementedError

    def read_packet(self) -> Packet:
        """Return next packet or raise AVError(EOF_)."""
        raise NotImplementedError

    def read_seek(self, stream_index: int, timestamp: int, flags: int = 0):
        raise AVError(EINVAL, f"{self.NAME}: seeking not supported")

    def close(self):
        pass


class OutputFormat(OptionedObject):
    """reference: avformat.h:430 AVOutputFormat"""
    NAME = "none"
    LONG_NAME = ""
    EXTENSIONS: tuple = ()
    VIDEO_CODEC = "none"
    AUDIO_CODEC = "none"
    FLAG_NOFILE = False   # reference: AVFMT_NOFILE (muxer does its own I/O)

    def __init__(self, options: Optional[Dict[str, Any]] = None):
        self.init_defaults()
        if options:
            self.set_opts(options)
        self.streams: List[Stream] = []
        self.pb: Optional[IOContext] = None
        self.url = ""

    def write_header(self, pb: IOContext):
        self.pb = pb

    def write_packet(self, pkt: Packet):
        raise NotImplementedError

    def write_trailer(self):
        pass


# ---------------------------------------------------------------------- #
# FormatContext
# ---------------------------------------------------------------------- #

class FormatContext:
    """reference: avformat.h:912 AVFormatContext — one context drives either
    demux (opened via open_input) or mux (opened via open_output)."""

    def __init__(self):
        self.iformat: Optional[InputFormat] = None
        self.oformat: Optional[OutputFormat] = None
        self.pb: Optional[IOContext] = None
        self.url = ""
        self.streams: List[Stream] = []
        self.duration = NOPTS_VALUE
        self.bit_rate = 0
        self.metadata: Dict[str, str] = {}
        # interleave state (reference: mux.c:644 per-stream FIFOs)
        self._mux_queue: List[Tuple[int, int, int, Packet]] = []
        self._mux_seq = 0
        self._header_written = False
        # demux: packets buffered by find_stream_info / parsers
        self._pkt_buffer: List[Packet] = []
        self._parsers: Dict[int, Any] = {}

    # -- demux side ----------------------------------------------------- #

    @staticmethod
    def open_input(url: str, format_name: Optional[str] = None,
                   options: Optional[Dict[str, Any]] = None) -> "FormatContext":
        """reference: utils.c:284 avformat_open_input"""
        ctx = FormatContext()
        ctx.url = url
        # virtual capture devices (libavdevice analogue): the URL is a
        # generator spec, not a file — skip byte I/O entirely
        dev_cls = None
        if format_name:
            try:
                c = find_input_format(format_name)
                if getattr(c, "DEVICE", False):
                    dev_cls = c
            except AVError:
                pass
        else:
            try:
                c = find_input_format(url.split("=", 1)[0])
                if getattr(c, "DEVICE", False):
                    dev_cls = c
            except AVError:
                pass
        # NOFILE inputs (rtp://...): the demuxer does its own network
        # I/O (reference: AVFMT_NOFILE on the input side)
        if dev_cls is None and not format_name and ":" in url:
            try:
                c = find_input_format(url.split(":", 1)[0])
                if getattr(c, "FLAG_NOFILE", False):
                    dev_cls = c
            except AVError:
                pass
        if dev_cls is not None:
            ctx.iformat = dev_cls(options)
            ctx.iformat.url = url
            ctx.pb = None
            ctx.iformat.read_header(None)
            ctx.streams = ctx.iformat.streams
            return ctx
        pb = url_open(url, "r")
        if format_name:
            cls = find_input_format(format_name)
        else:
            probe_len = 4096
            head = pb.read(probe_len)
            if pb.seekable:
                pb.seek(0)
            else:
                import io as _io
                rest = pb.read_all()
                pb = IOContext(_io.BytesIO(head + rest), seekable=True, url=url)
            cls = probe_input(head, url)
        ctx.iformat = cls(options)
        ctx.iformat.url = url
        ctx.pb = pb
        ctx.iformat.read_header(pb)
        ctx.streams = ctx.iformat.streams
        return ctx

    def read_frame(self) -> Packet:
        """reference: utils.c:1021 av_read_frame — returns one packet or
        raises AVError(EOF_). Packets buffered during stream-info probing
        are returned first; unframed streams go through the codec parser
        (utils.c:816) and every packet gets its timestamp fields
        completed (compute_pkt_fields, utils.c:641)."""
        if self._pkt_buffer:
            return self._pkt_buffer.pop(0)
        return self._read_frame_internal()

    def _read_frame_internal(self) -> Packet:
        while True:
            try:
                pkt = self.iformat.read_packet()
            except AVError as e:
                if e.code != EOF_:
                    raise
                # EOF: flush any parser remainders
                for idx, parser in self._parsers.items():
                    outs = parser.parse(b"", eof=True)
                    if outs:
                        pkts = [self._mk_parsed(idx, d) for d in outs]
                        self._pkt_buffer.extend(pkts[1:])
                        self._parsers[idx] = _DoneParser()
                        return pkts[0]
                raise
            st = self.streams[pkt.stream_index]
            pkt.time_base = st.time_base
            if st.need_parsing:
                parser = self._parsers.get(pkt.stream_index)
                if parser is None:
                    parser = self._open_parser(st)
                    self._parsers[pkt.stream_index] = parser
                if not isinstance(parser, _DoneParser) and parser:
                    outs = parser.parse(bytes(pkt.data))
                    if not outs:
                        continue
                    pkts = [self._mk_parsed(pkt.stream_index, d,
                                            like=pkt) for d in outs]
                    self._pkt_buffer.extend(pkts[1:])
                    pkt = pkts[0]
            self._compute_pkt_fields(st, pkt)
            return pkt

    def _open_parser(self, st: Stream):
        from libav_tpu_torch.codecs.parsers import find_parser
        try:
            return find_parser(st.codecpar.codec_id)()
        except Exception:
            return _DoneParser()

    def _mk_parsed(self, idx: int, data: bytes, like: Packet = None) -> Packet:
        st = self.streams[idx]
        p = Packet(data=data, stream_index=idx, time_base=st.time_base)
        if like is not None and not getattr(like, "_ts_taken", False):
            # the source packet's timestamps belong to the first frame
            # starting in it (reference: parser fetch_timestamp)
            p.pts, p.dts = like.pts, like.dts
            like._ts_taken = True
        # full payload: the h264 scan early-exits at the first slice NAL,
        # and a 256-byte cap misflags AUs whose SPS/PPS/SEI prefix is long
        p.flags = sniff_key(st.codecpar.codec_id, data) and 1 or 0
        self._compute_pkt_fields(st, p)
        return p

    def _compute_pkt_fields(self, st: Stream, pkt: Packet):
        """reference: utils.c:641 compute_pkt_fields — fill missing
        duration/dts/pts from stream cadence."""
        if pkt.dts is None:
            pkt.dts = NOPTS_VALUE
        if pkt.pts is None:
            pkt.pts = NOPTS_VALUE
        if not pkt.duration:
            fr = st.avg_frame_rate
            if st.codecpar.codec_type == MediaType.VIDEO and fr and fr.num:
                d = rescale_q(1, fr.inv(), st.time_base)
                pkt.duration = max(1, d)
        if st.codecpar.codec_id == "h264":
            # "We skip H.264 currently because delay and has_b_frames
            # are not reliably set" (utils.c:715) — missing timestamps
            # stay missing and the decode output clock numbers frames
            if pkt.dts != NOPTS_VALUE:
                st.cur_dts = pkt.dts + (pkt.duration or 0)
            return
        if pkt.dts == NOPTS_VALUE:
            if pkt.pts != NOPTS_VALUE and not self._may_reorder(st):
                pkt.dts = pkt.pts
            elif st.cur_dts != NOPTS_VALUE:
                pkt.dts = st.cur_dts
            else:
                pkt.dts = 0
        if pkt.pts == NOPTS_VALUE and not self._may_reorder(st):
            pkt.pts = pkt.dts
        if pkt.dts != NOPTS_VALUE:
            st.cur_dts = pkt.dts + (pkt.duration or 0)

    @staticmethod
    def _may_reorder(st: Stream) -> bool:
        """Codecs with possible pts != dts (B frames)."""
        return st.codecpar.codec_id in ("h264", "mpeg1video", "mpeg2video",
                                        "mpeg4")

    def find_stream_info(self, max_packets: int = 64,
                         max_frames_per_stream: int = 8, *, device):
        """reference: utils.c:2200 avformat_find_stream_info — bounded
        trial decode, with the port's decoders on `device`, to complete
        missing codec parameters; consumed packets are buffered and
        replayed by read_frame. A decoder's AVError is swallowed; any
        other failure (a CUDA fault among them) is raised."""
        from libav_tpu_torch.codecs.api import find_decoder

        def missing(st: Stream) -> bool:
            p = st.codecpar
            if p.codec_id in ("none", None, ""):
                return False           # nothing we can do
            if p.codec_type == MediaType.VIDEO:
                return not p.width or not p.height or \
                    p.pix_fmt in (None, "", "none")
            if p.codec_type == MediaType.AUDIO:
                return not p.sample_rate or not p.channels
            return False

        if not any(missing(st) for st in self.streams):
            return
        decoders = {}
        counts = {st.index: 0 for st in self.streams}
        taken = 0
        while any(missing(st) for st in self.streams) and \
                taken < max_packets:
            try:
                pkt = self._read_frame_internal()
            except AVError as e:
                if e.code == EOF_:
                    break
                raise
            self._pkt_buffer.append(pkt)
            taken += 1
            st = self.streams[pkt.stream_index]
            if not missing(st) or \
                    counts[st.index] >= max_frames_per_stream:
                continue
            counts[st.index] += 1
            dec = decoders.get(st.index)
            if dec is None:
                try:
                    dec = find_decoder(st.codecpar.codec_id)(
                        st.codecpar, device=device)
                except AVError:
                    decoders[st.index] = False
                    continue
                decoders[st.index] = dec
            if dec is False:
                continue
            try:
                dec.send_packet(pkt.clone())
                frames = dec._pump()
            except AVError:
                continue
            p = st.codecpar
            for f in frames:
                if p.codec_type == MediaType.VIDEO:
                    p.width = p.width or f.width
                    p.height = p.height or f.height
                    if p.pix_fmt in (None, "", "none"):
                        p.pix_fmt = f.format
                else:
                    p.sample_rate = p.sample_rate or f.sample_rate
                    p.channels = p.channels or f.channels
                    if getattr(p, "sample_fmt", None) in (None, "", "none"):
                        p.sample_fmt = f.format
            # decoders that learn params from headers before the first
            # output frame (SPS width/height) are also harvested
            if p.codec_type == MediaType.VIDEO and not p.width:
                w = getattr(dec, "width", 0)
                h = getattr(dec, "height", 0)
                if w and h:
                    p.width, p.height = w, h

    def packets(self):
        """Iterate all packets (generator convenience)."""
        while True:
            try:
                yield self.read_frame()
            except AVError as e:
                if e.code == EOF_:
                    return
                raise

    def seek(self, stream_index: int, timestamp: int, flags: int = 0):
        """reference: avformat.h:1620 avformat_seek_file"""
        return self.iformat.read_seek(stream_index, timestamp, flags)

    # -- mux side --------------------------------------------------------#

    @staticmethod
    def open_output(url: str, format_name: Optional[str] = None,
                    options: Optional[Dict[str, Any]] = None) -> "FormatContext":
        ctx = FormatContext()
        ctx.url = url
        cls = guess_format(format_name, url)
        ctx.oformat = cls(options)
        ctx.oformat.url = url
        if not cls.FLAG_NOFILE:
            ctx.pb = url_open(url, "w")
        return ctx

    def new_stream(self, codecpar: CodecParameters,
                   time_base: Rational = Rational(1, 90000)) -> Stream:
        st = Stream(index=len(self.streams), codecpar=codecpar,
                    time_base=time_base)
        self.streams.append(st)
        return st

    def write_header(self):
        """reference: mux.c:234 avformat_write_header"""
        self.oformat.streams = self.streams
        self.oformat.write_header(self.pb)
        self._header_written = True

    def write_packet(self, pkt: Packet):
        """reference: mux.c:644 av_interleaved_write_frame — interleave by
        dts across streams."""
        if not self._header_written:
            self.write_header()
        if len(self.streams) == 1:
            self.oformat.write_packet(pkt)
            return
        st = self.streams[pkt.stream_index]
        key = pkt.dts if pkt.dts != NOPTS_VALUE else pkt.pts
        # normalize to microseconds for cross-stream comparison
        key_us = rescale_q(key, st.time_base, Rational(1, 1000000)) \
            if key != NOPTS_VALUE else 0
        heapq.heappush(self._mux_queue, (key_us, self._mux_seq, pkt.stream_index, pkt))
        self._mux_seq += 1
        self._mux_drain()

    def _mux_drain(self):
        # drain while every *live* (non-EOF) stream has a queued packet;
        # a stream that ended early must not stall interleaving
        # (reference: mux.c:644 treats EOF-ed streams as always ready)
        while self._mux_queue:
            have = set(p[2] for p in self._mux_queue)
            live = [s for s in self.streams if not s.eof]
            if not all(s.index in have for s in live):
                return
            _, _, _, p = heapq.heappop(self._mux_queue)
            self.oformat.write_packet(p)

    def write_stream_eof(self, stream_index: int):
        """Mark a stream as finished so interleaving no longer waits on
        it (reference: mux.c EOF flush path)."""
        if 0 <= stream_index < len(self.streams):
            self.streams[stream_index].eof = True
            if self._header_written:
                self._mux_drain()

    def write_trailer(self):
        # the header is lazy on first packet; an empty output still gets
        # a valid header+trailer instead of crashing the muxer
        # (reference: avformat_write_header is mandatory before trailer)
        if not self._header_written:
            self.write_header()
        while self._mux_queue:
            _, _, _, p = heapq.heappop(self._mux_queue)
            self.oformat.write_packet(p)
        self.oformat.write_trailer()
        if self.pb is not None and hasattr(self.pb._f, "close"):
            self.pb.close()

    def close(self):
        if self.iformat:
            self.iformat.close()
        if self.pb:
            try:
                self.pb.close()
            except Exception:
                pass


def open_input(url: str, format_name: Optional[str] = None,
               options: Optional[Dict[str, Any]] = None) -> FormatContext:
    return FormatContext.open_input(url, format_name, options)
