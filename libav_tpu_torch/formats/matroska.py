"""Matroska/WebM demuxer + muxer (reference: libavformat/matroskadec.c
matroska_read_header/matroska_parse_cluster + matroskaenc.c; EBML layer
per the Matroska spec — the reference's ebml_parse/ebml_read_* walk
re-expressed as a recursive element reader over the whole file).

Demux: EBML header, Segment Info (TimecodeScale/Duration), Tracks
(codec mapping incl. CodecPrivate: avcC -> h264_mp4toannexb BSF,
AudioSpecificConfig for AAC), Clusters with SimpleBlock / BlockGroup
and all four lacing modes (none/Xiph/fixed/EBML).

Mux: minimal single-Segment writer — Info, Tracks, one Cluster per
~1s of timecodes, SimpleBlocks, no Cues (players index by scan)."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.codecs.bsf import H264Mp4ToAnnexB, annexb_to_avcc, make_avcc
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)

# ---- EBML element IDs (Matroska spec) ---- #
EBML_HEADER = 0x1A45DFA3
DOCTYPE = 0x4282
SEGMENT = 0x18538067
SEEKHEAD = 0x114D9B74
INFO = 0x1549A966
TIMECODE_SCALE = 0x2AD7B1
DURATION = 0x4489
MUXINGAPP = 0x4D80
WRITINGAPP = 0x5741
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_UID = 0x73C5
TRACK_TYPE = 0x83
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
DEFAULT_DURATION = 0x23E383
T_VIDEO = 0xE0
PIXEL_WIDTH = 0xB0
PIXEL_HEIGHT = 0xBA
T_AUDIO = 0xE1
SAMPLING_FREQ = 0xB5
CHANNELS = 0x9F
BIT_DEPTH = 0x6264
CLUSTER = 0x1F43B675
CLUSTER_TIMECODE = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1
BLOCK_DURATION = 0x9B
REFERENCE_BLOCK = 0xFB
CUES = 0x1C53BB6B
CUE_POINT = 0xBB
CUE_TIME = 0xB3
CUE_TRACK_POSITIONS = 0xB7
CUE_TRACK = 0xF7
CUE_CLUSTER_POSITION = 0xF1
SEEK = 0x4DBB
SEEK_ID = 0x53AB
SEEK_POSITION = 0x53AC
VOID = 0xEC
CRC32 = 0xBF

TRACK_TYPE_VIDEO = 1
TRACK_TYPE_AUDIO = 2

_CODEC_ID_TO_NAME = {
    "V_MPEG4/ISO/AVC": "h264",
    "V_MPEG4/ISO/ASP": "mpeg4",
    "V_MPEG4/ISO/SP": "mpeg4",
    "V_MS/VFW/FOURCC": "mpeg4",
    "V_MPEG1": "mpeg1video",
    "V_MPEG2": "mpeg2video",
    "V_MJPEG": "mjpeg",
    "A_AAC": "aac",
    "A_AC3": "ac3",
    "A_EAC3": "eac3",
    "A_MPEG/L3": "mp3",
    "A_MPEG/L2": "mp2",
    "A_PCM/INT/LIT": "pcm_s16le",
    "A_PCM/FLOAT/IEEE": "pcm_f32le",
}
_NAME_TO_CODEC_ID = {
    "h264": "V_MPEG4/ISO/AVC", "mpeg4": "V_MPEG4/ISO/ASP",
    "mpeg1video": "V_MPEG1", "mpeg2video": "V_MPEG2", "mjpeg": "V_MJPEG",
    "aac": "A_AAC", "ac3": "A_AC3", "pcm_s16le": "A_PCM/INT/LIT",
    "pcm_f32le": "A_PCM/FLOAT/IEEE",
}


# ---- EBML primitives ---- #

def _read_vint(data: bytes, pos: int, keep_marker: bool) -> Tuple[int, int]:
    """-> (value, new_pos); keep_marker=True for element IDs."""
    if pos >= len(data):
        raise AVError(EOF_)
    b0 = data[pos]
    if b0 == 0:
        raise AVError(INVALIDDATA, "bad EBML vint")
    length = 8 - b0.bit_length() + 1
    if pos + length > len(data):
        raise AVError(EOF_)
    v = b0 if keep_marker else b0 & (0xFF >> length)
    for k in range(1, length):
        v = (v << 8) | data[pos + k]
    return v, pos + length


def _read_id(data, pos):
    return _read_vint(data, pos, keep_marker=True)


def _read_size(data, pos):
    v, p = _read_vint(data, pos, keep_marker=False)
    return v, p


def _children(data: bytes, start: int, end: int):
    """Iterate (id, body_start, body_end) of EBML children in a span."""
    pos = start
    while pos < end:
        try:
            eid, p = _read_id(data, pos)
            size, p = _read_size(data, p)
        except AVError:
            return
        if size == (1 << 56) - 1:     # unknown size: runs to span end
            yield eid, p, end
            return
        yield eid, p, min(p + size, end)
        pos = p + size


def _uint(data, s, e):
    v = 0
    for b in data[s:e]:
        v = (v << 8) | b
    return v


def _float(data, s, e):
    n = e - s
    if n == 4:
        return struct.unpack(">f", data[s:e])[0]
    if n == 8:
        return struct.unpack(">d", data[s:e])[0]
    return 0.0


def _sint(data, s, e):
    v = _uint(data, s, e)
    bits = (e - s) * 8
    if bits and v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


@register_input
class MatroskaDemuxer(InputFormat):
    NAME = "matroska"
    EXTENSIONS = ("mkv", "mka", "webm")

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        return 100 if data[:4] == b"\x1a\x45\xdf\xa3" else 0

    def read_header(self, pb):
        self.pb = pb
        data = pb.read_all()
        self._data = data
        self.streams: List[Stream] = []
        self._track_to_stream: Dict[int, int] = {}
        self._bsf: Dict[int, Optional[object]] = {}
        self._tc_scale = 1000000          # ns per timecode tick (default)
        self._blocks: List[Tuple[int, int, int, bytes]] = []
        # (timecode_ticks, stream_idx, keyflag, payload)

        if data[:4] != b"\x1a\x45\xdf\xa3":
            raise AVError(INVALIDDATA, "not matroska")
        pos = 0
        segment = None
        for eid, s, e in _children(data, 0, len(data)):
            if eid == SEGMENT:
                segment = (s, e)
                break
        if segment is None:
            raise AVError(INVALIDDATA, "no Segment")

        for eid, s, e in _children(data, *segment):
            if eid == INFO:
                for cid, cs, ce in _children(data, s, e):
                    if cid == TIMECODE_SCALE:
                        self._tc_scale = _uint(data, cs, ce)
            elif eid == TRACKS:
                for cid, cs, ce in _children(data, s, e):
                    if cid == TRACK_ENTRY:
                        self._parse_track(data, cs, ce)
            elif eid == CLUSTER:
                self._parse_cluster(data, s, e)
        # time_base: timecode ticks (tc_scale ns each)
        tb = Rational(self._tc_scale, 1000000000)
        for st in self.streams:
            st.time_base = tb
        self._blocks.sort(key=lambda b: b[0])
        self._cursor = 0

    def _parse_track(self, data, s, e):
        num = 0
        ttype = 0
        codec_id = ""
        private = b""
        w = h = 0
        rate = 0.0
        ch = 1
        default_dur = 0
        for cid, cs, ce in _children(data, s, e):
            if cid == TRACK_NUMBER:
                num = _uint(data, cs, ce)
            elif cid == TRACK_TYPE:
                ttype = _uint(data, cs, ce)
            elif cid == CODEC_ID:
                codec_id = data[cs:ce].decode("ascii", "replace")
            elif cid == CODEC_PRIVATE:
                private = data[cs:ce]
            elif cid == DEFAULT_DURATION:
                default_dur = _uint(data, cs, ce)
            elif cid == T_VIDEO:
                for vid, vs, ve in _children(data, cs, ce):
                    if vid == PIXEL_WIDTH:
                        w = _uint(data, vs, ve)
                    elif vid == PIXEL_HEIGHT:
                        h = _uint(data, vs, ve)
            elif cid == T_AUDIO:
                for aid, as_, ae in _children(data, cs, ce):
                    if aid == SAMPLING_FREQ:
                        rate = _float(data, as_, ae)
                    elif aid == CHANNELS:
                        ch = _uint(data, as_, ae)
        name = _CODEC_ID_TO_NAME.get(codec_id)
        if name is None:
            name = codec_id.lower().replace("/", "_")
        bsf = None
        if ttype == TRACK_TYPE_VIDEO:
            par = CodecParameters(codec_type=MediaType.VIDEO, codec_id=name,
                                  width=w, height=h, pix_fmt="yuv420p")
            if name == "h264" and private[:1] == b"\x01":
                par.extradata = private
                bsf = H264Mp4ToAnnexB(private)
            elif private:
                par.extradata = private
            fr = None
            if default_dur:
                fr = Rational.reduce(1000000000, default_dur)
            st = Stream(index=len(self.streams), codecpar=par,
                        time_base=Rational(1, 1000), avg_frame_rate=fr)
        elif ttype == TRACK_TYPE_AUDIO:
            par = CodecParameters(codec_type=MediaType.AUDIO, codec_id=name,
                                  sample_rate=int(rate) or 48000,
                                  channels=ch, sample_fmt="fltp")
            if private:
                par.extradata = private
            st = Stream(index=len(self.streams), codecpar=par,
                        time_base=Rational(1, 1000))
        else:
            return
        self._track_to_stream[num] = st.index
        self._bsf[st.index] = bsf
        self.streams.append(st)

    def _parse_cluster(self, data, s, e):
        cluster_tc = 0
        for cid, cs, ce in _children(data, s, e):
            if cid == CLUSTER_TIMECODE:
                cluster_tc = _uint(data, cs, ce)
            elif cid == SIMPLE_BLOCK:
                self._parse_block(data, cs, ce, cluster_tc, simple=True)
            elif cid == BLOCK_GROUP:
                block_span = None
                has_ref = False
                for gid, gs, ge in _children(data, cs, ce):
                    if gid == BLOCK:
                        block_span = (gs, ge)
                    elif gid == REFERENCE_BLOCK:
                        has_ref = True
                if block_span:
                    self._parse_block(data, *block_span, cluster_tc,
                                      simple=False, key=not has_ref)

    def _parse_block(self, data, s, e, cluster_tc, simple, key=True):
        """SimpleBlock/Block payload: track vint, s16 rel. timecode,
        flags, optional lacing, frame data (Matroska spec §Block)."""
        track, p = _read_vint(data, s, keep_marker=False)
        if p + 3 > e:
            return
        rel_tc = struct.unpack(">h", data[p:p + 2])[0]
        flags = data[p + 2]
        p += 3
        if simple:
            key = bool(flags & 0x80)
        lacing = (flags >> 1) & 3
        sizes: List[int] = []
        if lacing == 0:
            sizes = [e - p]
        else:
            nframes = data[p] + 1
            p += 1
            if lacing == 2:                       # fixed
                each = (e - p) // nframes
                sizes = [each] * nframes
            elif lacing == 1:                     # Xiph
                for _ in range(nframes - 1):
                    sz = 0
                    while True:
                        b = data[p]
                        p += 1
                        sz += b
                        if b != 255:
                            break
                    sizes.append(sz)
                sizes.append(e - p - sum(sizes))
            else:                                 # EBML lacing
                first, p = _read_vint(data, p, keep_marker=False)
                sizes.append(first)
                prev = first
                for _ in range(nframes - 2):
                    raw, np_ = _read_vint(data, p, keep_marker=False)
                    nbytes = np_ - p
                    delta = raw - ((1 << (7 * nbytes - 1)) - 1)
                    prev += delta
                    sizes.append(prev)
                    p = np_
                sizes.append(e - p - sum(sizes))
        sidx = self._track_to_stream.get(track)
        if sidx is None:
            return
        tc = cluster_tc + rel_tc
        for sz in sizes:
            if sz < 0 or p + sz > e:
                return
            self._blocks.append((tc, sidx, 1 if key else 0,
                                 data[p:p + sz]))
            p += sz

    def read_seek(self, stream_index: int, timestamp: int, flags: int = 0):
        """Seek to the last keyframe at/before timestamp (reference:
        matroskadec.c matroska_read_seek; without Cues the in-memory
        block list is the index)."""
        best = 0
        for k, (tc, sidx, key, _payload) in enumerate(self._blocks):
            if sidx != stream_index:
                continue
            if tc > timestamp:
                break
            if key:
                best = k
        self._cursor = best

    def read_packet(self) -> Packet:
        while self._cursor < len(self._blocks):
            tc, sidx, key, payload = self._blocks[self._cursor]
            self._cursor += 1
            pkt = Packet(data=payload, pts=tc, dts=tc, duration=0,
                         stream_index=sidx,
                         flags=PKT_FLAG_KEY if key else 0,
                         time_base=self.streams[sidx].time_base)
            bsf = self._bsf.get(sidx)
            if bsf is not None:
                pkt = bsf.filter(pkt)[0]
                pkt.stream_index = sidx
            return pkt
        raise AVError(EOF_)


# ---- EBML writer ---- #

def _w_vint_id(eid: int) -> bytes:
    n = (eid.bit_length() + 7) // 8
    return eid.to_bytes(n, "big")


def _w_size(size: int) -> bytes:
    for n in range(1, 9):
        if size < (1 << (7 * n)) - 1:
            return ((1 << (7 * n)) | size).to_bytes(n, "big")
    raise AVError(INVALIDDATA, "size too large")


def _elem(eid: int, body: bytes) -> bytes:
    return _w_vint_id(eid) + _w_size(len(body)) + body


def _e_uint(eid: int, v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return _elem(eid, v.to_bytes(n, "big"))


def _e_float(eid: int, v: float) -> bytes:
    return _elem(eid, struct.pack(">d", v))


def _e_str(eid: int, s: str) -> bytes:
    return _elem(eid, s.encode())


@register_output
class MatroskaMuxer(OutputFormat):
    NAME = "matroska"
    EXTENSIONS = ("mkv", "mka")
    VIDEO_CODEC = "mpeg4"
    AUDIO_CODEC = "ac3"

    CLUSTER_MS = 1000

    def write_header(self, pb):
        self.pb = pb
        self._packets: List[Packet] = []

    def write_packet(self, pkt: Packet):
        self._packets.append(pkt)

    def _ms(self, pkt: Packet) -> int:
        t = pkt.pts if pkt.pts is not None else (pkt.dts or 0)
        tb = pkt.time_base or self.streams[pkt.stream_index].time_base \
            or Rational(1, 1000)
        return int(round(t * tb.num * 1000 / tb.den))

    def write_trailer(self):
        pb = self.pb
        ebml = _elem(EBML_HEADER,
                     _e_uint(0x4286, 1) +          # EBMLVersion
                     _e_uint(0x42F7, 1) +          # EBMLReadVersion
                     _e_uint(0x42F2, 4) +          # EBMLMaxIDLength
                     _e_uint(0x42F3, 8) +          # EBMLMaxSizeLength
                     _e_str(DOCTYPE, "matroska") +
                     _e_uint(0x4287, 2) +          # DocTypeVersion
                     _e_uint(0x4285, 2))           # DocTypeReadVersion

        max_ms = max((self._ms(p) for p in self._packets), default=0)
        info = _elem(INFO,
                     _e_uint(TIMECODE_SCALE, 1000000) +
                     _e_float(DURATION, float(max_ms)) +
                     _e_str(MUXINGAPP, "libav_tpu") +
                     _e_str(WRITINGAPP, "libav_tpu"))

        tracks_body = b""
        for si, st in enumerate(self.streams):
            par = st.codecpar
            cid = _NAME_TO_CODEC_ID.get(par.codec_id)
            if cid is None:
                raise AVError(INVALIDDATA,
                              f"matroska: no CodecID for {par.codec_id}")
            entry = (_e_uint(TRACK_NUMBER, si + 1) +
                     _e_uint(TRACK_UID, si + 1) +
                     _e_str(CODEC_ID, cid))
            private = par.extradata or b""
            if par.codec_type == MediaType.VIDEO:
                entry += _e_uint(TRACK_TYPE, TRACK_TYPE_VIDEO)
                if par.codec_id == "h264":
                    if not private or private[:1] != b"\x01":
                        private = self._avcc_from_stream(si)
                entry += _elem(T_VIDEO,
                               _e_uint(PIXEL_WIDTH, par.width) +
                               _e_uint(PIXEL_HEIGHT, par.height))
                fr = st.avg_frame_rate
                if fr and fr.num:
                    entry += _e_uint(DEFAULT_DURATION,
                                     int(1000000000 * fr.den / fr.num))
            else:
                entry += _e_uint(TRACK_TYPE, TRACK_TYPE_AUDIO)
                entry += _elem(T_AUDIO,
                               _e_float(SAMPLING_FREQ,
                                        float(par.sample_rate or 48000)) +
                               _e_uint(CHANNELS, par.channels or 2))
            if private:
                entry += _elem(CODEC_PRIVATE, private)
            tracks_body += _elem(TRACK_ENTRY, entry)
        tracks = _elem(TRACKS, tracks_body)

        # clusters, remembering which holds each video keyframe so the
        # Cues index can point at it (reference matroskaenc.c:415
        # mkv_write_cues / mkv_add_cuepoint at each video keyframe)
        video_tracks = {si for si, st in enumerate(self.streams)
                        if st.codecpar.codec_type == MediaType.VIDEO}
        cluster_blobs: List[bytes] = []   # finished cluster elements
        cue_pts: List[Tuple[int, int, int]] = []  # (ms, track, cluster#)
        cur: List[bytes] = []
        cur_tc = None

        cluster_tcs: List[int] = []

        def flush():
            if cur:
                cluster_tcs.append(cur_tc)
                cluster_blobs.append(_elem(
                    CLUSTER, _e_uint(CLUSTER_TIMECODE, cur_tc) +
                    b"".join(cur)))

        for pkt in self._packets:
            ms = self._ms(pkt)
            si = pkt.stream_index
            key = bool(pkt.flags & PKT_FLAG_KEY)
            # new cluster on the time limit, or on a video keyframe once
            # the cluster holds >4KB (reference matroskaenc.c:1803-1805)
            # — cue points land on cluster starts so seeks are exact
            if cur_tc is None or ms - cur_tc >= self.CLUSTER_MS or \
                    (key and si in video_tracks and
                     sum(len(b) for b in cur) > 4096):
                flush()
                cur, cur_tc = [], ms
            rel = ms - cur_tc
            data = pkt.data
            if self.streams[si].codecpar.codec_id == "h264" and \
                    data[:4] in (b"\x00\x00\x00\x01", b"\x00\x00\x01"):
                data = annexb_to_avcc(data)
            if key and si in video_tracks:
                cue_pts.append((ms, si + 1, len(cluster_blobs)))
            body = (_w_size(si + 1) + struct.pack(">h", rel) +
                    bytes([0x80 if key else 0]) + data)
            cur.append(_elem(SIMPLE_BLOCK, body))
        flush()

        # layout (positions relative to the segment payload start):
        # SeekHead | Info | Tracks | Cluster* | Cues.  SeekHead uses
        # fixed 8-byte positions so its own size is layout-independent.
        def seekhead(pos_info, pos_tracks, pos_cues):
            body = b""
            for eid, pos in ((INFO, pos_info), (TRACKS, pos_tracks),
                             (CUES, pos_cues)):
                idb = eid.to_bytes((eid.bit_length() + 7) // 8, "big")
                body += _elem(SEEK, _elem(SEEK_ID, idb) +
                              _elem(SEEK_POSITION,
                                    struct.pack(">Q", pos)))
            return _elem(SEEKHEAD, body)

        sh_len = len(seekhead(0, 0, 0))
        pos_info = sh_len
        pos_tracks = pos_info + len(info)
        cluster_offs = []
        off = pos_tracks + len(tracks)
        for blob in cluster_blobs:
            cluster_offs.append(off)
            off += len(blob)
        pos_cues = off

        if not cue_pts:
            # audio-only: one cue per cluster on the first track
            cue_pts = [(tc, 1, ci) for ci, tc in enumerate(cluster_tcs)]
        cues_body = b""
        for ms, trk, ci in cue_pts:
            cues_body += _elem(
                CUE_POINT,
                _e_uint(CUE_TIME, ms) +
                _elem(CUE_TRACK_POSITIONS,
                      _e_uint(CUE_TRACK, trk) +
                      _e_uint(CUE_CLUSTER_POSITION, cluster_offs[ci])))
        cues = _elem(CUES, cues_body) if cues_body else b""

        segment = _elem(SEGMENT,
                        seekhead(pos_info, pos_tracks, pos_cues) +
                        info + tracks + b"".join(cluster_blobs) + cues)
        pb.write(ebml + segment)

    def _avcc_from_stream(self, si: int) -> bytes:
        """Build avcC from the first keyframe's in-band SPS/PPS."""
        from libav_tpu_torch.codecs.h264 import nal as nal_mod
        for pkt in self._packets:
            if pkt.stream_index != si:
                continue
            sps = pps = None
            for n in nal_mod.split_annexb(pkt.data):
                t = nal_mod.nal_header(n)[1]
                if t == nal_mod.NAL_SPS:
                    sps = n
                elif t == nal_mod.NAL_PPS:
                    pps = n
            if sps and pps:
                return make_avcc(sps, pps)
        return b""


@register_input
class WebmDemuxer(MatroskaDemuxer):
    NAME = "webm"
    EXTENSIONS = ("webm",)

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        return 0      # matroska probe covers webm (same EBML magic)
