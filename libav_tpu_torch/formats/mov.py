"""MP4/MOV demuxer + muxer (reference: libavformat/mov.c (4142) and
movenc.c; ISO 14496-12 box structure).

Demux: full sample-table parse (stsd/stts/ctts/stsc/stsz/stco/co64/stss),
per-track sample iteration interleaved by dts; h264 tracks are converted
to Annex B on the fly (the auto-inserted h264_mp4toannexb BSF, like
AVCodec.bsfs wiring at reference decode.c:459).

Mux: buffered samples, moov written at trailer; avc1+avcC (annexb input
converted via BSFs), mp4v/mp4a + esds, jpeg tracks.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import NOPTS_VALUE, Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.codecs.bsf import (H264Mp4ToAnnexB, annexb_to_avcc,
                                  make_avcc, make_asc, parse_asc)
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)


def _boxes(data: bytes, start: int = 0, end: Optional[int] = None):
    """Iterate (type, payload_start, payload_end)."""
    pos = start
    end = len(data) if end is None else end
    while pos + 8 <= end:
        size = struct.unpack(">I", data[pos:pos + 4])[0]
        btype = data[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr:
            break
        yield btype, pos + hdr, pos + size
        pos += size


def _find(data, path, start=0, end=None):
    """Find first box at a '/'-separated path; returns (s, e) or None."""
    parts = path.split("/")
    cur = [(start, len(data) if end is None else end)]
    for p in parts:
        nxt = []
        for (s, e) in cur:
            for btype, bs, be in _boxes(data, s, e):
                if btype == p.encode():
                    nxt.append((bs, be))
        if not nxt:
            return None
        cur = nxt
    return cur[0]


@dataclass
class _Track:
    stream: Stream = None
    timescale: int = 1000
    track_id: int = 0
    sample_sizes: List[int] = field(default_factory=list)
    sample_offsets: List[int] = field(default_factory=list)
    sample_dts: List[int] = field(default_factory=list)
    sample_cts: List[int] = field(default_factory=list)
    sample_dur: List[int] = field(default_factory=list)
    keyframes: Optional[set] = None
    bsf: Optional[object] = None
    cursor: int = 0
    # edit list: up to two (media_time, segment_duration) entries —
    # entry 0 may be an empty edit (time==-1, duration in MOVIE
    # timescale = start delay), entry 1 then carries the media_time
    # shift (track timescale) — reference mov.c:3157 mov_read_elst +
    # mov_build_index
    elst_raw: Optional[List[Tuple[int, int]]] = None
    time_offset: int = 0
    track_end: int = 0                           # next frag dts (+offset)


@register_input
class MovDemuxer(InputFormat):
    NAME = "mov,mp4,m4a,3gp"
    EXTENSIONS = ("mp4", "mov", "m4a", "m4v2", "3gp")

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        if len(data) > 11 and data[4:8] in (b"ftyp", b"styp", b"moov",
                                            b"moof", b"mdat", b"wide",
                                            b"free", b"sidx"):
            return 95
        return 0

    def read_header(self, pb):
        self.pb = pb
        data = pb.read_all()
        self._data = data
        moov = _find(data, "moov")
        if moov is None:
            raise AVError(INVALIDDATA, "no moov box")
        self.tracks: List[_Track] = []
        self.streams = []
        movie_timescale = 1000
        mvhd = _find(data, "mvhd", *moov)
        if mvhd:
            v = data[mvhd[0]]
            movie_timescale = struct.unpack(
                ">I", data[mvhd[0] + (20 if v else 12):][:4])[0] or 1000
        for btype, s, e in _boxes(data, *moov):
            if btype == b"trak":
                t = self._parse_trak(data, s, e)
                if t is not None:
                    t.stream.index = len(self.streams)
                    self.streams.append(t.stream)
                    self.tracks.append(t)
        if not self.tracks:
            raise AVError(INVALIDDATA, "no usable tracks")

        # edit lists shift the whole dts timeline by -time_offset
        # (reference mov.c:2304-2307 mov_build_index: an initial empty
        # edit, stored movie-timescale, rescales to the track timescale)
        for t in self.tracks:
            if t.elst_raw is None:
                continue
            time, duration = t.elst_raw[0]
            if time == -1:
                # entry 0 is an empty edit (start delay, stored in the
                # MOVIE timescale); the common two-entry pattern puts
                # the media_time shift (track timescale) in entry 1
                delay = duration * t.timescale // movie_timescale
                media = 0
                if len(t.elst_raw) > 1 and t.elst_raw[1][0] >= 0:
                    media = t.elst_raw[1][0]
                off = media - delay
            else:
                off = time
            t.time_offset = off
            if t.sample_dts:
                t.sample_dts = [d - off for d in t.sample_dts]
        for t in self.tracks:
            t.track_end = (t.sample_dts[-1] + t.sample_dur[-1] +
                           t.time_offset) if t.sample_dts else 0

        # movie fragments (moof/tfhd/tfdt/trun — reference mov.c:2858,
        # 2925,2955); trex in moov/mvex supplies per-track defaults
        trex: Dict[int, Tuple[int, int, int]] = {}
        mvex = _find(data, "mvex", *moov)
        if mvex:
            for bt, s, e in _boxes(data, *mvex):
                if bt == b"trex":
                    tid, _stsd, dur, size, fl = struct.unpack(
                        ">5I", data[s + 4:s + 24])
                    trex[tid] = (dur, size, fl)
        by_id = {t.track_id: t for t in self.tracks}
        # snapshot moov-only state before fragments append samples:
        # cts lists must align by sample index (reference complements
        # the ctts table at mov.c:2990), and with stss absent every
        # moov sample is sync (ISO 14496-12 8.6.2)
        moov_counts = {}
        stss_absent = {}
        for t in self.tracks:
            moov_counts[t.track_id] = len(t.sample_sizes)
            stss_absent[t.track_id] = t.keyframes is None
            if len(t.sample_cts) < len(t.sample_sizes):
                t.sample_cts.extend(
                    [0] * (len(t.sample_sizes) - len(t.sample_cts)))
        any_frag = False
        for btype, s, e in _boxes(data):
            if btype == b"moof":
                any_frag = True
                self._parse_moof(data, s, e, s - 8, trex, by_id)
        if any_frag:
            for t in self.tracks:
                if stss_absent[t.track_id]:
                    t.keyframes = (t.keyframes or set()) | \
                        set(range(1, moov_counts[t.track_id] + 1))

    def _parse_moof(self, data, s, e, moof_offset, trex, by_id):
        implicit = moof_offset          # frag->implicit_offset, mov.c:874
        for bt, ts_, te in _boxes(data, s, e):
            if bt != b"traf":
                continue
            track = None
            base = implicit
            d_dur = d_size = d_flags = 0
            for bt2, s2, e2 in _boxes(data, ts_, te):
                if bt2 == b"tfhd":
                    flags = struct.unpack(">I", data[s2:s2 + 4])[0] \
                        & 0xFFFFFF
                    tid = struct.unpack(">I", data[s2 + 4:s2 + 8])[0]
                    track = by_id.get(tid)
                    d_dur, d_size, d_flags = trex.get(tid, (0, 0, 0))
                    p = s2 + 8
                    if flags & 0x01:            # base-data-offset
                        base = struct.unpack(">Q", data[p:p + 8])[0]
                        p += 8
                    elif flags & 0x20000:       # default-base-is-moof
                        base = moof_offset
                    if flags & 0x02:            # stsd id
                        p += 4
                    if flags & 0x08:
                        d_dur = struct.unpack(">I", data[p:p + 4])[0]
                        p += 4
                    if flags & 0x10:
                        d_size = struct.unpack(">I", data[p:p + 4])[0]
                        p += 4
                    if flags & 0x20:
                        d_flags = struct.unpack(">I", data[p:p + 4])[0]
                elif bt2 == b"tfdt" and track is not None:
                    v = data[s2]
                    track.track_end = struct.unpack(
                        ">Q" if v else ">I",
                        data[s2 + 4:s2 + (12 if v else 8)])[0]
                elif bt2 == b"trun" and track is not None:
                    implicit = self._parse_trun(
                        data, s2, e2, track, base, d_dur, d_size, d_flags)

    def _parse_trun(self, data, s, e, t: _Track, base, d_dur, d_size,
                    d_flags) -> int:
        flags = struct.unpack(">I", data[s:s + 4])[0] & 0xFFFFFF
        entries = struct.unpack(">I", data[s + 4:s + 8])[0]
        p = s + 8
        data_offset = 0
        first_flags = d_flags
        if flags & 0x01:
            data_offset = struct.unpack(">i", data[p:p + 4])[0]
            p += 4
        if flags & 0x04:
            first_flags = struct.unpack(">I", data[p:p + 4])[0]
            p += 4
        dts = t.track_end - t.time_offset
        off = base + data_offset
        is_audio = t.stream.codecpar.codec_type == MediaType.AUDIO
        for i in range(entries):
            dur, size, sf, cts = d_dur, d_size, \
                (d_flags if i else first_flags), 0
            if flags & 0x100:
                dur = struct.unpack(">I", data[p:p + 4])[0]
                p += 4
            if flags & 0x200:
                size = struct.unpack(">I", data[p:p + 4])[0]
                p += 4
            if flags & 0x400:
                sf = struct.unpack(">I", data[p:p + 4])[0]
                p += 4
            if flags & 0x800:
                cts = struct.unpack(">i", data[p:p + 4])[0]
                p += 4
            idx = len(t.sample_sizes)
            t.sample_sizes.append(size)
            t.sample_offsets.append(off)
            t.sample_dts.append(dts)
            t.sample_cts.append(cts)
            t.sample_dur.append(dur)
            # MOV_FRAG_SAMPLE_FLAG_IS_NON_SYNC|DEPENDS_YES (mov.c:3034)
            key = is_audio or not (sf & 0x1010000)
            if key:
                if t.keyframes is None:
                    t.keyframes = set()
                t.keyframes.add(idx + 1)
            dts += dur
            off += size
        t.track_end = dts + t.time_offset
        return off

    # ------------------------------------------------------------------ #

    def _parse_trak(self, data, s, e) -> Optional[_Track]:
        mdia = _find(data, "mdia", s, e)
        if mdia is None:
            return None
        mdhd = _find(data, "mdhd", *mdia)
        timescale = 1000
        if mdhd:
            v = data[mdhd[0]]
            timescale = struct.unpack(
                ">I", data[mdhd[0] + (20 if v else 12):][:4])[0]
        stbl = _find(data, "minf/stbl", *mdia)
        if stbl is None:
            return None
        par, bsf = self._parse_stsd(data, *_find(data, "stsd", *stbl))
        if par is None:
            return None

        t = _Track(timescale=timescale)
        t.bsf = bsf
        st = Stream(codecpar=par, time_base=Rational(1, timescale))
        t.stream = st

        tkhd = _find(data, "tkhd", s, e)
        if tkhd:
            v = data[tkhd[0]]
            t.track_id = struct.unpack(
                ">I", data[tkhd[0] + (20 if v else 12):][:4])[0]

        elst = _find(data, "edts/elst", s, e)
        if elst:
            v = data[elst[0]]
            n = struct.unpack(">I", data[elst[0] + 4:elst[0] + 8])[0]
            entries = []
            p = elst[0] + 8
            for _ in range(min(n, 2)):   # empty-edit + media_time pair
                if v == 1:
                    duration, time = struct.unpack(">Qq", data[p:p + 16])
                    p += 20
                else:
                    duration, time = struct.unpack(">Ii", data[p:p + 8])
                    p += 12
                if time >= -1:
                    entries.append((time, duration))
            if entries:
                t.elst_raw = entries

        # sample sizes
        stsz = _find(data, "stsz", *stbl)
        ss, sp = stsz
        fixed = struct.unpack(">I", data[ss + 4:ss + 8])[0]
        count = struct.unpack(">I", data[ss + 8:ss + 12])[0]
        if fixed:
            t.sample_sizes = [fixed] * count
        else:
            t.sample_sizes = list(struct.unpack(
                f">{count}I", data[ss + 12:ss + 12 + 4 * count]))

        # chunk offsets
        stco = _find(data, "stco", *stbl)
        if stco:
            cs = stco[0]
            n = struct.unpack(">I", data[cs + 4:cs + 8])[0]
            chunk_offsets = list(struct.unpack(
                f">{n}I", data[cs + 8:cs + 8 + 4 * n]))
        else:
            co64 = _find(data, "co64", *stbl)
            cs = co64[0]
            n = struct.unpack(">I", data[cs + 4:cs + 8])[0]
            chunk_offsets = list(struct.unpack(
                f">{n}Q", data[cs + 8:cs + 8 + 8 * n]))

        # sample-to-chunk
        stsc = _find(data, "stsc", *stbl)
        cs = stsc[0]
        n = struct.unpack(">I", data[cs + 4:cs + 8])[0]
        stsc_entries = []
        for i in range(n):
            first, spc, _desc = struct.unpack(
                ">III", data[cs + 8 + 12 * i:cs + 20 + 12 * i])
            stsc_entries.append((first, spc))

        # expand chunk layout -> per-sample file offsets
        sample_i = 0
        nchunks = len(chunk_offsets)
        for ci in range(nchunks):
            spc = 1
            for first, c in stsc_entries:
                if ci + 1 >= first:
                    spc = c
            off = chunk_offsets[ci]
            for _ in range(spc):
                if sample_i >= count:
                    break
                t.sample_offsets.append(off)
                off += t.sample_sizes[sample_i]
                sample_i += 1

        # timestamps
        stts = _find(data, "stts", *stbl)
        cs = stts[0]
        n = struct.unpack(">I", data[cs + 4:cs + 8])[0]
        dts = 0
        for i in range(n):
            cnt, dur = struct.unpack(">II",
                                     data[cs + 8 + 8 * i:cs + 16 + 8 * i])
            for _ in range(cnt):
                t.sample_dts.append(dts)
                t.sample_dur.append(dur)
                dts += dur
        ctts = _find(data, "ctts", *stbl)
        if ctts:
            cs = ctts[0]
            n = struct.unpack(">I", data[cs + 4:cs + 8])[0]
            for i in range(n):
                cnt, off = struct.unpack(
                    ">Ii", data[cs + 8 + 8 * i:cs + 16 + 8 * i])
                t.sample_cts.extend([off] * cnt)
        stss = _find(data, "stss", *stbl)
        if stss:
            cs = stss[0]
            n = struct.unpack(">I", data[cs + 4:cs + 8])[0]
            t.keyframes = set(struct.unpack(
                f">{n}I", data[cs + 8:cs + 8 + 4 * n]))
        return t

    def _parse_stsd(self, data, s, e):
        count = struct.unpack(">I", data[s + 4:s + 8])[0]
        pos = s + 8
        for btype, bs, be in _boxes(data, pos, e):
            name = btype.decode("latin1")
            if name in ("avc1", "avc3"):
                par = CodecParameters(codec_type=MediaType.VIDEO,
                                      codec_id="h264")
                par.width = struct.unpack(">H", data[bs + 24:bs + 26])[0]
                par.height = struct.unpack(">H", data[bs + 26:bs + 28])[0]
                avcc = _find(data, "avcC", bs + 78, be)
                bsf = None
                if avcc:
                    par.extradata = data[avcc[0] - 8:avcc[1]][8:]
                    bsf = H264Mp4ToAnnexB(par.extradata)
                return par, bsf
            if name == "mp4v":
                par = CodecParameters(codec_type=MediaType.VIDEO,
                                      codec_id="mpeg4")
                par.width = struct.unpack(">H", data[bs + 24:bs + 26])[0]
                par.height = struct.unpack(">H", data[bs + 26:bs + 28])[0]
                esds = _find(data, "esds", bs + 78, be)
                if esds:
                    par.extradata = _esds_payload(data[esds[0]:esds[1]])
                    oti = _esds_object_type(data[esds[0]:esds[1]])
                    # 14496-1 objectTypeIndication: 0x60-0x65 MPEG-2,
                    # 0x6A MPEG-1, 0x20 MPEG-4 visual
                    if 0x60 <= oti <= 0x65:
                        par.codec_id = "mpeg2video"
                    elif oti == 0x6A:
                        par.codec_id = "mpeg1video"
                return par, None
            if name == "jpeg":
                par = CodecParameters(codec_type=MediaType.VIDEO,
                                      codec_id="mjpeg")
                par.width = struct.unpack(">H", data[bs + 24:bs + 26])[0]
                par.height = struct.unpack(">H", data[bs + 26:bs + 28])[0]
                return par, None
            if name in ("apch", "apcn", "apcs", "apco", "ap4h"):
                # Apple ProRes (reference: isom.c ff_codec_movvideo_tags)
                par = CodecParameters(codec_type=MediaType.VIDEO,
                                      codec_id="prores")
                par.codec_tag = name
                par.width = struct.unpack(">H", data[bs + 24:bs + 26])[0]
                par.height = struct.unpack(">H", data[bs + 26:bs + 28])[0]
                return par, None
            if name == "mp4a":
                par = CodecParameters(codec_type=MediaType.AUDIO,
                                      codec_id="aac", sample_fmt="fltp")
                par.channels = struct.unpack(">H", data[bs + 16:bs + 18])[0]
                par.sample_rate = struct.unpack(
                    ">I", data[bs + 24:bs + 28])[0] >> 16
                esds = _find(data, "esds", bs + 28, be)
                if esds:
                    asc = _esds_payload(data[esds[0]:esds[1]])
                    par.extradata = asc
                    if len(asc) >= 2:
                        from libav_tpu_torch.codecs.aac.tables import SAMPLE_RATES
                        _, sri, ch = parse_asc(asc)
                        if sri < len(SAMPLE_RATES):
                            par.sample_rate = SAMPLE_RATES[sri]
                        par.channels = ch or par.channels
                return par, None
        return None, None

    # ------------------------------------------------------------------ #

    def read_seek(self, stream_index: int, timestamp: int,
                  flags: int = 0):
        """Seek every track to the last keyframe at or before
        `timestamp` (in the target stream's time_base; reference:
        mov_read_seek + av_index_search_timestamp semantics)."""
        target = None
        for t in self.tracks:
            if t.stream.index == stream_index:
                target = t
                break
        if target is None:
            raise AVError(INVALIDDATA, "bad stream index")
        ts_s = timestamp / target.timescale
        for t in self.tracks:
            want = ts_s * t.timescale
            i = 0
            for k in range(len(t.sample_dts)):
                if t.sample_dts[k] > want:
                    break
                if t.keyframes is None or (k + 1) in t.keyframes:
                    i = k
            t.cursor = i

    def read_packet(self) -> Packet:
        # pick the track with the lowest next dts (in seconds)
        best = None
        for ti, t in enumerate(self.tracks):
            if t.cursor >= len(t.sample_sizes):
                continue
            dts_s = t.sample_dts[t.cursor] / t.timescale if \
                t.cursor < len(t.sample_dts) else 0
            if best is None or dts_s < best[0]:
                best = (dts_s, ti)
        if best is None:
            raise AVError(EOF_)
        t = self.tracks[best[1]]
        i = t.cursor
        t.cursor += 1
        off = t.sample_offsets[i]
        size = t.sample_sizes[i]
        dts = t.sample_dts[i] if i < len(t.sample_dts) else 0
        cts = t.sample_cts[i] if i < len(t.sample_cts) else 0
        pkt = Packet(data=self._data[off:off + size], dts=dts,
                     pts=dts + cts,
                     duration=t.sample_dur[i] if i < len(t.sample_dur) else 0,
                     stream_index=t.stream.index)
        if t.keyframes is None or (i + 1) in t.keyframes:
            pkt.flags |= PKT_FLAG_KEY
        if t.bsf is not None:
            pkt = t.bsf.filter(pkt)[0]
        return pkt


def _esds_object_type(esds: bytes) -> int:
    """objectTypeIndication from the DecoderConfigDescriptor (tag 4)."""
    i = 4                      # skip version/flags
    while i < len(esds):
        tag = esds[i]
        i += 1
        size = 0
        while i < len(esds):
            b = esds[i]
            i += 1
            size = (size << 7) | (b & 0x7F)
            if not (b & 0x80):
                break
        if tag == 0x03:        # ES_Descriptor: dive in
            i += 3
            continue
        if tag == 0x04:        # DecoderConfigDescriptor
            return esds[i] if i < len(esds) else 0
        i += size
    return 0


def _esds_payload(esds: bytes) -> bytes:
    """Extract DecoderSpecificInfo from an esds box payload."""
    pos = 4  # version/flags

    def read_desc(p):
        tag = esds[p]
        p += 1
        ln = 0
        for _ in range(4):
            b = esds[p]
            p += 1
            ln = (ln << 7) | (b & 0x7F)
            if not (b & 0x80):
                break
        return tag, ln, p

    while pos < len(esds):
        tag, ln, pos = read_desc(pos)
        if tag == 0x03:          # ES descriptor
            pos += 3
        elif tag == 0x04:        # DecoderConfig
            pos += 13
        elif tag == 0x05:        # DecoderSpecificInfo
            return esds[pos:pos + ln]
        else:
            pos += ln
    return b""


# ---------------------------------------------------------------------- #
# Muxer
# ---------------------------------------------------------------------- #

def _box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload) + 8) + btype + payload


def _full(btype: bytes, payload: bytes, version=0, flags=0) -> bytes:
    return _box(btype, struct.pack(">I", (version << 24) | flags) + payload)


def _esds_box(object_type: int, dsi: bytes) -> bytes:
    def desc(tag, body):
        return bytes([tag, len(body)]) + body
    dec_spec = desc(0x05, dsi)
    dec_conf = desc(0x04, bytes([object_type, 0x15]) + b"\x00\x00\x00" +
                    struct.pack(">II", 0, 0) + dec_spec)
    es = desc(0x03, struct.pack(">HB", 1, 0) + dec_conf + desc(0x06, b"\x02"))
    return _full(b"esds", es)


@register_output
class MP4Muxer(OutputFormat):
    NAME = "mp4,mov"
    EXTENSIONS = ("mp4", "mov", "m4a")
    VIDEO_CODEC = "mpeg4"
    AUDIO_CODEC = "aac"

    def write_header(self, pb):
        self.pb = pb
        self._samples: List[List] = [[] for _ in self.streams]
        self._bsf_state: List[Dict] = [dict() for _ in self.streams]

    def write_packet(self, pkt: Packet):
        st = self.streams[pkt.stream_index]
        state = self._bsf_state[pkt.stream_index]
        data = pkt.data
        if st.codecpar.codec_id == "h264":
            from libav_tpu_torch.codecs.h264.nal import split_annexb, nal_header
            body = []
            for nal in split_annexb(data):
                t = nal_header(nal)[1]
                if t == 7:
                    state["sps"] = nal
                elif t == 8:
                    state["pps"] = nal
                else:
                    body.append(nal)
            data = b"".join(len(n).to_bytes(4, "big") + n for n in body)
        elif st.codecpar.codec_id == "mpeg4":
            i = data.find(b"\x00\x00\x01\xB6")
            if i > 0 and "vol" not in state:
                state["vol"] = data[:i]
        elif st.codecpar.codec_id == "aac":
            from libav_tpu_torch.codecs.aac.dec import parse_adts_header
            hdr = parse_adts_header(data)
            if hdr:
                from libav_tpu_torch.codecs.aac.tables import SAMPLE_RATES
                if "asc" not in state:
                    state["asc"] = make_asc(SAMPLE_RATES.index(hdr[0]),
                                            hdr[1])
                data = data[hdr[3]:hdr[2]]
        self._samples[pkt.stream_index].append(
            (data, pkt.dts, pkt.pts, pkt.duration, pkt.is_key))

    def write_trailer(self):
        pb = self.pb
        pb.write(_box(b"ftyp", b"isom" + struct.pack(">I", 512) +
                      b"isomiso2mp41"))
        # mdat
        mdat_payload = bytearray()
        offsets: List[List[int]] = []
        base = pb.tell() + 8
        for si, samples in enumerate(self._samples):
            offs = []
            for (data, *_rest) in samples:
                offs.append(base + len(mdat_payload))
                mdat_payload += data
            offsets.append(offs)
        pb.write(_box(b"mdat", bytes(mdat_payload)))
        pb.write(_box(b"moov", self._moov(offsets)))

    # ------------------------------------------------------------------ #

    def _moov(self, offsets) -> bytes:
        max_dur = 0
        traks = b""
        for si, st in enumerate(self.streams):
            trak, dur_s = self._trak(si, st, offsets[si])
            traks += trak
            max_dur = max(max_dur, dur_s)
        mvhd = _full(b"mvhd", struct.pack(
            ">IIII", 0, 0, 1000, int(max_dur * 1000)) +
            struct.pack(">IH", 0x00010000, 0x0100) + b"\x00" * 10 +
            struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                        0x40000000) + b"\x00" * 24 +
            struct.pack(">I", len(self.streams) + 1))
        return mvhd + traks

    def _trak(self, si, st, offs) -> Tuple[bytes, float]:
        samples = self._samples[si]
        state = self._bsf_state[si]
        par = st.codecpar
        ts = st.time_base.den if st.time_base.num == 1 else 90000
        n = len(samples)
        total = sum(s[3] if s[3] else 1 for s in samples)
        dur_s = total * st.time_base.num / st.time_base.den if n else 0

        # stsd
        if par.codec_type == MediaType.VIDEO:
            w, h = par.width, par.height
            vhdr = (struct.pack(">IHH", 0, 0, 0) + b"\x00" * 16 +
                    struct.pack(">HH", w, h) +
                    struct.pack(">IIIH", 0x00480000, 0x00480000, 0, 1) +
                    b"\x00" * 32 + struct.pack(">Hh", 0x18, -1))
            if par.codec_id == "h264":
                sps = state.get("sps", b"")
                pps = state.get("pps", b"")
                entry = _box(b"avc1", vhdr + _box(b"avcC",
                                                  make_avcc(sps, pps)))
            elif par.codec_id == "mpeg4":
                entry = _box(b"mp4v", vhdr + _esds_box(
                    0x20, state.get("vol", par.extradata or b"")))
            elif par.codec_id == "mpeg2video":
                entry = _box(b"mp4v", vhdr + _esds_box(0x61, b""))
            elif par.codec_id == "mpeg1video":
                entry = _box(b"mp4v", vhdr + _esds_box(0x6A, b""))
            elif par.codec_id == "mjpeg":
                entry = _box(b"jpeg", vhdr)
            elif par.codec_id == "prores":
                tag = par.codec_tag if isinstance(par.codec_tag, str) and \
                    par.codec_tag else "apcn"
                entry = _box(tag.encode("latin1"), vhdr)
            else:
                raise AVError(INVALIDDATA,
                              f"mp4: no sample entry for {par.codec_id}")
            hdlr_type = b"vide"
            mhd = _full(b"vmhd", struct.pack(">HHHH", 0, 0, 0, 0), flags=1)
        else:
            ahdr = (struct.pack(">IHH", 0, 0, 0) +      # reserved + dref
                    b"\x00" * 8 +                        # version/rev/vendor
                    struct.pack(">HHHHI", par.channels, 16, 0, 0,
                                par.sample_rate << 16))
            asc = state.get("asc") or par.extradata or make_asc(4, 2)
            entry = _box(b"mp4a", ahdr + _esds_box(0x40, asc))
            hdlr_type = b"soun"
            mhd = _full(b"smhd", struct.pack(">HH", 0, 0))

        stsd = _full(b"stsd", struct.pack(">I", 1) + entry)
        # stts (run-length of durations)
        runs = []
        for (_, _, _, dur, _) in samples:
            d = dur if dur else 1
            d_ts = d * ts * st.time_base.num // st.time_base.den
            if runs and runs[-1][1] == d_ts:
                runs[-1][0] += 1
            else:
                runs.append([1, d_ts])
        stts = _full(b"stts", struct.pack(">I", len(runs)) +
                     b"".join(struct.pack(">II", c, d) for c, d in runs))
        stsc = _full(b"stsc", struct.pack(">I", 1) +
                     struct.pack(">III", 1, 1, 1))
        stsz = _full(b"stsz", struct.pack(">II", 0, n) +
                     b"".join(struct.pack(">I", len(s[0])) for s in samples))
        stco = _full(b"stco", struct.pack(">I", n) +
                     b"".join(struct.pack(">I", o) for o in offs))
        keys = [i + 1 for i, s in enumerate(samples) if s[4]]
        stbl_children = stsd + stts + stsc + stsz + stco
        # ctts (composition offsets) when any pts differs from dts
        # (B-frame reordering; version 0 uses unsigned offsets, which a
        # one-frame dts delay guarantees)
        ctts_runs = []
        need_ctts = False
        for (_, dts, pts, _, _) in samples:
            off = 0
            if pts is not None and dts is not None:
                off = (pts - dts) * ts * st.time_base.num \
                    // st.time_base.den
            if off:
                need_ctts = True
            if ctts_runs and ctts_runs[-1][1] == off:
                ctts_runs[-1][0] += 1
            else:
                ctts_runs.append([1, off])
        if need_ctts:
            stbl_children += _full(
                b"ctts", struct.pack(">I", len(ctts_runs)) +
                b"".join(struct.pack(">Ii", c, o) for c, o in ctts_runs))
        if keys and len(keys) != n:
            stbl_children += _full(b"stss", struct.pack(">I", len(keys)) +
                                   b"".join(struct.pack(">I", k)
                                            for k in keys))
        stbl = _box(b"stbl", stbl_children)
        url_ = _full(b"url ", b"", flags=1)
        dinf = _box(b"dinf", _full(b"dref", struct.pack(">I", 1) + url_))
        minf = _box(b"minf", mhd + dinf + stbl)
        hdlr = _full(b"hdlr", struct.pack(">I", 0) + hdlr_type +
                     b"\x00" * 12 + b"libav-tpu\x00")
        dur_ts = int(dur_s * ts)
        mdhd = _full(b"mdhd", struct.pack(">IIIIHH", 0, 0, ts, dur_ts,
                                          0x55C4, 0))
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        w = getattr(par, "width", 0) or 0
        h = getattr(par, "height", 0) or 0
        tkhd = _full(b"tkhd", struct.pack(
            ">IIIII", 0, 0, si + 1, 0, int(dur_s * 1000)) + b"\x00" * 16 +
            struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                        0x40000000) +
            struct.pack(">II", w << 16, h << 16), flags=7)
        return _box(b"trak", tkhd + mdia), dur_s
