"""MPEG transport stream demuxer (reference: libavformat/mpegts.c (2406))
and a minimal single-program muxer (mpegtsenc.c role)."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

from libav_tpu_torch.avutil.crc import crc32_mpeg2
from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import NOPTS_VALUE, Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)

TS_SIZE = 188

_STREAM_TYPE_TO_CODEC = {
    0x01: ("mpeg1video", MediaType.VIDEO),
    0x02: ("mpeg2video", MediaType.VIDEO),
    0x10: ("mpeg4", MediaType.VIDEO),
    0x1B: ("h264", MediaType.VIDEO),
    0x0F: ("aac", MediaType.AUDIO),
    0x11: ("aac", MediaType.AUDIO),
    0x81: ("ac3", MediaType.AUDIO),
    0x03: ("mp3", MediaType.AUDIO),
    0x04: ("mp3", MediaType.AUDIO),
}
_CODEC_TO_STREAM_TYPE = {"mpeg1video": 0x01, "mpeg2video": 0x02,
                         "mpeg4": 0x10, "h264": 0x1B, "aac": 0x0F,
                         "ac3": 0x81}


def _parse_pts(b: bytes) -> int:
    return (((b[0] >> 1) & 7) << 30) | (b[1] << 22) | ((b[2] >> 1) << 15) | \
        (b[3] << 7) | (b[4] >> 1)


@register_input
class MpegTSDemuxer(InputFormat):
    NAME = "mpegts"
    EXTENSIONS = ("ts", "m2t", "m2ts", "mts")

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        # several sync bytes at 188 spacing
        if len(data) >= TS_SIZE * 3:
            hits = sum(1 for i in range(3) if data[i * TS_SIZE] == 0x47)
            if hits == 3:
                return 95
        return 0

    def read_header(self, pb):
        self.pb = pb
        self._data = pb.read_all()
        self.streams = []
        self._pid_to_stream: Dict[int, Stream] = {}
        self._pes_buf: Dict[int, bytearray] = {}
        self._pes_pts: Dict[int, int] = {}
        self._queue: List[Packet] = []
        self._pos = 0
        self._pmt_pids: set = set()
        self._last_cc: Dict[int, int] = {}
        self._pes_corrupt: set = set()
        # pre-scan for PAT/PMT so streams exist before read_packet
        save = self._pos
        scanned = 0
        while self._pos + TS_SIZE <= len(self._data) and scanned < 2000:
            self._parse_ts_packet(collect=False)
            scanned += 1
            if self.streams and scanned > 100:
                break
        self._pos = save
        self._pes_buf.clear()
        self._pes_pts.clear()
        self._last_cc.clear()
        self._pes_corrupt.clear()
        if not self.streams:
            raise AVError(INVALIDDATA, "no streams found in TS")

    # ------------------------------------------------------------------ #

    def _parse_ts_packet(self, collect=True):
        data = self._data
        pos = self._pos
        # resync
        while pos < len(data) and data[pos] != 0x47:
            pos += 1
        if pos + TS_SIZE > len(data):
            self._pos = len(data)
            return False
        pkt = data[pos:pos + TS_SIZE]
        self._pos = pos + TS_SIZE
        pusi = (pkt[1] >> 6) & 1
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        afc = (pkt[3] >> 4) & 3
        cc = pkt[3] & 0xF
        p = 4
        is_discont = False
        if afc & 2:
            aflen = pkt[4]
            if aflen > 0:
                is_discont = bool(pkt[5] & 0x80)   # discontinuity flag
            p += 1 + aflen
        # continuity check (reference mpegts.c:1838-1853): a gap marks
        # the in-flight PES corrupt; the packet still flows so the
        # decoder's error resilience gets a shot at it
        has_payload = bool(afc & 1)
        last = self._last_cc.get(pid, -1)
        expected = ((last + 1) & 0xF) if has_payload else last
        cc_ok = (pid == 0x1FFF or is_discont or last < 0 or
                 expected == cc)
        self._last_cc[pid] = cc
        if not cc_ok:
            from libav_tpu_torch.avutil import log
            log.warning("mpegts", "Continuity check failed for pid "
                        f"{pid} expected {expected} got {cc}")
            if pid in self._pid_to_stream:
                self._pes_corrupt.add(pid)
        if not has_payload or p >= TS_SIZE:
            return True
        payload = pkt[p:]

        if pid == 0:                     # PAT
            self._parse_pat(payload, pusi)
        elif pid in self._pmt_pids:
            self._parse_pmt(payload, pusi)
        elif pid in self._pid_to_stream:
            self._pes(pid, payload, pusi, collect)
        return True

    def _section(self, payload, pusi):
        if pusi:
            ptr = payload[0]
            return payload[1 + ptr:]
        return payload

    def _parse_pat(self, payload, pusi):
        s = self._section(payload, pusi)
        if not s or s[0] != 0x00:
            return
        slen = ((s[1] & 0xF) << 8) | s[2]
        pos = 8
        end = 3 + slen - 4
        while pos + 4 <= end:
            prog = (s[pos] << 8) | s[pos + 1]
            pid = ((s[pos + 2] & 0x1F) << 8) | s[pos + 3]
            if prog != 0:
                self._pmt_pids.add(pid)
            pos += 4

    def _parse_pmt(self, payload, pusi):
        s = self._section(payload, pusi)
        if not s or s[0] != 0x02:
            return
        slen = ((s[1] & 0xF) << 8) | s[2]
        pinfo = ((s[10] & 0xF) << 8) | s[11]
        pos = 12 + pinfo
        end = 3 + slen - 4
        while pos + 5 <= end:
            stype = s[pos]
            pid = ((s[pos + 1] & 0x1F) << 8) | s[pos + 2]
            eslen = ((s[pos + 3] & 0xF) << 8) | s[pos + 4]
            pos += 5 + eslen
            if pid in self._pid_to_stream:
                continue
            info = _STREAM_TYPE_TO_CODEC.get(stype)
            if info is None:
                continue
            codec, mtype = info
            par = CodecParameters(codec_type=mtype, codec_id=codec)
            if mtype == MediaType.AUDIO:
                par.sample_fmt = "fltp"
            st = Stream(index=len(self.streams), codecpar=par,
                        time_base=Rational(1, 90000),
                        # PES payloads are not codec-frame aligned for
                        # audio: run the codec parser (utils.c:816)
                        need_parsing=(mtype == MediaType.AUDIO))
            self.streams.append(st)
            self._pid_to_stream[pid] = st

    def _pes(self, pid, payload, pusi, collect):
        if pusi:
            self._flush_pes(pid, collect)
            self._pes_buf[pid] = bytearray(payload)
        elif pid in self._pes_buf:
            self._pes_buf[pid] += payload

    def _flush_pes(self, pid, collect=True):
        buf = self._pes_buf.pop(pid, None)
        if not buf or not collect:
            return
        if buf[:3] != b"\x00\x00\x01":
            return
        flags = buf[7]
        hlen = buf[8]
        pts = dts = NOPTS_VALUE
        if flags & 0x80:
            pts = _parse_pts(buf[9:14])
            dts = pts
        if flags & 0x40:
            dts = _parse_pts(buf[14:19])
        body = bytes(buf[9 + hlen:])
        st = self._pid_to_stream[pid]
        from libav_tpu_torch.avutil.frame import PKT_FLAG_CORRUPT
        from libav_tpu_torch.formats.api import sniff_key
        key = sniff_key(st.codecpar.codec_id, body)
        flags = PKT_FLAG_KEY if key else 0
        if pid in self._pes_corrupt:
            self._pes_corrupt.discard(pid)
            flags |= PKT_FLAG_CORRUPT
        self._queue.append(Packet(data=body, pts=pts, dts=dts,
                                  stream_index=st.index, flags=flags))
        self._pes_pts[pid] = pts

    def read_packet(self) -> Packet:
        while not self._queue:
            if not self._parse_ts_packet():
                # EOF: flush remaining PES buffers
                for pid in list(self._pes_buf):
                    self._flush_pes(pid)
                if self._queue:
                    break
                raise AVError(EOF_)
        return self._queue.pop(0)

    def _reset(self):
        self._pos = 0
        self._queue = []
        self._pes_buf.clear()
        self._pes_pts.clear()
        self._last_cc.clear()
        self._pes_corrupt.clear()

    def read_seek(self, stream_index: int, timestamp: int, flags: int = 0):
        """Two-pass linear scan to the last keyframe at/before timestamp
        (reference: mpegts read_timestamp binary search; the in-memory
        buffer makes a linear scan exact)."""
        self._reset()
        best = -1
        n = 0
        while True:
            try:
                pkt = self.read_packet()
            except AVError:
                break
            if pkt.stream_index == stream_index:
                if pkt.pts != NOPTS_VALUE and pkt.pts > timestamp:
                    break
                if pkt.is_key and (pkt.pts == NOPTS_VALUE or
                                   pkt.pts <= timestamp):
                    best = n
            n += 1
        self._reset()
        for _ in range(max(0, best)):
            self.read_packet()


@register_output
class MpegTSMuxer(OutputFormat):
    """Single-program TS muxer: PAT+PMT retransmitted periodically and
    on video keyframes (reference mpegtsenc.c retransmit_si_info, VBR
    pat_packet_period=40), PCR on the PMT-declared PCR_PID (the video
    pid when a video stream exists, else the first ES pid) at each
    keyframe and every ~20ms of dts (PCR_RETRANS_TIME,
    mpegtsenc.c:197,873-895; VBR pcr = dts*300), Random Access
    indicator on keyframe starts (:905-910)."""

    NAME = "mpegts"
    EXTENSIONS = ("ts",)
    VIDEO_CODEC = "mpeg2video"
    AUDIO_CODEC = "ac3"

    PMT_PID = 0x100
    ES_PID0 = 0x101
    PCR_RETRANS_90K = 20 * 90            # 20 ms in 90 kHz units
    PAT_PES_PERIOD = 40                  # PES starts between PSI bursts

    def write_header(self, pb):
        self.pb = pb
        self._cc: Dict[int, int] = {}
        self._wrote_psi = False
        self._last_pcr: Optional[int] = None
        self._pes_since_psi = 0

    def _ts_packet(self, pid, payload, pusi=False, af_flags=0, pcr=None):
        cc = self._cc.get(pid, 0)
        self._cc[pid] = (cc + 1) & 0xF
        hdr = bytes([0x47, (0x40 if pusi else 0) | (pid >> 8), pid & 0xFF])
        # adaptation field: needed for flags/PCR and for stuffing short
        # payloads up to 188 bytes
        af_body = b""
        if pcr is not None:
            af_flags |= 0x10
        if af_flags:
            base, ext = (pcr // 300, pcr % 300) if pcr is not None \
                else (0, 0)
            af_body = bytes([af_flags])
            if pcr is not None:
                af_body += bytes([
                    (base >> 25) & 0xFF, (base >> 17) & 0xFF,
                    (base >> 9) & 0xFF, (base >> 1) & 0xFF,
                    ((base & 1) << 7) | 0x7E | ((ext >> 8) & 1),
                    ext & 0xFF])
        room = TS_SIZE - 4 - (1 + len(af_body) if af_body else 0)
        payload = payload[:room]
        needed = room - len(payload)
        if needed > 0 and not af_body:
            if needed == 1:
                af = b"\x00"
            else:
                af = bytes([needed - 1, 0x00]) + b"\xff" * (needed - 2)
            return hdr + bytes([0x30 | cc]) + af + payload
        if af_body:
            stuff = b"\xff" * needed
            af = bytes([len(af_body) + needed]) + af_body + stuff
            return hdr + bytes([0x30 | cc]) + af + payload
        return hdr + bytes([0x10 | cc]) + payload

    def _psi(self, pid, table):
        sec = table + struct.pack(">I", crc32_mpeg2(table))
        return self._ts_packet(pid, b"\x00" + sec, pusi=True)

    def _pcr_pid(self) -> int:
        # PCR rides the video pid when there is one (reference
        # mpegtsenc.c picks the first video stream as pcr_st),
        # otherwise the first ES pid
        for si, st in enumerate(self.streams):
            if st.codecpar.codec_type == MediaType.VIDEO:
                return self.ES_PID0 + si
        return self.ES_PID0

    def _write_psi(self):
        # PAT
        pat = bytes([0x00, 0xB0, 13, 0, 1, 0xC1, 0, 0,
                     0, 1, 0xE0 | (self.PMT_PID >> 8), self.PMT_PID & 0xFF])
        self.pb.write(self._psi(0, pat))
        # PMT
        es = b""
        for si, st in enumerate(self.streams):
            stype = _CODEC_TO_STREAM_TYPE.get(st.codecpar.codec_id, 0x06)
            pid = self.ES_PID0 + si
            es += bytes([stype, 0xE0 | (pid >> 8), pid & 0xFF, 0xF0, 0])
        pcr_pid = self._pcr_pid()
        pmt = bytes([0x02, 0xB0, 13 + len(es), 0, 1, 0xC1, 0, 0,
                     0xE0 | (pcr_pid >> 8), pcr_pid & 0xFF,
                     0xF0, 0]) + es
        self.pb.write(self._psi(self.PMT_PID, pmt))

    @staticmethod
    def _pts_bytes(pts, tag):
        return bytes([
            (tag << 4) | (((pts >> 30) & 7) << 1) | 1,
            (pts >> 22) & 0xFF,
            (((pts >> 15) & 0x7F) << 1) | 1,
            (pts >> 7) & 0xFF,
            ((pts & 0x7F) << 1) | 1])

    def write_packet(self, pkt: Packet):
        st = self.streams[pkt.stream_index]
        pid = self.ES_PID0 + pkt.stream_index
        is_video = st.codecpar.codec_type == MediaType.VIDEO
        key = bool(pkt.flags & PKT_FLAG_KEY)
        # PSI: at start, every PAT_PES_PERIOD PES, and on video keys
        if not self._wrote_psi or (is_video and key) or \
                self._pes_since_psi >= self.PAT_PES_PERIOD:
            self._write_psi()
            self._wrote_psi = True
            self._pes_since_psi = 0
        self._pes_since_psi += 1
        # pts/dts in 90 kHz
        from libav_tpu_torch.avutil.rational import rescale_q
        pts = pkt.pts if pkt.pts != NOPTS_VALUE else 0
        dts = pkt.dts if pkt.dts != NOPTS_VALUE else pts
        tb90 = Rational(1, 90000)
        pts90 = rescale_q(pts, st.time_base, tb90) & ((1 << 33) - 1)
        dts90 = rescale_q(dts, st.time_base, tb90) & ((1 << 33) - 1)
        sid = 0xE0 if is_video else 0xC0
        if pts90 != dts90:
            pes_hdr = (b"\x00\x00\x01" + bytes([sid]) +
                       struct.pack(">H", 0) +
                       bytes([0x80, 0xC0, 10]) +
                       self._pts_bytes(pts90, 3) +
                       self._pts_bytes(dts90, 1))
        else:
            pes_hdr = (b"\x00\x00\x01" + bytes([sid]) +
                       struct.pack(">H", 0) +   # unbounded (video ok)
                       bytes([0x80, 0x80, 5]) + self._pts_bytes(pts90, 2))
        pes = pes_hdr + pkt.data
        # PCR rides the PMT-declared PCR_PID (the video pid when there
        # is one): on keyframes and when >=20ms of dts passed since
        # the last one
        pcr = None
        if pid == self._pcr_pid():
            if key or self._last_pcr is None or \
                    dts90 - self._last_pcr >= self.PCR_RETRANS_90K:
                pcr = dts90 * 300
                self._last_pcr = dts90
        af_flags = 0x40 if (key and is_video) else 0   # random access
        first = True
        pos = 0
        while pos < len(pes):
            room = TS_SIZE - 4
            if first and (pcr is not None or af_flags):
                room -= 1 + 1 + (6 if pcr is not None else 0)
            chunk = pes[pos:pos + room]
            self.pb.write(self._ts_packet(
                pid, chunk, pusi=first,
                af_flags=af_flags if first else 0,
                pcr=pcr if first else None))
            first = False
            pos += len(chunk)
