"""Bitstream filters (reference: libavcodec/bsf.c (245) + the 22 BSFs in
bitstream_filters.c — notably h264_mp4toannexb_bsf.c, aac_adtstoasc_bsf.c,
extract_extradata_bsf.c; API av_bsf_send_packet/receive_packet bsf.h)."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Type

from libav_tpu_torch.avutil.error import AVError, BSF_NOT_FOUND, INVALIDDATA
from libav_tpu_torch.avutil.frame import Packet

_BSFS: Dict[str, Type["BitStreamFilter"]] = {}


def register_bsf(cls):
    _BSFS[cls.NAME] = cls
    return cls


def find_bsf(name: str) -> Type["BitStreamFilter"]:
    if name not in _BSFS:
        raise AVError(BSF_NOT_FOUND, name)
    return _BSFS[name]


class BitStreamFilter:
    """reference: bsf.h AVBSFContext (send/receive collapsed to filter())"""

    NAME = "none"

    def __init__(self, extradata: bytes = b""):
        self.extradata = extradata

    def filter(self, pkt: Packet) -> List[Packet]:
        return [pkt]


@register_bsf
class NullBSF(BitStreamFilter):
    NAME = "null"


# ---------------------------------------------------------------------- #
# H.264 AVCC <-> Annex B
# ---------------------------------------------------------------------- #

def parse_avcc(extradata: bytes):
    """AVCDecoderConfigurationRecord -> (sps_list, pps_list, nal_len_size)
    (reference: h264_mp4toannexb_bsf.c h264_extradata_to_annexb)."""
    if len(extradata) < 7 or extradata[0] != 1:
        raise AVError(INVALIDDATA, "bad avcC")
    nal_len = (extradata[4] & 3) + 1
    pos = 5
    n_sps = extradata[pos] & 0x1F
    pos += 1
    sps = []
    for _ in range(n_sps):
        ln = struct.unpack(">H", extradata[pos:pos + 2])[0]
        pos += 2
        sps.append(extradata[pos:pos + ln])
        pos += ln
    n_pps = extradata[pos]
    pos += 1
    pps = []
    for _ in range(n_pps):
        ln = struct.unpack(">H", extradata[pos:pos + 2])[0]
        pos += 2
        pps.append(extradata[pos:pos + ln])
        pos += ln
    return sps, pps, nal_len


def make_avcc(sps: bytes, pps: bytes) -> bytes:
    """SPS/PPS NALs (no start codes) -> AVCDecoderConfigurationRecord."""
    out = bytearray([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
    out += struct.pack(">H", len(sps)) + sps
    out += bytes([1]) + struct.pack(">H", len(pps)) + pps
    return bytes(out)


def avcc_to_annexb(data: bytes, nal_len_size: int = 4) -> bytes:
    """Length-prefixed NALs -> start-code NALs."""
    out = bytearray()
    pos = 0
    while pos + nal_len_size <= len(data):
        ln = int.from_bytes(data[pos:pos + nal_len_size], "big")
        pos += nal_len_size
        out += b"\x00\x00\x00\x01" + data[pos:pos + ln]
        pos += ln
    return bytes(out)


def annexb_to_avcc(data: bytes, nal_len_size: int = 4) -> bytes:
    from libav_tpu_torch.codecs.h264.nal import split_annexb
    out = bytearray()
    for nal in split_annexb(data):
        out += len(nal).to_bytes(nal_len_size, "big") + nal
    return bytes(out)


@register_bsf
class H264Mp4ToAnnexB(BitStreamFilter):
    """reference: h264_mp4toannexb_bsf.c"""

    NAME = "h264_mp4toannexb"

    def __init__(self, extradata: bytes = b""):
        super().__init__(extradata)
        self._header = b""
        self._nal_len = 4
        self._sent_header = False
        if extradata and extradata[:1] == b"\x01":
            sps, pps, self._nal_len = parse_avcc(extradata)
            for n in sps + pps:
                self._header += b"\x00\x00\x00\x01" + n

    def filter(self, pkt: Packet) -> List[Packet]:
        out = pkt.clone()
        body = avcc_to_annexb(pkt.data, self._nal_len)
        if pkt.is_key or not self._sent_header:
            out.data = self._header + body
            self._sent_header = True
        else:
            out.data = body
        return [out]


# ---------------------------------------------------------------------- #
# AAC ADTS <-> AudioSpecificConfig
# ---------------------------------------------------------------------- #

def make_asc(sr_index: int, channels: int, object_type: int = 2) -> bytes:
    """AudioSpecificConfig for AAC-LC (reference: aac_adtstoasc_bsf.c)."""
    v = (object_type << 11) | (sr_index << 7) | (channels << 3)
    return struct.pack(">H", v)


def parse_asc(asc: bytes):
    """-> (object_type, sr_index, channels)"""
    v = struct.unpack(">H", asc[:2])[0]
    return (v >> 11) & 0x1F, (v >> 7) & 0xF, (v >> 3) & 0xF


@register_bsf
class AacAdtsToAsc(BitStreamFilter):
    """Strip ADTS headers (reference: aac_adtstoasc_bsf.c). The resulting
    extradata (ASC) is exposed on .extradata after the first packet."""

    NAME = "aac_adtstoasc"

    def filter(self, pkt: Packet) -> List[Packet]:
        from libav_tpu_torch.codecs.aac.dec import parse_adts_header
        hdr = parse_adts_header(pkt.data)
        if hdr is None:
            return [pkt]
        sample_rate, ch, frame_len, hlen = hdr
        from libav_tpu_torch.codecs.aac.tables import SAMPLE_RATES
        if not self.extradata:
            self.extradata = make_asc(SAMPLE_RATES.index(sample_rate), ch)
        out = pkt.clone()
        out.data = pkt.data[hlen:frame_len]
        return [out]


@register_bsf
class AacAscToAdts(BitStreamFilter):
    """Re-add ADTS headers from ASC extradata (mux->raw direction)."""

    NAME = "aac_asctoadts"

    def filter(self, pkt: Packet) -> List[Packet]:
        from libav_tpu_torch.bitstream import PutBits
        obj, sri, ch = parse_asc(self.extradata)
        pb = PutBits()
        frame_len = len(pkt.data) + 7
        pb.put_bits(12, 0xFFF)
        pb.put_bits(1, 1)
        pb.put_bits(2, 0)
        pb.put_bits(1, 1)
        pb.put_bits(2, obj - 1)
        pb.put_bits(4, sri)
        pb.put_bits(1, 0)
        pb.put_bits(3, ch)
        pb.put_bits(4, 0)
        pb.put_bits(13, frame_len)
        pb.put_bits(11, 0x7FF)
        pb.put_bits(2, 0)
        out = pkt.clone()
        out.data = pb.flush() + pkt.data
        return [out]


@register_bsf
class ExtractExtradata(BitStreamFilter):
    """Pull SPS/PPS (h264) or VOS..VOL headers (mpeg4) out of the stream
    into .extradata (reference: extract_extradata_bsf.c)."""

    NAME = "extract_extradata"

    def __init__(self, extradata: bytes = b"", codec_id: str = "h264"):
        super().__init__(extradata)
        self.codec_id = codec_id

    def filter(self, pkt: Packet) -> List[Packet]:
        if self.extradata:
            return [pkt]
        if self.codec_id == "h264":
            from libav_tpu_torch.codecs.h264.nal import split_annexb, nal_header
            header = bytearray()
            for nal in split_annexb(pkt.data):
                if nal_header(nal)[1] in (7, 8):
                    header += b"\x00\x00\x00\x01" + nal
            self.extradata = bytes(header)
        elif self.codec_id == "mpeg4":
            i = pkt.data.find(b"\x00\x00\x01\xB6")
            if i > 0:
                self.extradata = pkt.data[:i]
        return [pkt]
