"""Raw FLAC container (reference: libavformat/flacdec.c raw demuxer +
flacenc.c muxer — 'fLaC' magic, metadata blocks, then frames).  The
demuxer hands the decoder byte chunks (frame lengths are only known by
decoding, so the decoder's internal buffer does the framing, like the
reference's parser); STREAMINFO supplies the stream parameters."""

from __future__ import annotations

from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat, Stream,
                                   register_input, register_output)

_CHUNK = 1 << 16


@register_input
class FlacDemuxer(InputFormat):
    NAME = "flac"
    EXTENSIONS = ("flac",)

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        return 100 if data[:4] == b"fLaC" else 0

    def read_header(self, pb):
        self.pb = pb
        data = pb.read_all()
        if data[:4] != b"fLaC":
            raise AVError(INVALIDDATA, "flac: bad magic")
        pos = 4
        sr, ch, bps, total = 44100, 2, 16, 0
        extradata = b""
        last = False
        while not last and pos + 4 <= len(data):
            hdr = data[pos]
            last = bool(hdr & 0x80)
            btype = hdr & 0x7F
            size = int.from_bytes(data[pos + 1:pos + 4], "big")
            if btype == 0:
                si = data[pos + 4:pos + 4 + size]
                extradata = si
                gb = GetBits(si)
                gb.skip_bits(16 + 16 + 24 + 24)
                sr = gb.get_bits(20)
                ch = gb.get_bits(3) + 1
                bps = gb.get_bits(5) + 1
                total = (gb.get_bits(4) << 32) | gb.get_bits(32)
            pos += 4 + size
        self._data = data
        self._pos = pos        # frame data starts after the metadata
        self._pts = 0
        par = CodecParameters(
            codec_type=MediaType.AUDIO, codec_id="flac",
            sample_rate=sr, channels=ch, sample_fmt="s16",
            extradata=extradata)
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, sr or 44100))]
        self._duration = total

    @staticmethod
    def _frame_header(data: bytes, pos: int):
        """Parse+validate a frame header at pos (sync, crc8) ->
        blocksize or None (flac_parser.c frame boundary check)."""
        from libav_tpu_torch.codecs.flac.dec import crc8, _utf8_num
        if pos + 5 > len(data) or data[pos] != 0xFF or \
                (data[pos + 1] & 0xFC) != 0xF8:
            return None
        try:
            gb = GetBits(data[pos:pos + 24])
            gb.skip_bits(16)
            bs_code = gb.get_bits(4)
            sr_code = gb.get_bits(4)
            gb.skip_bits(8)
            _utf8_num(gb)
            from libav_tpu_torch.codecs.flac.dec import BLOCK_SIZES
            if bs_code == 6:
                blocksize = gb.get_bits(8) + 1
            elif bs_code == 7:
                blocksize = gb.get_bits(16) + 1
            else:
                blocksize = BLOCK_SIZES[bs_code]
            if sr_code == 12:
                gb.get_bits(8)
            elif sr_code in (13, 14):
                gb.get_bits(16)
            hdr_len = (gb.pos + 7) >> 3
            if crc8(data[pos:pos + hdr_len]) != gb.get_bits(8):
                return None
            return blocksize or None
        except AVError:
            return None

    def read_packet(self) -> Packet:
        data, pos = self._data, self._pos
        if pos >= len(data):
            raise AVError(EOF_)
        blocksize = self._frame_header(data, pos)
        if blocksize is None:
            raise AVError(EOF_, "flac: lost frame sync")
        # frame length = distance to the next validated sync (or EOF)
        end = pos + 16
        while end < len(data):
            if data[end] == 0xFF and (data[end + 1] & 0xFC) == 0xF8 \
                    if end + 1 < len(data) else False:
                if self._frame_header(data, end) is not None:
                    break
            end += 1
        chunk = data[pos:end if end < len(data) else len(data)]
        self._pos = pos + len(chunk)
        pkt = Packet(data=chunk, pts=self._pts, dts=self._pts,
                     duration=blocksize, stream_index=0,
                     flags=PKT_FLAG_KEY)
        self._pts += blocksize
        return pkt


@register_output
class FlacMuxer(OutputFormat):
    NAME = "flac"
    EXTENSIONS = ("flac",)
    AUDIO_CODEC = "flac"

    def write_header(self, pb):
        self.pb = pb
        par = self.streams[0].codecpar
        si = par.extradata
        if not si:
            # minimal STREAMINFO (md5/total unknown = zeros, legal)
            from libav_tpu_torch.bitstream import PutBits
            pb = PutBits()
            pb.put_bits(16, 4096)
            pb.put_bits(16, 4096)
            pb.put_bits(24, 0)
            pb.put_bits(24, 0)
            pb.put_bits(20, par.sample_rate)
            pb.put_bits(3, (par.channels or 2) - 1)
            pb.put_bits(5, 15)
            pb.put_bits(4, 0)
            pb.put_bits(32, 0)
            for _ in range(16):
                pb.put_bits(8, 0)
            si = pb.flush()
        self.pb.write(b"fLaC" + bytes([0x80]) +
                      len(si).to_bytes(3, "big") + si)

    def write_packet(self, pkt: Packet):
        self.pb.write(pkt.data)
