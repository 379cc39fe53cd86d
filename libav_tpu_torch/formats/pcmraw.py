"""Raw PCM demuxers/muxers (reference: libavformat/pcmdec.c PCMDEF
macro family + rawenc.c pcm writers): s16le/s16be/u8/s32le/f32le/f64le.

Each format name maps 1:1 to the codec of the same sample layout; the
demuxer needs -ar/-ac options (defaults 44100/1 like the reference)."""

from __future__ import annotations

from libav_tpu_torch.avutil.error import AVError, EOF_
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, OutputFormat,
                                   register_input, register_output)

# name -> (codec_id, bytes per sample)
_PCM_FMTS = {
    "s16le": ("pcm_s16le", 2),
    "s16be": ("pcm_s16be", 2),
    "u8": ("pcm_u8", 1),
    "s32le": ("pcm_s32le", 4),
    "f32le": ("pcm_f32le", 4),
    "f64le": ("pcm_f64le", 8),
}

# one packet = 25 Hz worth of samples like the reference raw pcm read
_SAMPLES_PER_PACKET = 1024


def _make_demuxer(name: str, codec_id: str, bps: int):
    @register_input
    class PCMDemuxer(InputFormat):
        NAME = name
        LONG_NAME = f"raw {name} PCM"
        EXTENSIONS = (name,)

        OPTIONS = [
            Option("sample_rate", "sample rate", "int", 44100),
            Option("channels", "channel count", "int", 1),
        ]

        def read_header(self, pb):
            self.pb = pb
            sr = int(self.sample_rate or 44100)
            ch = int(self.channels or 1)
            par = CodecParameters(
                codec_type=MediaType.AUDIO, codec_id=codec_id,
                sample_rate=sr, channels=ch)
            self.streams = [Stream_(index=0, codecpar=par,
                                    time_base=Rational(1, sr))]
            self._pos = 0
            self._bpf = bps * ch

        def read_packet(self) -> Packet:
            data = self.pb.read(_SAMPLES_PER_PACKET * self._bpf)
            if not data:
                raise AVError(EOF_)
            ns = len(data) // self._bpf
            data = data[:ns * self._bpf]
            pkt = Packet(data=data, pts=self._pos, dts=self._pos,
                         duration=ns, stream_index=0, flags=PKT_FLAG_KEY)
            self._pos += ns
            return pkt

    PCMDemuxer.__name__ = f"PCM{name.upper()}Demuxer"
    return PCMDemuxer


def _make_muxer(name: str, codec_id: str):
    @register_output
    class PCMMuxer(OutputFormat):
        NAME = name
        EXTENSIONS = (name,)
        AUDIO_CODEC = codec_id

        def write_packet(self, pkt: Packet):
            self.pb.write(pkt.data)

    PCMMuxer.__name__ = f"PCM{name.upper()}Muxer"
    return PCMMuxer


from libav_tpu_torch.formats.api import Stream as Stream_  # noqa: E402

for _name, (_codec, _bps) in _PCM_FMTS.items():
    _make_demuxer(_name, _codec, _bps)
    _make_muxer(_name, _codec)
