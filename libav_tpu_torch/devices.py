"""Virtual capture devices of the port (counterpart of
`libav_tpu/devices.py`; reference: libavdevice/ alldevices.c —
capture/playback hardware wrapped as AVInputFormats).

There is no capture hardware on an accelerator host, so the device layer
exposes
synthetic sources with the same "device as demuxer" contract the
reference uses (alsa.c, v4l2.c, xcbgrab.c...): open by device URL,
read timed packets/frames. Registered devices:

  testsrc:  video test pattern  (url: "testsrc=WxH:rate=N[:frames=N]")
  vsynth:   the FATE vsynth-style noise+motion source
  sine:     audio tone          (url: "sine=freq=F:rate=R[:samples=N]")

Raw frames are emitted as rawvideo/pcm packets so the normal
decode-less pipeline (`-f testsrc -i testsrc=... out.mkv`) works. The
video sources are the port's `filters/src.py` generators; their frames
are taken to the host (`Frame.to_host`) before their bytes are joined.
"""

from __future__ import annotations

from typing import List

import numpy as np

from libav_tpu_torch.avutil.error import AVError, EOF_, INVALIDDATA
from libav_tpu_torch.avutil.frame import Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.codecs.api import CodecParameters, MediaType
from libav_tpu_torch.formats.api import (InputFormat, Stream, register_input)


def _parse_kv(url: str):
    """'name=WxH:rate=25:frames=50' -> (first_positional, {k: v})."""
    body = url.split("=", 1)[1] if "=" in url else ""
    parts = body.split(":") if body else []
    pos = None
    kv = {}
    for p in parts:
        if "=" in p:
            k, v = p.split("=", 1)
            kv[k] = v
        elif pos is None:
            pos = p
    return pos, kv


class _VideoDevice(InputFormat):
    DEVICE = True
    DEFAULT_FRAMES = 25

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        return 100 if url.startswith(cls.NAME + "=") or url == cls.NAME \
            else 0

    def read_header(self, pb):
        url = getattr(pb, "url", "") or getattr(self, "url", "") or ""
        pos, kv = _parse_kv(url)
        size = kv.get("size", pos or "320x240")
        try:
            w, h = (int(x) for x in size.lower().split("x"))
        except ValueError:
            raise AVError(INVALIDDATA, f"bad device size {size!r}")
        rate = int(kv.get("rate", 25))
        self._frames = int(kv.get("frames", self.DEFAULT_FRAMES))
        self._w, self._h = w, h
        self._n = 0
        par = CodecParameters(codec_type=MediaType.VIDEO,
                              codec_id="rawvideo", width=w, height=h,
                              pix_fmt="yuv420p",
                              framerate=Rational(rate, 1))
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, rate),
                               avg_frame_rate=Rational(rate, 1))]

    def _frame(self, n: int):
        raise NotImplementedError

    def read_packet(self) -> Packet:
        if self._n >= self._frames:
            raise AVError(EOF_)
        f = self._frame(self._n).to_host()
        data = b"".join(np.asarray(p, dtype=np.uint8).tobytes()
                        for p in f.planes)
        pkt = Packet(data=data, pts=self._n, dts=self._n, duration=1,
                     stream_index=0, flags=PKT_FLAG_KEY,
                     time_base=self.streams[0].time_base)
        self._n += 1
        return pkt


@register_input
class TestSrcDevice(_VideoDevice):
    NAME = "testsrc"
    EXTENSIONS = ()

    def _frame(self, n):
        from libav_tpu_torch.filters.src import testsrc_frame
        return testsrc_frame(self._w, self._h, n)


@register_input
class VsynthDevice(_VideoDevice):
    NAME = "vsynth"
    EXTENSIONS = ()

    def _frame(self, n):
        from libav_tpu_torch.filters.src import vsynth1_frame
        return vsynth1_frame(self._w, self._h, n)


@register_input
class SineDevice(InputFormat):
    NAME = "sine"
    DEVICE = True
    EXTENSIONS = ()
    CHUNK = 1024

    @classmethod
    def probe(cls, data: bytes, url: str = "") -> int:
        return 100 if url.startswith("sine=") or url == "sine" else 0

    def read_header(self, pb):
        url = getattr(pb, "url", "") or getattr(self, "url", "") or ""
        pos, kv = _parse_kv(url)
        self._freq = float(kv.get("freq", pos or 440))
        rate = int(kv.get("rate", 44100))
        self._total = int(kv.get("samples", rate))
        self._rate = rate
        self._pos = 0
        par = CodecParameters(codec_type=MediaType.AUDIO,
                              codec_id="pcm_s16le", sample_rate=rate,
                              channels=1, sample_fmt="s16")
        self.streams = [Stream(index=0, codecpar=par,
                               time_base=Rational(1, rate))]

    def read_packet(self) -> Packet:
        if self._pos >= self._total:
            raise AVError(EOF_)
        n = min(self.CHUNK, self._total - self._pos)
        t = (np.arange(n) + self._pos) / self._rate
        x = (0.5 * np.sin(2 * np.pi * self._freq * t) * 32767)
        pkt = Packet(data=x.astype("<i2").tobytes(), pts=self._pos,
                     dts=self._pos, duration=n, stream_index=0,
                     flags=PKT_FLAG_KEY,
                     time_base=self.streams[0].time_base)
        self._pos += n
        return pkt
