"""GOP-granular multi-device scheduling on REAL bitstreams, in the port
(counterpart of `libav_tpu/parallel/gop.py`; SURVEY.md §2.10; reference
role: pthread_frame.c frame threading, promoted from threads to devices).

The stream is split at closed-GOP boundaries (H.264 IDR, MPEG-1/2 GOP
header/I picture, MPEG-4 I-VOP); each GOP is a fully independent decode
problem, so the scheduler maps GOP k -> device k % n and runs the
complete decoder (host entropy + that device's compiled recon programs)
per segment, reassembling frames in stream order. ICI never carries
pixels — only the trivial order barrier — which is the right shape for
this workload: inter-frame dependencies never cross a closed GOP, so
data parallelism over segments is collective-free by construction.

Workers run in threads: host entropy interleaves under the GIL while
each device's compute queue drains independently; each worker opens its
decoder on its own torch device (`find_decoder(codec)(par, device=dev)`).
The devices are every CUDA device unless the caller names them; a host
without CUDA raises, and only a caller's ["cpu", ...] runs on the CPU.
"""

from __future__ import annotations

import concurrent.futures as _fut
from typing import List, Optional, Sequence, Tuple

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.frame import Packet


def _h264_is_idr(data: bytes) -> bool:
    """Annex-B scan for an IDR NAL (type 5)."""
    i = 0
    n = len(data)
    while i + 3 < n:
        if data[i] == 0 and data[i + 1] == 0:
            if data[i + 2] == 1:
                if (data[i + 3] & 0x1F) == 5:
                    return True
                i += 3
                continue
            if data[i + 2] == 0 and i + 4 < n and data[i + 3] == 1:
                if (data[i + 4] & 0x1F) == 5:
                    return True
                i += 4
                continue
        i += 1
    return False


def _mpeg12_is_key(data: bytes) -> bool:
    """Sequence header (0xB3) or GOP header (0xB8) opens a segment."""
    return b"\x00\x00\x01\xb3" in data or b"\x00\x00\x01\xb8" in data


def _mpeg4_is_key(data: bytes) -> bool:
    """VOL header or I-VOP (vop_coding_type 0) opens a segment."""
    i = data.find(b"\x00\x00\x01\xb6")
    if b"\x00\x00\x01\x20" in data[:i if i >= 0 else len(data)]:
        return True
    if i >= 0 and i + 4 < len(data):
        return (data[i + 4] >> 6) == 0
    return False


_KEY_OF = {"h264": _h264_is_idr, "mpeg1video": _mpeg12_is_key,
           "mpeg2video": _mpeg12_is_key, "mpeg4": _mpeg4_is_key}


def split_gops(packets: Sequence[Packet], codec: str) -> List[List[Packet]]:
    """Split a packet stream into closed GOP segments at keyframe
    boundaries. Any packets before the first keyframe form their own
    leading segment — decoded reference-less and concealed, exactly
    what the serial decoder does with them."""
    is_key = _KEY_OF[codec]
    gops: List[List[Packet]] = []
    cur: List[Packet] = []
    for pkt in packets:
        if pkt.data and is_key(pkt.data) and cur:
            gops.append(cur)
            cur = []
        cur.append(pkt)
    if cur:
        gops.append(cur)
    return gops


class GOPParallelDecoder:
    """Decode closed-GOP segments of a real bitstream in parallel, one
    decoder instance + one device per worker, frames reassembled in
    stream order.

    devices: torch devices to spread over, each validated by
    hwdevice.device (default: every CUDA device; raises without CUDA).
    On a single card this still validates the scheduler end-to-end
    (segment split, per-worker decoders, in-order reassembly); the same
    device may be named more than once, one worker each.
    """

    def __init__(self, codec: str, devices=None, extradata: bytes = None,
                 max_workers: Optional[int] = None):
        import torch
        self.codec = codec
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("GOPParallelDecoder: no CUDA device on "
                                   "this host; name the devices to use")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = [hwdevice.device(d) for d in devices]
        self.extradata = extradata
        self.max_workers = max_workers or len(self.devices)

    def _decode_gop(self, gop: List[Packet], dev):
        from libav_tpu_torch.codecs import find_decoder
        from libav_tpu_torch.codecs.api import CodecParameters, MediaType
        cls = find_decoder(self.codec)
        par = CodecParameters(codec_type=MediaType.VIDEO,
                              codec_id=self.codec,
                              extradata=self.extradata or b"")
        dec = cls(par, device=dev).open()
        frames = dec.decode_all(list(gop))
        # materialise on host inside the worker so reassembly is
        # pure list concatenation
        return [f.to_host() for f in frames]

    def decode(self, packets: Sequence[Packet]):
        """-> list of frames in stream order."""
        gops = split_gops(packets, self.codec)
        if len(gops) <= 1:
            dev = self.devices[0]
            return self._decode_gop(gops[0], dev) if gops else []
        with _fut.ThreadPoolExecutor(self.max_workers) as ex:
            futs = [ex.submit(self._decode_gop, gop,
                              self.devices[k % len(self.devices)])
                    for k, gop in enumerate(gops)]
            out: List = []
            for fu in futs:
                out.extend(fu.result())
        return out
