"""The committed smoke stream and its golden digests.

`h264_1080p_ipbb_cabac.h264pkts` is the 1080p stream that `bench.py` times
(CABAC, I_8x8 + 8x8 transform, IPBB, 4 slices, in-loop deblocking), stored
as 4-byte big-endian length-prefixed access units. The golden JSON holds,
per output frame, the adler32 (seed 0, over the Y|U|V bytes, as a framecrc
line of rawvideo output computes it) and md5 that the JAX package's decoder
produced on the CPU, plus one md5 over all frames. Both files are written
by `tools/gen_torch_smoke_stream.py`.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib
from typing import Dict, List, Sequence

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE_STREAM = os.path.join(HERE, "h264_1080p_ipbb_cabac.h264pkts")
SMOKE_GOLDEN = os.path.join(HERE, "h264_1080p_ipbb_cabac.golden.json")


def read_packets(path: str) -> List[bytes]:
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                return out
            out.append(f.read(int.from_bytes(hdr, "big")))


def write_packets(path: str, datas: Sequence[bytes]) -> None:
    with open(path, "wb") as f:
        for d in datas:
            f.write(len(d).to_bytes(4, "big"))
            f.write(d)


def digest(frames_planes: Sequence[Sequence[np.ndarray]]) -> Dict:
    """Golden record of decoded frames, each given as host (Y, U, V)."""
    total = hashlib.md5()
    per = []
    for planes in frames_planes:
        data = b"".join(np.ascontiguousarray(p, np.uint8).tobytes()
                        for p in planes)
        total.update(data)
        per.append({"adler32": f"0x{zlib.adler32(data, 0) & 0xFFFFFFFF:08x}",
                    "md5": hashlib.md5(data).hexdigest(),
                    "width": int(planes[0].shape[1]),
                    "height": int(planes[0].shape[0])})
    return {"frames": per, "md5_all": total.hexdigest()}


def load_golden(path: str = SMOKE_GOLDEN) -> Dict:
    with open(path) as f:
        return json.load(f)
