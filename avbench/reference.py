"""The reference and the comparison that decides `correct`.

The reference is the md5 of every frame that each frozen stream decodes
to, taken by the JAX package's decoder on the CPU (byte-identical to
libav's) and kept beside the stream in the configuration's file
(`streams[i].frame_md5`, in output order); nothing of the port computes
it. Once the window has closed, every frame that the window delivered
is hashed, its three planes in order, and each GOP's frames are held
against the md5s of their stream. Decoding is exact, so each number
compared has the limit 0.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np

# number compared -> limit (exact decode: no frame may differ)
LIMITS = {"frames_missing": 0, "frames_extra": 0, "frames_off": 0}


def md5(planes) -> str:
    """md5 of one frame: its planes' samples in order, as bytes."""
    h = hashlib.md5()
    for p in planes:
        h.update(np.ascontiguousarray(p, np.uint8).tobytes())
    return h.hexdigest()


def compare(want: Sequence[List[str]], delivered: Sequence
            ) -> Dict[str, int]:
    """want: per GOP kind, the md5 of each frame it decodes to.
    delivered: (kind, frames) of every GOP the window delivered, each
    frame its host planes. -> each number compared, and `frames` (the
    frames held against an md5)."""
    out = dict.fromkeys(LIMITS, 0)
    out["frames"] = 0
    for kind, frames in delivered:
        ref = want[kind]
        out["frames_missing"] += max(0, len(ref) - len(frames))
        out["frames_extra"] += max(0, len(frames) - len(ref))
        for got, h in zip(frames, ref):
            out["frames"] += 1
            out["frames_off"] += md5(got) != h
    return out


def passed(numbers: Dict[str, int]) -> bool:
    return numbers.get("frames", 0) > 0 and all(
        numbers[k] <= lim for k, lim in LIMITS.items())
