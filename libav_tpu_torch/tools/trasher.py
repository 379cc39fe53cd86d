"""Fault injector: flips random bytes in a file (reference:
tools/trasher.c — used by FATE's corrupt-stream robustness tests,
SURVEY.md §5 fault injection)."""

from __future__ import annotations

import random
import sys
from typing import Optional


def trash(data: bytes, count: int, seed: int = 0,
          keep_prefix: int = 0) -> bytes:
    """Flip `count` random bytes (never in the first keep_prefix bytes)."""
    rng = random.Random(seed)
    out = bytearray(data)
    n = len(out)
    for _ in range(count):
        if n <= keep_prefix:
            break
        pos = rng.randrange(keep_prefix, n)
        out[pos] = rng.randrange(256)
    return bytes(out)


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        sys.stderr.write("usage: trasher <file> <count> <seed> [out]\n")
        return 1
    path, count, seed = argv[0], int(argv[1]), int(argv[2])
    out = argv[3] if len(argv) > 3 else path
    data = open(path, "rb").read()
    open(out, "wb").write(trash(data, count, seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
