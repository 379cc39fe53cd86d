"""FIFO buffer (reference: libavutil/fifo.c (131h) AVFifoBuffer) — used by
the muxer interleave queues and host<->device staging."""

from __future__ import annotations

from collections import deque
from typing import Any, List, Optional


class Fifo:
    """Byte/object FIFO with the av_fifo_* surface."""

    def __init__(self):
        self._q: deque = deque()
        self._size = 0

    def write(self, item, size: int = 1):
        """reference: av_fifo_generic_write"""
        self._q.append(item)
        self._size += size

    def read(self):
        """reference: av_fifo_generic_read"""
        if not self._q:
            return None
        item = self._q.popleft()
        self._size -= 1
        return item

    def peek(self):
        return self._q[0] if self._q else None

    def size(self) -> int:
        """reference: av_fifo_size"""
        return len(self._q)

    def drain(self) -> List[Any]:
        out = list(self._q)
        self._q.clear()
        self._size = 0
        return out

    def reset(self):
        """reference: av_fifo_reset"""
        self._q.clear()
        self._size = 0

    def __len__(self):
        return len(self._q)
