"""Timing spans that the benchmark puts around calls into the port, from
its own files: a function or method is replaced by a wrapper that records
(start, end, tag) on the host clock, and put back afterwards.

A span is shared: every reader that asks for the same name gets the same
records. Nested calls on one thread (a recursive upload) count once, as
the outermost call. With `sync`, the device is synchronised before and
after the call, so the span holds the device work the call queued.
"""

from __future__ import annotations

import functools
import importlib
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


def resolve(target: str) -> Tuple[object, str]:
    """'pkg.mod:Class.attr' or 'pkg.mod:attr' -> (owner object, attr)."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Span:
    def __init__(self, name: str):
        self.name = name
        self.records: List[Tuple[float, float, object]] = []
        self._lock = threading.Lock()
        self._depth = threading.local()

    def add(self, t0: float, t1: float, tag=None) -> None:
        with self._lock:
            self.records.append((t0, t1, tag))

    def seconds(self, tag_filter: Optional[Callable] = None) -> float:
        return sum(t1 - t0 for t0, t1, tag in self.records
                   if tag_filter is None or tag_filter(tag))

    def count(self, tag_filter: Optional[Callable] = None) -> int:
        return sum(1 for _, _, tag in self.records
                   if tag_filter is None or tag_filter(tag))


class Spans:
    """The spans of one run: patch() installs, restore() removes all."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync or (lambda: None)
        self.spans: Dict[str, Span] = {}
        self._undo: List[Tuple[object, str, object]] = []

    def patch(self, name: str, target: str, sync: bool = False,
              tag: Optional[Callable] = None) -> Span:
        """Wrap `target` in the span `name` (once per name)."""
        if name in self.spans:
            return self.spans[name]
        span = Span(name)
        owner, attr = resolve(target)
        inner = getattr(owner, attr)
        synchronize = self.sync

        @functools.wraps(inner)
        def wrapper(*args, **kw):
            depth = getattr(span._depth, "n", 0)
            if depth:
                return inner(*args, **kw)
            span._depth.n = 1
            try:
                if sync:
                    synchronize()
                t0 = time.perf_counter()
                out = inner(*args, **kw)
                if sync:
                    synchronize()
                span.add(t0, time.perf_counter(),
                         tag(out) if tag is not None else None)
                return out
            finally:
                span._depth.n = 0
        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, inner))
        self.spans[name] = span
        return span

    def restore(self) -> None:
        while self._undo:
            owner, attr, inner = self._undo.pop()
            setattr(owner, attr, inner)

    def within(self, lo: float, hi: float) -> List[Tuple[float, float, str]]:
        """(start, end, name) of every record that overlaps [lo, hi]."""
        return [(t0, t1, s.name) for s in self.spans.values()
                for t0, t1, _ in list(s.records) if t1 > lo and t0 < hi]


def active(records: List[Tuple[float, float, str]], t: float) -> List[str]:
    """Names of the records (from Spans.within) that cover host time t."""
    return sorted({name for t0, t1, name in records if t0 <= t < t1})
