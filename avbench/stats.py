"""The arithmetic of the metrics, apart from any clock or device, so the
tests can hold it on synthetic numbers."""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def whole_unit_rate(units: Sequence[Tuple[float, int]],
                    start: float) -> float:
    """Frames per second over whole units (GOPs or decode calls): units
    are (end time, frames delivered) in order, start the window's start.
    The window ends with the last unit, so no unit counts in part."""
    if not units:
        raise ValueError("no whole unit in the window")
    end = units[-1][0]
    if end <= start:
        raise ValueError("the window has no length")
    return sum(n for _, n in units) / (end - start)


def mean_ms(seconds: Iterable[float]) -> float:
    """Mean of durations in seconds, in ms (every open counts: a stalled
    one moves it)."""
    xs = list(seconds)
    if not xs:
        raise ValueError("nothing to average")
    return 1e3 * sum(xs) / len(xs)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merged, sorted, non-overlapping intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi]."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The idle stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def idle_share(busy_s: float, window_s: float) -> float:
    """Percent of the window in which no operation ran on the device."""
    if window_s <= 0:
        raise ValueError("the traced window has no length")
    return 100.0 * (1.0 - busy_s / window_s)


def roofline_share(nbytes: float, ms: float, bytes_per_ms: float) -> float:
    """Percent of the memory roofline: the least time the bytes take at
    the peak rate over the time measured."""
    if ms <= 0:
        raise ValueError("no time measured")
    return 100.0 * (nbytes / bytes_per_ms) / ms


def top(totals: Dict[str, float], n: int = 10) -> List[List]:
    """The n largest [name, value] pairs, largest first."""
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:n]]
