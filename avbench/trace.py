"""The device side of a traced run: torch.profiler over each unit of work
(a GOP, a decode call). The hand kernels are timed cold from the same
profiles: ColdLaunches flushes the L2 before each launch.

The profiler on this card loses device events, some or all of a window.
So each unit's profile counts the launches it holds of the cell's hand
kernels against the port's own launch counters, and a unit that holds
fewer is left out; where the window has no whole unit, the harness runs
more units after it. Busy time is the union of every kernel, copy and
memset interval of the kept units; the window is their length.

The host clock and the trace's clock are tied by a marker: the device is
idle when a unit starts, so the marker, a float64 fill queued at a known
host time, runs at once; the unit's events are those from its marker
on. Idle stretches are then named by the benchmark's host spans that
cover them.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from avbench import roofline, stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# ColdLaunches' own device work before each launch, the L2 flush (an
# int32 fill) and a spin that marks it, and the spins that pad each
# profile: left out of busy time
SPIN = "spin_kernel"
FLUSH = "FillFunctor<int>"
SPIN_CYCLES = 10_000
PAD_CYCLES = 2_000_000
# the marker queued at the start of each unit (nothing else on the path
# fills float64)
MARKER = "FillFunctor<double>"
# idle stretches shorter than this are launch gaps, named as such
SHORT_GAP_S = 1e-4


def _start_profiler():
    """Start torch's Kineto profiler on CUDA activity alone; -> a stop()
    that returns its raw results, read by _device_events. The raw entry
    points skip the Python parse of every event that
    torch.profiler.profile may make on stopping."""
    from torch.autograd import profiler as P
    try:
        config = P.ProfilerConfig(P.ProfilerState.KINETO, False, False,
                                  False, False, False,
                                  P._ExperimentalConfig())
        activities = {P.ProfilerActivity.CUDA}
        P._prepare_profiler(config, activities)
        P._enable_profiler(config, activities)
        return P._disable_profiler
    except (AttributeError, TypeError):
        # an interface without the raw entry points: the public one
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()

        def stop():
            prof.__exit__(None, None, None)
            return prof.profiler.kineto_results
        return stop


def counter(target: str) -> Callable[[], int]:
    """'pkg.mod:function' -> a reader of that kernel wrapper's launch
    counter (`.launches`, kept by `_kernels.count_launch`)."""
    from avbench.spans import resolve
    owner, attr = resolve(target)
    return lambda: getattr(getattr(owner, attr), "launches")


class DeviceTrace:
    """kernels: [(part of the CUDA kernel's name, launch counter)]."""

    def __init__(self, device, spans, kernels: List[Tuple[str, Callable]],
                 attempts: int = 2):
        import torch
        self.torch = torch
        self.device = device
        self.spans = spans
        self.kernels = kernels
        self.attempts = attempts
        self.kept = self.dropped = 0
        self.busy_s = self.window_s = 0.0
        self.ops: Dict[str, float] = defaultdict(float)
        self.idle: Dict[str, float] = defaultdict(float)
        self.shortfall: List[str] = []
        self.notes: List[str] = []          # one line per unit read
        self._pending: List = []
        self.unit_id = 0
        self.current: Optional[int] = None   # the unit being profiled
        self.profiled_s = 0.0
        self.kept_ids: set = set()
        # device seconds of each hand kernel in the kept units
        self.kernel_s: Dict[str, float] = defaultdict(float)
        # what tracing itself took, outside the units' bodies
        self.costs = {"stop_s": 0.0, "read_s": 0.0}
        self._mark = torch.zeros(1, dtype=torch.float64, device=device)

    @contextlib.contextmanager
    def unit(self):
        """Profile one unit; its trace is read after the window (finish)."""
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self.unit_id += 1
        uid = self.unit_id
        launched = [c() for _, c in self.kernels]
        stop = _start_profiler()
        try:
            # the edges of a profile lose the most events: pad both
            torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize(self.device)
            t_mark = time.perf_counter()
            # three markers: a profile after the first in a process has
            # been seen to lose its first kernel record
            for _ in range(3):
                self._mark.fill_(1.0)
            self.current = uid
            yield
            torch.cuda.synchronize(self.device)
            t_end = time.perf_counter()
            self.current = None
            torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize(self.device)
        finally:
            self.current = None
            t = time.perf_counter()
            results = stop()
            self.costs["stop_s"] += time.perf_counter() - t
        launched = [c() - n for n, (_, c) in zip(launched, self.kernels)]
        self.profiled_s += t_end - t_mark
        self._pending.append((uid, results, launched, t_mark, t_end))

    def finish(self) -> None:
        """Read every profiled unit's trace (after the window, so that
        reading traces takes none of its time)."""
        while self._pending:
            uid, results, launched, t_mark, t_end = self._pending.pop(0)
            t = time.perf_counter()
            if self._add(_device_events(results), launched, t_mark, t_end):
                self.kept_ids.add(uid)
            self.costs["read_s"] += time.perf_counter() - t

    def _add(self, events, launched, t_mark, t_end) -> bool:
        """Fold one unit's events in; -> whether the unit was kept. A
        trace may also hold events from before the unit: the unit starts
        at its own marker, the last one in the trace."""
        events = _without_timer_work(events)
        marks = [float(e["ts"]) for e in events
                 if MARKER in e.get("name", "")]
        self.notes.append(_describe(events, marks, self.kernels, launched,
                                    t_end - t_mark))
        if marks:
            lo = marks[-1]
            offset = lo - 1e6 * t_mark        # trace us - host us
            hi = 1e6 * t_end + offset
            events = [e for e in events if lo <= float(e["ts"]) <= hi]
        held = [sum(1 for e in events if name in e.get("name", ""))
                for name, _ in self.kernels]
        whole = all(float(e.get("dur", 0)) > 0 for e in events
                    if any(n in e.get("name", "") for n, _ in self.kernels))
        if not marks or held != launched or not whole:
            self.dropped += 1
            self.shortfall.append(
                ", ".join(f"{name}: {h} of {n}" for (name, _), h, n in
                          zip(self.kernels, held, launched))
                + ("" if marks else " (no marker)")
                + ("" if whole else " (zero-length kernel records)"))
            return False
        self.kept += 1
        iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in events]
        self.window_s += (hi - lo) / 1e6
        self.busy_s += stats.busy(iv, lo, hi) / 1e6
        for e, (a, b) in zip(events, iv):
            self.ops[e.get("name", "?")[:160]] += (b - a) / 1e6
            for name, _ in self.kernels:
                if name in e.get("name", ""):
                    self.kernel_s[name] += (b - a) / 1e6
        from avbench.spans import active
        records = self.spans.within(t_mark, t_end)
        for a, b in stats.gaps(iv, lo, hi):
            s = (b - a) / 1e6
            if s < SHORT_GAP_S:
                self.idle["launch gaps under 0.1 ms"] += s
                continue
            names = active(records, ((a + b) / 2 - offset) / 1e6)
            self.idle["+".join(names) or "outside the spans"] += s
        return True

    def breakdown(self) -> Dict[str, List]:
        return {"device_ops": stats.top(self.ops),
                "idle_gaps": stats.top(self.idle)}


def _device_events(results) -> List[Dict]:
    """The kernels, copies and memsets of a profile as Chrome-trace-like
    records (name, ts and dur in us), read from its raw events (the
    Chrome trace it saves has held kernel records of zero length on the
    card); where the raw events lack what this needs, from that trace."""
    from torch.autograd import DeviceType
    try:
        return [{"name": e.name(), "ts": e.start_ns() / 1e3,
                 "dur": e.duration_ns() / 1e3}
                for e in results.events()
                if e.device_type() == DeviceType.CUDA]
    except AttributeError:
        pass
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        results.save(path)
        with open(path) as f:
            return [e for e in json.load(f).get("traceEvents", [])
                    if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    finally:
        os.unlink(path)


def _describe(events, marks, kernels, launched, body_s) -> str:
    """One line on what a unit's trace holds (for the run's log)."""
    if not events:
        return f"body {body_s:.3f} s: no device events"
    ts = [float(e["ts"]) for e in events]
    zero = sum(1 for e in events if not float(e.get("dur", 0)))
    last = marks[-1] if marks else min(ts)
    before = sum(1 for t in ts if t < last)
    ks = ", ".join(
        f"{name} {sum(1 for e in events if name in e.get('name', ''))}/{n} "
        f"mean {_mean_dur(events, name):.1f} us"
        for (name, _), n in zip(kernels, launched))
    return (f"body {body_s:.3f} s: {len(events)} events over "
            f"{(max(ts) - min(ts)) / 1e6:.3f} s, {zero} of zero length, "
            f"{len(marks)} markers, {before} before the last; {ks}")


def _mean_dur(events, name) -> float:
    d = [float(e.get("dur", 0)) for e in events if name in e.get("name", "")]
    return sum(d) / len(d) if d else 0.0


def _without_timer_work(events: List[Dict]) -> List[Dict]:
    """The trace's device events less each spin kernel and the flush
    that precedes it on the stream (the benchmark's, not the program's)."""
    events = sorted(events, key=lambda e: float(e["ts"]))
    drop = set()
    for i, e in enumerate(events):
        if SPIN in e.get("name", ""):
            drop.add(i)
            if i and FLUSH in events[i - 1].get("name", ""):
                drop.add(i - 1)
    return [e for i, e in enumerate(events) if i not in drop]


class ColdLaunches:
    """Every launch of one hand kernel inside a profiled unit, at its
    ctypes entry point in the port's kernel library, starts with the L2
    flushed (FLUSH_BYTES
    written, then a short spin that marks the flush in the trace, so it
    is left out of busy time). Each launch's bytes, `nbytes(args)`, are
    kept with the traced unit it ran in; the kernel's device time comes
    from that unit's profile (DeviceTrace.kernel_s)."""

    def __init__(self, trace: DeviceTrace, symbol: str, nbytes: Callable):
        import torch
        from libav_tpu_torch import _kernels
        self.torch = torch
        self.trace = trace
        self.lib = _kernels.library()
        self.symbol = symbol
        self.inner = getattr(self.lib, symbol)
        self.nbytes = nbytes
        self.flush = torch.empty(roofline.FLUSH_BYTES // 4,
                                 dtype=torch.int32, device=trace.device)
        self.launches: List[Tuple[int, int]] = []   # (unit id, bytes)
        setattr(self.lib, symbol, self._launch)

    def _launch(self, *args):
        uid = self.trace.current
        if uid is not None:
            self.flush.fill_(len(self.launches))
            self.torch.cuda._sleep(SPIN_CYCLES)
            self.launches.append((uid, self.nbytes(args)))
        return self.inner(*args)

    def restore(self) -> None:
        setattr(self.lib, self.symbol, self.inner)

    def share(self, kernel: str, card: str) -> Optional[float]:
        """Percent of the memory roofline over the launches of the kept
        units: their bytes at the card's peak rate over their device
        time in the trace."""
        seconds = self.trace.kernel_s.get(kernel, 0.0)
        nbytes = sum(n for uid, n in self.launches
                     if uid in self.trace.kept_ids)
        if not seconds or not nbytes:
            return None
        return stats.roofline_share(nbytes, 1e3 * seconds,
                                    roofline.hbm_bytes_per_ms(card))
