"""Profiling helpers (counterpart of `libav_tpu/avutil/timer.py`;
reference: libavutil/timer.h START_TIMER/STOP_TIMER).

`report` and `reset` are the JAX module's own host functions, and `timer`
runs the JAX module's timer, so every span lands in its one `_STATS`: the
H.264 decoder's `h264.entropy` span (libav_tpu/codecs/h264/dec.py) and
the port's own are reported together. What differs is the device:
`timer(name, sync=tensor)` synchronises the tensor's CUDA device where
the JAX one blocks on a jax array, and `device_trace` runs torch.profiler
where the JAX one writes an xplane trace.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from libav_tpu.avutil import timer as _ref
from libav_tpu.avutil.timer import report, reset  # noqa: F401

TRACE_FILE = "avconv.pt.trace.json"


@contextlib.contextmanager
def timer(name: str, sync: torch.Tensor = None):
    """with timer('idct', sync=out): ... — count/total/min/max of the
    span; with sync, the clock stops after the tensor's CUDA device has
    finished its work (launches are asynchronous)."""
    with _ref.timer(name):
        try:
            yield
        finally:
            if sync is not None and sync.is_cuda:
                torch.cuda.synchronize(sync.device)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler over a region, CPU activity and (where a CUDA card
    is present) CUDA activity, written as a Chrome trace to
    `logdir/TRACE_FILE`; yields that path."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    sys.stderr.write(f"profile: torch.profiler Chrome trace in {path}\n")
