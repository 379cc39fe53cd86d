"""CUDA graphs for a recon program's launch chain (no counterpart in the
JAX package, where XLA compiles each program whole).

A recon program (`mpegvideo.Recon`, `mpegvideo.ReconField`) issues a few
hundred to about 1,600 small torch ops a picture; on the card the host's
issue of them, not the device's work, sets the pace. `GraphRunner` runs
such a program as two CUDA graphs around one eager call of its hand
kernel. The program splits its forward at the kernel: `stage_a(*args,
**kw)` returns the kernel's input, `kernel(x)` the kernel's output, and
`stage_b(kernel_out, *args, **kw)` the outputs. On the first call of an
argument signature (the shapes and dtypes of the arguments, which
tensors are None) the runner copies the arguments into static tensors,
runs both stages once on a side stream and captures each as a graph.
Every call then copies its arguments into the static tensors, replays
stage A, calls the program's `kernel` on stage A's static output and
copies the result into the static buffer stage B reads, replays stage B
and returns clones of stage B's static outputs (the caller keeps them;
the next replay overwrites the originals). The kernel stays eager and is
looked up on the program at every call, so that its launch counter,
anything wrapping or standing in for it (the benchmark flushes the L2
before each K2 launch; its control swaps in a float IDCT) and the
profiler see it as on the eager path. The work is the same ops on the
same data, and one copy of the kernel's output.

Off the card the runner calls the program itself, the eager twin the CPU
tests check: the device decides, nothing else. Counters, under the name
the runner is given: `<name>.capture` once per signature captured (a
capture is not a program build: `programs.built` does not count it),
`<name>.graph` once per call replayed, `<name>.eager` once per call run
eagerly.

Every runner's graphs on one device share one memory pool, so a capture
may place its temporaries where another graph's temporaries lie: no two
replays on a device may overlap. The pool's lock is held from the copy of
the arguments until the clones are issued, and each call's stream first
waits for the event recorded after the previous call's clones, which may
have been issued on another thread's stream (two decoders may share a
card, parallel/gop.py). Captures run in thread-local capture mode, so
another thread's work on the card goes on during one.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable

import torch

from libav_tpu_torch.avutil import timer


class _Pool:
    """One device's graph memory pool, with the lock and the last call's
    event that keep its replays apart."""

    def __init__(self, device: torch.device):
        self.device = device
        self.handle = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.done = None


@functools.lru_cache(maxsize=None)
def _pool(device: torch.device) -> _Pool:
    return _Pool(device)


def _clone(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x.clone()


class _Graphs:
    """One argument signature's static arguments, its two captured graphs
    and their static outputs."""

    def __init__(self, program, pool: _Pool, n_args: int, names: tuple,
                 flat: list):
        self.inputs = [None if t is None else t.clone() for t in flat]
        args = self.inputs[:n_args]
        kw = dict(zip(names, self.inputs[n_args:]))
        dev = pool.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # warm-up: stage B reads stage A's output in place of the
            # kernel's (the same shape and dtype), so the kernel launches
            # once per call and never here
            program.stage_b(program.stage_a(*args, **kw), *args, **kw)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.a, self.b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.a, pool=pool.handle, stream=side,
                              capture_error_mode="thread_local"):
            self.mid = program.stage_a(*args, **kw)
        self.mid_out = torch.empty_like(self.mid)
        with torch.cuda.graph(self.b, pool=pool.handle, stream=side,
                              capture_error_mode="thread_local"):
            self.out = program.stage_b(self.mid_out, *args, **kw)

    def run(self, program, flat: list):
        for static, t in zip(self.inputs, flat):
            if static is not None:
                static.copy_(t)
        self.a.replay()
        self.mid_out.copy_(program.kernel(self.mid))
        self.b.replay()
        return _clone(self.out)


class GraphRunner:
    """Runs a program with `stage_a`, `kernel` and `stage_b` (see the
    module's docstring) from CUDA graphs on a CUDA device and eagerly
    elsewhere. One runner per program (`graphed`): it keeps the program's
    graphs, one pair per argument signature. Arguments are tensors or
    None."""

    def __init__(self, name: str):
        self.name = name
        self.graphs = {}

    def __call__(self, program, *args, **kw):
        device = next(program.buffers()).device
        if device.type != "cuda":
            timer.count(self.name + ".eager")
            return program(*args, **kw)
        names = tuple(sorted(kw))
        flat = list(args) + [kw[k] for k in names]
        sig = (len(args), names) + tuple(
            None if t is None else (t.dtype, tuple(t.shape)) for t in flat)
        pool = _pool(device)
        with torch.cuda.device(device), pool.lock:
            graphs = self.graphs.get(sig)
            if graphs is None:
                graphs = self.graphs[sig] = _Graphs(
                    program, pool, len(args), names, flat)
                timer.count(self.name + ".capture")
            stream = torch.cuda.current_stream(device)
            if pool.done is not None:
                stream.wait_event(pool.done)
            out = graphs.run(program, flat)
            pool.done = torch.cuda.Event()
            pool.done.record(stream)
        timer.count(self.name + ".graph")
        return out


_attach = threading.Lock()


def graphed(program, name: str) -> Callable:
    """`program`'s forward run by the GraphRunner kept on the program (so
    whatever caches the program owns its graphs), its counters named
    `name`; the first name a program is graphed under holds."""
    with _attach:
        runner = getattr(program, "graph_runner", None)
        if runner is None:
            runner = program.graph_runner = GraphRunner(name)
    return functools.partial(runner, program)
