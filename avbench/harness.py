"""One run of one cell: load, warm up the cell's own shapes, measure for
`--seconds`, hold every frame the window delivered against the
reference's md5s (`reference.py`), print one JSON line.

With `--trace 0` the line holds the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, each read by `layers/<metric>.py`
from spans and counters that the benchmark installs around calls into
the port, and from torch.profiler over the window (`trace.py`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from avbench import guard, reference, spec

# units profiled in a traced run, by their length in all
PROFILE_SECONDS = 15.0


def read_packets(path: str) -> List[bytes]:
    """A frozen stream: 4-byte big-endian length-prefixed packets."""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                return out
            out.append(f.read(int.from_bytes(hdr, "big")))


class Run:
    """What a traffic generator and the readers see of one run."""

    def __init__(self, bench: Dict, name: str, seed: int, seconds: float,
                 trace: bool, device, t0: float, root: str = spec.ROOT,
                 cells_dir: Optional[str] = None):
        import torch
        self.torch = torch
        self.bench = bench
        self.name = name
        self.workload = spec.workload(bench, name)
        self.cell = (spec.cell(name, cells_dir) if cells_dir
                     else spec.cell(name))
        self.config = spec.config(bench, self.workload["config"], root)
        self.params = self.cell["params"]
        self.codec = self.config["codec"]
        self.seed = seed
        self.seconds = seconds
        self.tracing = trace
        self.device = device
        self.cuda = device.type == "cuda"
        self.t0 = t0
        streams = self.config["streams"]
        self.gops = [read_packets(os.path.join(root, s["file"]))
                     for s in streams]
        # the reference: the md5 of each frame each GOP decodes to
        self.want = [s["frame_md5"] for s in streams]
        self.window_start: Optional[float] = None
        self.window_end: Optional[float] = None
        self.units: List = []          # (end time, frames) per unit
        self.unit_times: List = []     # (start, end) of each unit's body
        self.delivered: List = []      # (GOP kind, host frames) per GOP
        self.traced_frames = 0
        from avbench.spans import Spans
        self.spans = Spans(sync=self.sync)
        self.trace = None
        self.timers: Dict[str, object] = {}

    # -- clock and device ------------------------------------------------ #

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def now(self) -> float:
        return time.perf_counter()

    def start_window(self) -> float:
        """The first timed packet is about to go: set-up ends here."""
        self.window_start = self.now()
        return self.window_start

    def window_open(self) -> bool:
        return self.now() - self.window_start < self.seconds

    @contextlib.contextmanager
    def unit(self):
        """Context of one unit of work (a GOP, a decode call): its body's
        host interval is kept, and a traced run profiles it while the
        profiled units are shorter than PROFILE_SECONDS in all (stopping
        and reading a profile costs several times the unit)."""
        profile = (self.trace is not None and
                   self.trace.profiled_s < PROFILE_SECONDS)
        with (self.trace.unit() if profile else contextlib.nullcontext()):
            t0 = self.now()
            yield
            self.unit_times.append((t0, self.now()))

    # -- what the window delivered --------------------------------------- #

    def deliver(self, kind: int, frames: List[List[np.ndarray]]) -> None:
        """One whole GOP of stream `kind`, as host planes per frame; every
        one is kept for the comparison after the window."""
        self.delivered.append((kind, frames))
        self.traced_frames += len(frames)

    def end_unit(self, frames: int) -> None:
        self.units.append((self.now(), frames))


def _device_info(run: Run, chips: int) -> Dict:
    torch = run.torch
    idx = range(chips)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in idx)}
    try:
        import subprocess
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        info["power_limit"] = r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device=None, bench: Optional[Dict] = None,
             cells_dir: Optional[str] = None, root: str = spec.ROOT,
             warm: bool = True, log=sys.stderr) -> Dict:
    """Run one cell once -> the result dict (keys in the printed order).
    `device` None means the card, required; tests pass a CPU device.
    warm=False serves the control and fault runs (`control.py`), which
    time nothing."""
    import torch
    bench = bench or spec.benchmark(root)
    chips = int(spec.workload(bench, name)["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < chips:
            raise SystemExit(f"{name} needs {chips} CUDA devices, this host "
                             f"has {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    run = Run(bench, name, seed, seconds, trace, device, t0, root,
              cells_dir)
    gen = spec.generator(run.cell["generator"])
    if warm:
        gen.warm(run)
    readers = []
    if trace:
        from avbench.trace import DeviceTrace, counter
        # host spans that name the device's idle stretches
        for span, target in run.config.get("host_spans", {}).items():
            run.spans.patch(span, target)
        if run.cuda:
            run.trace = DeviceTrace(device, run.spans, [
                (k["trace_name"], counter(k["counter"]))
                for k in run.config.get("kernels", [])])
        for m in spec.metrics_of(bench, "per_layer", name):
            mod = spec.reader(m["name"])
            mod.install(run)
            readers.append((m, mod))
    raw = gen.window(run)
    run.window_end = run.now()
    log.write("units (s): " + " ".join(f"{b - a:.3f}"
                                       for a, b in run.unit_times) + "\n")
    if trace and run.trace is not None:
        run.trace.finish()
        extra = 0
        while not run.trace.kept and extra < run.trace.attempts:
            with run.unit():
                gen.unit(run)
            run.trace.finish()
            extra += 1
        for s in run.trace.notes:
            log.write(f"profile: {s}\n")
        for s in run.trace.shortfall:
            log.write(f"profile left out (held of launched): {s}\n")
        log.write(f"profiles kept {run.trace.kept}, left out "
                  f"{run.trace.dropped}; tracing took " + ", ".join(
                      f"{k} {v:.3f}" for k, v in run.trace.costs.items())
                  + "\n")
    out: Dict = {"correct": False, "attempted": 0, "failed": 0,
                 "metrics": {}, "device": {}}
    if run.cuda:
        out["device"] = _device_info(run, chips)
    else:
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    if trace:
        for m, mod in readers:
            value = mod.read(run)
            if value is not None:
                out["metrics"][m["name"]] = {"value": float(value),
                                             "unit": m["unit"]}
        if run.trace is not None and run.trace.kept:
            out["device"]["busy_s"] = run.trace.busy_s
            out["device"]["window_s"] = run.trace.window_s
            out["breakdown"] = run.trace.breakdown()
        for t in run.timers.values():
            t.restore()
        run.spans.restore()
    else:
        names = run.cell["metrics"]
        setup = {"setup_s": run.window_start - run.t0}
        for m in spec.metrics_of(bench, "end_to_end", name):
            key = names.get(m["name"], m["name"])
            value = setup.get(key, raw.get(key))
            if value is None:
                raise RuntimeError(f"{name}: its traffic generator gave "
                                   f"no {key}")
            out["metrics"][m["name"]] = {"value": float(value),
                                         "unit": m["unit"]}
    numbers = reference.compare(run.want, run.delivered)
    out["correct"] = reference.passed(numbers)
    out["attempted"] = sum(len(run.want[k]) for k, _ in run.delivered)
    out["failed"] = numbers["frames_missing"] + numbers["frames_off"]
    out["checks"] = {k: {"value": numbers[k], "limit": lim}
                     for k, lim in reference.LIMITS.items()}
    out["checks"]["frames_compared"] = {"value": numbers["frames"],
                                        "limit": ">= 1"}
    return out


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t0=t0)
    except SystemExit as e:
        sys.stderr.write(f"{e}\n")
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    found = guard.loaded()
    if found:
        sys.stderr.write("refused modules were loaded: "
                         f"{', '.join(found)}\n")
        return 3
    for k, c in out["checks"].items():
        sys.stderr.write(f"check {k} {c['value']} limit {c['limit']}\n")
    sys.stderr.flush()
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0
