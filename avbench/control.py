"""The checks of the check: the control, and the faults that `correct`
must catch.

The control is the program with one guarantee of the configuration
broken, the step that would tempt a faster decoder:
  - H.264: the in-loop deblocking filter skipped on non-reference
    pictures (what `-skip_loop_filter nonref` does);
  - MPEG-2: a float IDCT, rounded, in place of the bit-exact simple
    integer IDCT (IEEE 1180 accuracy, not bit-exactness).
The faults are planted where the port's decoder hands out its frames
(`Decoder.receive_frame`):
  - unchanged: every second frame is its predecessor again (a step that
    returns its state unchanged);
  - half: every second frame is left out;
  - altered: one sample of one frame per decoder is changed.

    python3 avbench/control.py --workload <name> --seeds 1,2,3 \
        --mode control|unchanged|half|altered|none [--seconds s]

runs the cell once per seed in one process (no warm-up: nothing here
is timed) and prints each run's numbers.
"""

from __future__ import annotations

import contextlib
import time

MODES = ("none", "control", "unchanged", "half", "altered")


def float_idct8x8(blocks):
    """IDCT in float64 with the orthonormal DCT-II basis, rounded to the
    nearest integer: (B, 8, 8) int32 -> (B, 8, 8) int32."""
    import math
    import torch
    n = torch.arange(8, dtype=torch.float64, device=blocks.device)
    c = torch.cos((2 * n[None, :] + 1) * n[:, None] * math.pi / 16)
    c[0] *= math.sqrt(0.5)
    c *= 0.5
    x = blocks.to(torch.float64)
    return torch.round(c.T @ x @ c).to(torch.int32)


@contextlib.contextmanager
def _patched(owner, name, value):
    inner = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, inner)


def broken(codec: str):
    """Context in which the port's decoder of `codec` breaks the
    configuration's guarantee (the control)."""
    if codec == "h264":
        from libav_tpu_torch.codecs.h264.dec import H264Decoder
        inner = H264Decoder._reconstruct

        def reconstruct(self, fd, slice_info):
            # slice_info: slice type, idr, poc, nal_ref_idc
            if slice_info[3] == 0 and fd.recon_ctx[1]:
                sps, _, ab, weights, pps = fd.recon_ctx
                fd.recon_ctx = (sps, False, ab, weights, pps)
            return inner(self, fd, slice_info)
        return _patched(H264Decoder, "_reconstruct", reconstruct)
    if codec in ("mpeg2video", "mpeg1video"):
        from libav_tpu_torch.codecs import mpegvideo
        return _patched(mpegvideo, "idct8x8_int", float_idct8x8)
    raise ValueError(f"no control for {codec}")


@contextlib.contextmanager
def fault(kind: str):
    """Plant a fault where the port's decoders hand out frames."""
    from libav_tpu_torch.codecs.api import Decoder
    inner = Decoder.receive_frame

    def receive(self):
        f = inner(self)
        n = getattr(self, "_fault_n", 0)
        self._fault_n = n + 1
        if kind == "half" and n % 2 == 1:
            return receive(self)
        if kind == "unchanged" and n % 2 == 1:
            g = f.clone_props()
            g.planes = list(self._fault_prev.planes)
            f = g
        elif kind == "altered" and n == 1:
            g = f.clone_props()
            y = g.planes[0]
            y = y.clone() if hasattr(y, "clone") else y.copy()
            y[0, 0] = y[0, 0] ^ 1
            g.planes[0] = y
            f = g
        self._fault_prev = f
        return f
    Decoder.receive_frame = receive
    try:
        yield
    finally:
        Decoder.receive_frame = inner


def runs(workload: str, seeds, mode: str, seconds: float = 1.0, *,
         device=None, bench=None, cells_dir=None, log=None):
    """Run the cell once per seed under `mode` -> [(seed, result)]."""
    from avbench import harness, spec
    bench = bench or spec.benchmark()
    codec = spec.config(bench, spec.workload(bench, workload)["config"])[
        "codec"]
    out = []
    for seed in seeds:
        if mode == "control":
            ctx = broken(codec)
        elif mode == "none":
            ctx = contextlib.nullcontext()
        else:
            ctx = fault(mode)
        with ctx:
            r = harness.run_cell(workload, seed, seconds, False,
                                 t0=time.perf_counter(), device=device,
                                 bench=bench, cells_dir=cells_dir,
                                 warm=False)
        out.append((seed, r))
        if log is not None:
            log(f"{workload} {mode} seed {seed}: correct {r['correct']}, "
                + ", ".join(f"{k} {c['value']} (limit {c['limit']})"
                            for k, c in r["checks"].items()))
    return out


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="control and fault runs")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", choices=MODES, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    a = p.parse_args(argv)
    runs(a.workload, [int(s) for s in a.seeds.split(",")], a.mode,
         a.seconds, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    import os
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != here]
    sys.path.insert(0, os.path.dirname(here))
    from avbench import guard
    guard.install()
    sys.exit(main())
