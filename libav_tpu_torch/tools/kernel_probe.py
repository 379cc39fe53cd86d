"""Kernel-versus-plain timing on the card (counterpart of
`libav_tpu/tools/pallas_probe.py`, with its CLI, seeds and inputs):

    python -m libav_tpu_torch.tools.kernel_probe [batch] [iters]
    python -m libav_tpu_torch.tools.kernel_probe deblock [batch] [iters]

For the 8x8 IDCT (default 48,896 blocks, a 1080-line frame) and the H.264
luma edge filter (default 49,152 lines, qp 30) it times three versions of
one function on the same inputs after a warm-up, each as the median of
`iters` calls bracketed by CUDA events (what a caller waits, launch
included: at these sizes the host's share) and as the mean device time
per call by torch.profiler (the kernels alone; inputs stay in L2):
  - the plain PyTorch version (idct8x8_int_plain / filter_edge_qp);
  - the production kernel in the decoders' layout (K2 idct8x8_int on
    (B, 8, 8), K1 h264_edge_filter_lines on (B, 8));
  - the probe-layout kernel (P1 idct8x8_int_cm on (64, B), P2
    h264_edge_filter_pm on (8, B)), whose TPU versions were the Pallas
    kernels of pallas_probe.py.
All three are checked bit-exact against the JAX package's numpy
reference (idct8x8_int_ref / filter_edge_ref) on every input. Any batch
size works (the TPU versions needed multiples of 128 and 512). The times
stand beside the card's nvidia-smi name and power limit; a device other
than CUDA raises.
"""

from __future__ import annotations

import statistics
import sys
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from libav_tpu.ops.h264deblock import filter_edge_ref
from libav_tpu.ops.idct import idct8x8_int_ref
from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.ops import h264deblock as db
from libav_tpu_torch.ops import idct

IDCT_BATCH = 48896          # a 1080-line frame's blocks
DEBLOCK_BATCH = 49152
DEBLOCK_QP = 30


def idct_inputs(batch: int) -> np.ndarray:
    """pallas_probe's IDCT blocks: (batch, 8, 8) int32, seed 1, every
    third block DC-only."""
    rng = np.random.default_rng(1)
    blocks = rng.integers(-512, 512, (batch, 8, 8)).astype(np.int32)
    blocks[::3, :, :] = 0
    blocks[::3, 0, 0] = rng.integers(-512, 512, ((batch + 2) // 3,))
    return blocks


def deblock_inputs(batch: int):
    """pallas_probe's edge lines: (batch, 8) int32 lines, seed 7, every
    other line smooth; qp 30 for all; bS 0-4."""
    rng = np.random.default_rng(7)
    lines = rng.integers(0, 256, (batch, 8)).astype(np.int32)
    lines[::2] = np.clip(lines[::2, :1] +
                         rng.integers(-6, 7, (batch // 2 + batch % 2, 8)),
                         0, 255)
    bs = rng.integers(0, 5, (batch,)).astype(np.int32)
    return lines, np.full((batch,), DEBLOCK_QP, np.int32), bs


class Timing(NamedTuple):
    label: str          # function and layout
    ms: float           # median per call, CUDA events
    device_ms: float    # mean per call on the device, torch.profiler
    exact: bool         # bit-exact to the numpy reference


def median_ms(fn: Callable, iters: int) -> float:
    """Median milliseconds of one fn() call over iters calls after three
    warm-up calls, each bracketed by CUDA events on the current stream."""
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn: Callable, iters: int) -> float:
    """Mean milliseconds per fn() call that CUDA kernels ran on the device,
    by torch.profiler over iters calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) \
        / iters / 1e3


def _measure(runs: Dict, ref: np.ndarray, iters: int) -> Dict[str, Timing]:
    """runs: role -> (label, fn, to_ref_layout)."""
    return {role: Timing(label, median_ms(fn, iters), device_ms(fn, iters),
                         np.array_equal(layout(fn()).cpu().numpy(), ref))
            for role, (label, fn, layout) in runs.items()}


def _cuda(device) -> torch.device:
    dev = hwdevice.device(device)
    if dev.type != "cuda":
        raise ValueError(f"kernel_probe times CUDA kernels: got {dev}")
    return dev


def probe_idct(batch: int = IDCT_BATCH, iters: int = 50,
               device="cuda") -> Dict:
    """-> Timing of the plain version, the production kernel (K2) and
    the probe-layout kernel (P1), by role."""
    dev = _cuda(device)
    blocks = idct_inputs(batch)
    ref = idct8x8_int_ref(blocks)
    x = torch.as_tensor(blocks).to(dev)
    xT = x.reshape(batch, 64).T.contiguous()
    runs = {
        "plain": ("plain idct8x8_int_plain (B,8,8)",
                  lambda: idct.idct8x8_int_plain(x), lambda o: o),
        "production": ("K2 idct8x8_int (B,8,8)",
                       lambda: idct.idct8x8_int(x), lambda o: o),
        "probe": ("P1 idct8x8_int_cm (64,B)",
                  lambda: idct.idct8x8_int_cm(xT),
                  lambda o: o.T.reshape(batch, 8, 8)),
    }
    return _measure(runs, ref, iters)


def probe_deblock(batch: int = DEBLOCK_BATCH, iters: int = 50,
                  device="cuda") -> Dict:
    """-> Timing of the plain version, the production kernel (K1's line
    kernel) and the probe-layout kernel (P2), by role."""
    dev = _cuda(device)
    lines, qp, bs = deblock_inputs(batch)
    ref = filter_edge_ref(lines, DEBLOCK_QP, bs)
    lt, qt, bt = (torch.as_tensor(a).to(dev) for a in (lines, qp, bs))
    ltT = lt.T.contiguous()
    runs = {
        "plain": ("plain filter_edge_qp (B,8)",
                  lambda: db.filter_edge_qp(lt, qt, bt), lambda o: o),
        "production": ("K1 h264_edge_filter_lines (B,8)",
                       lambda: db.h264_edge_filter_lines(lt, qt, bt),
                       lambda o: o),
        "probe": ("P2 h264_edge_filter_pm (8,B)",
                  lambda: db.h264_edge_filter_pm(ltT, qt, bt),
                  lambda o: o.T),
    }
    return _measure(runs, ref, iters)


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    deblock = bool(argv) and argv[0] == "deblock"
    if deblock:
        argv = argv[1:]
    batch = int(argv[0]) if argv else (DEBLOCK_BATCH if deblock
                                       else IDCT_BATCH)
    iters = int(argv[1]) if len(argv) > 1 else 50
    dev = _cuda(device)
    results = (probe_deblock if deblock else probe_idct)(batch, iters, dev)
    print(hwdevice.nvidia_smi(dev.index or 0))
    print(f"device={dev} ({torch.cuda.get_device_name(dev)}) batch={batch} "
          f"{'edge lines' if deblock else 'blocks'}: median ms of {iters} "
          f"calls by CUDA events, mean device ms per call by torch.profiler")
    for t in results.values():
        print(f"{t.label:34s} {t.ms:10.4f} ms/call {t.device_ms:10.4f} ms "
              f"device  bitexact={t.exact}")
    return 0 if all(t.exact for t in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
