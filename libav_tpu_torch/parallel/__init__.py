"""Multi-device scale-out of the port (counterpart of
`libav_tpu/parallel`; SURVEY.md §2.10: the reference is single-node — its
frame/slice threading maps to the device batch axis; scale-out across
devices is data parallelism over independent frames/GOPs/segments).

The JAX package places a batch on a jax.sharding.Mesh and lets XLA run
one program over it; here one process drives a plain list of torch
devices and each device runs its share of the batch, with no
torch.distributed.

Components:
  make_mesh()        — the device list ('data' axis over all CUDA devices)
  shard_batch()      — a host batch split over the devices on its batch axis
  replicate()        — a host array copied to every device
  sharded_h264_recon_step — the real H.264 whole-frame reconstruction
      program (codecs/h264/device.py recon_h264) over a frame batch split
      across the devices, plus the global coded-bit statistic summed on
      the first device
  gop.py             — GOP-parallel decoding of real bitstreams
  prefetch.py        — the CLI's packet prefetcher
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first n CUDA devices (all by default), validated: a host
    without CUDA raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device on this host")
    n = torch.cuda.device_count() if n_devices is None else n_devices
    return [hwdevice.device(f"cuda:{i}") for i in range(n)]


def shard_batch(devices: Sequence, arr, batch_axis: int = 0
                ) -> List[torch.Tensor]:
    """arr split into len(devices) equal chunks along batch_axis, chunk k
    on devices[k] (the batch must divide evenly, as a sharded jax array's
    must), uploaded as the decoders upload their state
    (hwdevice.state_from_numpy: a copy that keeps the dtype)."""
    a = np.asarray(arr)
    n = len(devices)
    if a.shape[batch_axis] % n:
        raise ValueError(f"shard_batch: batch of {a.shape[batch_axis]} does "
                         f"not split over {n} devices")
    return [hwdevice.state_from_numpy(c, hwdevice.device(d))
            for c, d in zip(np.split(a, n, axis=batch_axis), devices)]


def replicate(devices: Sequence, arr) -> List[torch.Tensor]:
    """arr copied to every device."""
    a = np.asarray(arr)
    return [hwdevice.state_from_numpy(a, hwdevice.device(d))
            for d in devices]


def sharded_h264_recon_step(devices: Sequence, mb_w: int, mb_h: int):
    """The REAL codec pipeline, split over devices: a batch of frames
    (independent GOP segments — the reference's frame-threading axis,
    pthread_frame.c:351, promoted to a device batch axis) run through the
    full H.264 device reconstruction program (codecs/h264/device.py:
    residual dequant/IDCT + qpel/chroma MC + intra wavefront assembly),
    each device reconstructing its chunk frame by frame, plus the global
    coded-bit statistic (the sum rate control reads): each device's int64
    sum of |luma_ac| + |chroma_ac|, added on devices[0].

    Returns (step_fn, shard_inputs): shard_inputs places a host arg tuple
    (each array with the batch first) over the devices, and
    step_fn(*sharded) -> ((y, u, v), bits), each plane a list of
    per-device (B / n, H, W) uint8 chunks and bits an int64 scalar on
    devices[0]."""
    from libav_tpu_torch.codecs.h264.device import recon_h264

    devs = [hwdevice.device(d) for d in devices]
    recons = [recon_h264(mb_w, mb_h, True, 1, device=d) for d in devs]

    def step(intra, luma_mode, chroma_mode, mv, qp,
             luma_dc, luma_ac, chroma_dc, chroma_ac, ry, ru, rv):
        args = (intra, luma_mode, chroma_mode, mv, qp, luma_dc, luma_ac,
                chroma_dc, chroma_ac, ry, ru, rv)
        ys, us, vs, sums = [], [], [], []
        for k, recon in enumerate(recons):
            chunk = [a[k] for a in args]
            frames = [recon(*(c[b] for c in chunk))[0]
                      for b in range(chunk[0].shape[0])]
            ys.append(torch.stack([f[0] for f in frames]))
            us.append(torch.stack([f[1] for f in frames]))
            vs.append(torch.stack([f[2] for f in frames]))
            sums.append(chunk[6].abs().to(torch.int64).sum() +
                        chunk[8].abs().to(torch.int64).sum())
        bits = torch.stack([s.to(devs[0]) for s in sums]).sum()
        return (ys, us, vs), bits

    def shard_inputs(args):
        return tuple(shard_batch(devs, a) for a in args)

    return step, shard_inputs
