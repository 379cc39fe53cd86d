"""H.264 intra assembly of one picture in one launch: `h264_intra_frame`,
the hand-written CUDA kernel in `csrc/h264_intra.cu`.

It replaces no TPU kernel: the JAX package assembles intra pictures in
XLA, and the port's plain version, `ReconH264._wavefront` in
`codecs/h264/device.py`, walks the macroblock waves from the host (254
waves of small torch operations at 1080p). The kernel is a persistent
wavefront on the pattern of K1's frame deblock: blocks of 256 threads
take macroblock rows from an atomic ticket, walk them left to right and
wait on the row above through per-row progress counters; each
macroblock's neighbours sit in shared memory while it is predicted, its
I_4x4 and I_8x8 sub-block chains on one warp. Its result equals
`_wavefront`'s byte for byte.

`ReconH264.forward` launches it for CUDA tensors and runs `_wavefront`
for CPU tensors; the wrapper raises for any other device.
"""

from __future__ import annotations

import torch

from libav_tpu_torch._kernels import (check_int32, count_launch, library,
                                      ptr, raise_on, stream)
from libav_tpu_torch.avutil import timer


def h264_intra_frame(mb_w: int, mb_h: int, any_i4: bool, any_i8: bool,
                     any_ipcm: bool, intra, luma_mode, chroma_mode, row_top,
                     i4, i4_modes, t8, pred, resid, pcm):
    """The intra assembly of one picture: `ReconH264._wavefront`'s
    arguments after the geometry and its any_* flags (pred, resid:
    (y, u, v) as (nmb, 16, 16) and 2 x (nmb, 8, 8); pcm: (ipcm, y, u, v),
    read only with any_ipcm; row_top may be None) -> the bordered int32
    planes fy (16 mb_h + 17, 16 mb_w + 17), fu, fv (8 mb_h + 9,
    8 mb_w + 9), in one launch on the current stream."""
    dev = intra.device
    if dev.type != "cuda":
        raise ValueError(f"h264_intra_frame: no kernel for {dev}")
    nmb = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w
    keep = []        # the int32 inputs, alive until the launch

    def arg(name, t, *shape):
        """t as an int32 kernel argument of that shape; None: a null."""
        if t is None:
            return None
        t = t.to(torch.int32).contiguous()
        check_int32(name, t, dev, shape)
        keep.append(t)
        return ptr(t)

    pcm = pcm if any_ipcm else (None,) * 4
    args = [arg("pred_y", pred[0], nmb, 16, 16),
            arg("pred_u", pred[1], nmb, 8, 8),
            arg("pred_v", pred[2], nmb, 8, 8),
            arg("resid_y", resid[0], nmb, 16, 16),
            arg("resid_u", resid[1], nmb, 8, 8),
            arg("resid_v", resid[2], nmb, 8, 8),
            arg("intra", intra, nmb),
            arg("luma_mode", luma_mode, nmb),
            arg("chroma_mode", chroma_mode, nmb),
            arg("i4", i4 if any_i4 else None, nmb),
            arg("i4_modes", i4_modes if any_i4 else None, nmb, 16),
            arg("t8", t8 if any_i4 and any_i8 else None, nmb),
            arg("row_top", row_top, mb_h),
            arg("ipcm", pcm[0], nmb),
            arg("ipcm_y", pcm[1], nmb, 16, 16),
            arg("ipcm_u", pcm[2], nmb, 8, 8),
            arg("ipcm_v", pcm[3], nmb, 8, 8)]
    fy = torch.full((1 + H + 16, 1 + W + 16), 128, dtype=torch.int32,
                    device=dev)
    fu = torch.full((1 + H // 2 + 8, 1 + W // 2 + 8), 128,
                    dtype=torch.int32, device=dev)
    fv = fu.clone()
    # [row ticket | MBs published per row]
    scratch = torch.zeros(mb_h + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = library().h264_intra_frame(
            ptr(fy), ptr(fu), ptr(fv), *args, mb_w, mb_h, ptr(scratch),
            stream(dev))
    raise_on(err, "h264_intra_frame")
    count_launch(h264_intra_frame)
    timer.count("h264.intra.kernel")
    return fy, fu, fv


h264_intra_frame.launches = 0
