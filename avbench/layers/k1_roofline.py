"""Kernel K1 (`h264_deblock_frame`, `csrc/h264_deblock.cu`), percent of
the memory roofline, cold: its device time from the traced units'
profiles, the L2 flushed before each launch; bytes from
`avbench/roofline.py` `k1_bytes` at the published HBM rate. Moves
`decode_fps`."""

SYMBOL = "h264_deblock_frame"
KERNEL = "deblock_frame_kernel"


def install(run):
    if run.trace is None:
        return
    from avbench import roofline
    from avbench.trace import ColdLaunches
    # arguments: y, u, v, grids, mb_w, mb_h, ...
    run.timers[SYMBOL] = ColdLaunches(
        run.trace, SYMBOL, lambda a: roofline.k1_bytes(a[4], a[5]))


def read(run):
    t = run.timers.get(SYMBOL)
    return (t.share(KERNEL, run.torch.cuda.get_device_name(run.device))
            if t else None)
