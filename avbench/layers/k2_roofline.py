"""Kernel K2 (`mpv_idct8x8`, `csrc/mpv_idct.cu`), percent of the memory
roofline, cold: its device time from the traced units' profiles, the
L2 flushed before each launch; 512 bytes a block (`avbench/roofline.py`
`k2_bytes`), the blocks from the launch's own count, at the published
HBM rate. Moves `decode_fps`."""

SYMBOL = "mpv_idct8x8"
KERNEL = "idct8x8_kernel"


def install(run):
    if run.trace is None:
        return
    from avbench import roofline
    from avbench.trace import ColdLaunches
    # arguments: in, out, blocks, constants, stream
    run.timers[SYMBOL] = ColdLaunches(
        run.trace, SYMBOL, lambda a: roofline.k2_bytes(a[2]))


def read(run):
    t = run.timers.get(SYMBOL)
    return (t.share(KERNEL, run.torch.cuda.get_device_name(run.device))
            if t else None)
