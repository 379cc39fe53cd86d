"""libav_tpu_torch: the PyTorch/CUDA port of tpu-av, beside `libav_tpu`.

The split is the JAX package's: the host runs container parsing, entropy
decoding and DPB bookkeeping (reused as they are from the jax-free host
layers of `libav_tpu`: codecs.api, codecs.h264 host modules, native/,
bitstream/, formats/, avutil/), and the device runs the numeric program of
each frame. Here that program is PyTorch on an explicit `torch.device`,
and each Pallas kernel of the JAX package on the ported path is a kernel
written by hand for Hopper (`csrc/`, built by `_kernels.py`).

This package imports torch and never jax. `libav_tpu` is unchanged and is
the reference every module here is held against.
"""

__version__ = "0.1.0"

# Large per-frame host buffers (coefficient transports, block-motion
# exports) default to mmap-backed allocations above glibc's 128KB
# threshold, so every frame pays fresh-page faults on multi-MB np.empty
# buffers. Raising M_MMAP_THRESHOLD keeps them on the heap where warm
# pages recycle across frames. Safe with the synchronous uploads here:
# malloc recycles a buffer only after its last reference is dropped.
try:
    import ctypes as _ctypes

    _libc = _ctypes.CDLL(None)
    _libc.mallopt(-3, 1 << 30)       # M_MMAP_THRESHOLD
    _libc.mallopt(-1, 1 << 30)       # M_TRIM_THRESHOLD
except Exception:
    pass
