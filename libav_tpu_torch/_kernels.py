"""Build and load the port's CUDA kernels (counterpart of
`libav_tpu/native/build.py`).

Every `csrc/*.cu` is compiled by nvcc for Hopper (one nvcc per source,
in parallel) and linked into one shared library with a plain C
interface, loaded through ctypes. The library goes to
`_build/`, named by a hash of the sources and flags, and is built at
first use, from the sources in this checkout only. A C file of this kind
builds in seconds; one that includes PyTorch's headers takes minutes.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: name -> argtypes (every function returns cudaError_t)
SIGNATURES = {
    # lines, out, qp, bs, n, a_off, b_off, chroma, tab, stream
    "h264_edge_filter_lines": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # y, u, v, grids, mb_w, mb_h, wave, slots, a_off, b_off, tab, stream
    "h264_deblock_wave": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    # in, out, n, consts (host), stream
    "mpv_idct8x8": (_P, _P, _I, _P, _P),
}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkernels_{h.hexdigest()[:16]}.so")


def build() -> tuple:
    """Compile the library unless this source hash is already built: one
    nvcc per source, all started together, then one link. Returns (path,
    seconds spent compiling and linking, nvcc's report)."""
    path = library_path()
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        with open(log_path) as f:
            return path, 0.0, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        jobs = []
        for src in (s for s in sources() if s.endswith(".cu")):
            obj = os.path.join(work, os.path.basename(src) + ".o")
            jobs.append((src, obj, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report, failed = [], []
        for src, _, proc in jobs:
            out = proc.communicate()[0]
            report.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} "
                              f"({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        r = subprocess.run([nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                            *[obj for _, obj, _ in jobs]],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        seconds = time.perf_counter() - t0
        report = "".join(report) + r.stdout + r.stderr
        with open(log_path, "w") as f:
            f.write(report)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path, seconds, report


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------- #
# launch helpers for the wrappers in ops/
# ---------------------------------------------------------------------- #

def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on device, where every kernel launches."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_int32(name: str, t: torch.Tensor, device: torch.device,
                shape=None) -> None:
    """Raise unless t is a contiguous int32 tensor on device [of shape]."""
    if t.device != device or t.dtype != torch.int32 or \
            not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous int32 tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def raise_on(err: int, what: str) -> None:
    """Raise for the cudaError_t a launch function returned."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
