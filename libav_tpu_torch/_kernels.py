"""Build and load the port's CUDA kernels (counterpart of
`libav_tpu/native/build.py`).

Every `csrc/*.cu` is compiled by nvcc for Hopper into one shared library
with a plain C interface, loaded through ctypes. The library goes to
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

HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: name -> argtypes (every function returns cudaError_t)
SIGNATURES = {
    # lines, out, qp, bs, n, a_off, b_off, chroma, tab, stream
    "h264_edge_filter_lines": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # y, u, v, grids, mb_w, mb_h, wave, slots, a_off, b_off, tab, stream
    "h264_deblock_wave": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
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
    """Compile the library unless this source hash is already built.
    Returns (path, seconds spent compiling, nvcc's report)."""
    path = library_path()
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        with open(log_path) as f:
            return path, 0.0, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    report = r.stdout + r.stderr
    with open(log_path, "w") as f:
        f.write(report)
    os.replace(tmp, path)
    return path, seconds, report


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
