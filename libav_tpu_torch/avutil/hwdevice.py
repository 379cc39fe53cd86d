"""Device selection and description, and the synchronous upload of a
decoder's per-picture host state (counterpart of
`libav_tpu/avutil/hwdevice.py`; reference: libavutil/hwcontext.h
av_hwdevice_ctx_create).

The caller names the device. Asking for CUDA where there is none raises:
nothing here falls back to another device.
"""

from __future__ import annotations

import subprocess
from typing import Any, Dict, Union

import numpy as np
import torch


def device(spec: Union[str, torch.device]) -> torch.device:
    """'cpu', 'cuda' or 'cuda:N' -> a validated torch.device ('cuda'
    becomes 'cuda:0')."""
    d = torch.device(spec)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"unsupported device {spec!r}: use cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {spec!r} requested but CUDA is not "
                           "available on this host")
    index = 0 if d.index is None else d.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"device {spec!r} requested but this host has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


def nvidia_smi(index: int = 0) -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader", "-i", str(index)],
                       capture_output=True, text=True, check=True,
                       timeout=60)
    return r.stdout.strip()


def describe(dev: torch.device) -> Dict:
    """{platform, kind, count} of a device from `device()`, plus the
    nvidia-smi name and power limit for a CUDA device."""
    if dev.type == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi(dev.index or 0)}


def state_from_numpy(state: Any, device: torch.device) -> Any:
    """The JAX program's host state -> the port's tensors on device.

    state is any nesting of tuples, lists and dicts holding numpy arrays
    (the decoder's per-frame arguments, the DPB's padded reference planes
    as the JAX program returns them), tensors or None. Arrays are copied
    (the host may reuse its buffers for the next frame) and keep their
    dtype; the program widens and converts indices itself."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state.to(device)
    if isinstance(state, dict):
        return {k: state_from_numpy(v, device) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(state_from_numpy(v, device) for v in state)
    return torch.tensor(np.asarray(state), device=device)


def program_factory(factory, device: torch.device):
    """A port program factory behind the JAX factory's interface:
    f(*key, **flags) returns run(*args, **kw), which uploads its
    arguments to device (state_from_numpy) and runs the module that
    factory(*key, **flags, device=device) builds."""
    def program(*key, **flags):
        module = factory(*key, **flags, device=device)

        def run(*args, **kw):
            args, kw = state_from_numpy((args, kw), device)
            return module(*args, **kw)
        return run
    return program
