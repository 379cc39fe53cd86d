"""Frames whose planes are torch tensors (counterpart of
`libav_tpu/avutil/frame.py` Frame.to_host / to_device; reference:
hwcontext.h av_hwframe_transfer_data).

The JAX package's Frame moves planes with np.asarray and jax.device_put,
which do not take CUDA tensors; this subclass moves them with torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from libav_tpu.avutil.frame import Frame as _Frame
from libav_tpu.avutil.frame import Packet  # noqa: F401  (re-export)


class Frame(_Frame):
    def to_host(self) -> "Frame":
        """Device -> host: planes become numpy arrays."""
        out = self.clone_props()
        out.planes = [p.cpu().numpy() if isinstance(p, torch.Tensor)
                      else np.asarray(p) for p in self.planes]
        return out

    def to_device(self, device) -> "Frame":
        """Host -> device: planes become tensors on device."""
        out = self.clone_props()
        out.planes = [torch.as_tensor(p).to(device) for p in self.planes]
        return out

    def clone_props(self) -> "Frame":
        """Metadata copy sharing the plane references, as this class."""
        base = super().clone_props()
        return type(self)(**{f.name: getattr(base, f.name)
                             for f in dataclasses.fields(base)})
