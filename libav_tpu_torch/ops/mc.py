"""Reference-plane padding for motion compensation (counterpart of
`libav_tpu/ops/mc.py` EDGE and pad_plane)."""

from __future__ import annotations

import torch

from libav_tpu.ops.mc import EDGE  # noqa: F401  (the same margin, by import)


def pad_plane(plane: torch.Tensor, edge: int = EDGE) -> torch.Tensor:
    """Edge-replicate pad of a 2-D plane of any dtype (reference: videodsp
    emulated_edge_mc / draw_edges). Written as a clamped gather because
    torch's replicate padding does not take integer tensors."""
    h, w = plane.shape
    rows = torch.arange(-edge, h + edge, device=plane.device).clamp_(0, h - 1)
    cols = torch.arange(-edge, w + edge, device=plane.device).clamp_(0, w - 1)
    return plane[rows[:, None], cols[None, :]]
