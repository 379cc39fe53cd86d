"""The mode decision's Hadamard cost over batches of macroblocks
(counterpart of `libav_tpu/ops/mecmp.py`; reference: me_cmp.c
hadamard8_diff8x8_c and hadamard8_diff16_c).

The JAX encoder runs the 8x8 Hadamard as two int32 einsums (H D H^T);
here it is the Sylvester butterfly network along each axis in int32 adds
(CUDA's matmul takes no integer tensors), which computes the same
transform exactly: |entries| stay below 64 * 510. The JAX module's other
costs (SAD, SSE, the 8x8 and pairwise SATD, the numpy reference) have no
caller in the port and are left out.
"""

from __future__ import annotations

import torch


def fwht(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x multiplied by the Sylvester Hadamard matrix along dim (a power
    of two long): H_2n [a; b] = [H_n a + H_n b; H_n a - H_n b]."""
    n = x.shape[dim]
    if n == 1:
        return x
    a, b = (fwht(h, dim) for h in x.split(n // 2, dim))
    return torch.cat((a + b, a - b), dim)


def hadamard8(d: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) int32 -> H d H^T (H symmetric)."""
    return fwht(fwht(d, -2), -1)


def satd16_of(d: torch.Tensor) -> torch.Tensor:
    """hadamard8_diff16_c of a difference (N, 16, 16) int32: an 8x8 SATD
    per quadrant, summed."""
    n = d.shape[0]
    q = d.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4).reshape(n * 4, 8, 8)
    return hadamard8(q).abs().sum(dim=(-1, -2), dtype=torch.int32) \
        .reshape(n, 4).sum(dim=1, dtype=torch.int32)
