"""The yardstick of the kernels: the published peaks of the card and the
bytes each hand kernel must move, frozen here so that a change to the
port cannot move them.

Bytes count each input read once and each output written once, from the
launch's own sizes (the functions of `chip_smoke.py` `bound_ms`, applied
to the kernels' argument shapes in `libav_tpu_torch/_kernels.py`).
"""

from __future__ import annotations

# published HBM bandwidth by the name torch.cuda.get_device_name gives:
# NVIDIA H100 SXM5 80 GB (HBM3), at its 700 W limit
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"
# written before each timed launch: more than the 50 MB L2, so it starts
# cold
FLUSH_BYTES = 128 << 20


def hbm_bytes_per_ms(card: str = DEFAULT_CARD) -> float:
    return HBM_BYTES_PER_S.get(card, HBM_BYTES_PER_S[DEFAULT_CARD]) / 1e3


def k1_bytes(mb_w: int, mb_h: int) -> int:
    """`h264_deblock_frame` over one picture of mb_w x mb_h macroblocks:
    the int32 planes padded by 4 (luma, two chroma) read and written, and
    the eight (4mb_h, 4mb_w) int32 bS/qp grids read."""
    luma = (16 * mb_h + 4) * (16 * mb_w + 4)
    chroma = (8 * mb_h + 4) * (8 * mb_w + 4)
    grids = 8 * (4 * mb_h) * (4 * mb_w)
    return 4 * (2 * luma + 2 * 2 * chroma + grids)


def k2_bytes(blocks: int) -> int:
    """`mpv_idct8x8` over `blocks` 8x8 int32 blocks, read and written."""
    return blocks * 64 * 4 * 2
