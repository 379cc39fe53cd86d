"""Rate control (reference: libavcodec/ratecontrol.c (986):
ff_rate_estimate_qscale :831, the av_expr_eval'd rc_eq bit model :253,
default equation 'tex^qComp' :486, and the 2-pass stats log
RateControlEntry :41 / AV_CODEC_FLAG_PASS1/PASS2 handling).

Model (same structure as the reference):
  - per-frame complexity estimate from the last frame's texture bits
  - rc_eq maps complexity -> a quality 'rq' value per picture type
  - a feedback term scales qscale to track the target bitrate with a
    virtual buffer
  - 2-pass: pass 1 appends one stats line per frame; pass 2 replays the
    log and distributes bits proportionally to rq.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from libav_tpu_torch.avutil.eval import expr_eval
from libav_tpu_torch.avutil.rational import Rational


@dataclass
class RateControlEntry:
    """reference: ratecontrol.h:41 RateControlEntry (stats-log row)"""
    pict_type: str = "I"
    qscale: float = 4.0
    bits: int = 0
    tex_bits: int = 0
    mv_bits: int = 0
    misc_bits: int = 0

    def line(self) -> str:
        return (f"in:0 out:0 type:{self.pict_type} q:{self.qscale:.2f} "
                f"itex:{self.tex_bits} ptex:0 mv:{self.mv_bits} "
                f"misc:{self.misc_bits} fcode:1 bcode:1")

    @staticmethod
    def parse(line: str) -> "RateControlEntry":
        e = RateControlEntry()
        for tok in line.split():
            if ":" not in tok:
                continue
            k, v = tok.split(":", 1)
            if k == "type":
                e.pict_type = v
            elif k == "q":
                e.qscale = float(v)
            elif k == "itex":
                e.tex_bits = int(v)
            elif k == "mv":
                e.mv_bits = int(v)
            elif k == "misc":
                e.misc_bits = int(v)
        e.bits = e.tex_bits + e.mv_bits + e.misc_bits
        return e


class RateControl:
    """reference: ratecontrol.c RateControlContext + estimate_qscale."""

    DEFAULT_RC_EQ = "tex^qComp"

    def __init__(self, bit_rate: int, fps: Rational,
                 qmin: int = 2, qmax: int = 31,
                 rc_eq: str = DEFAULT_RC_EQ, qcompress: float = 0.6,
                 i_quant_factor: float = 0.8,
                 buffer_size: Optional[int] = None):
        self.bit_rate = bit_rate
        self.fps = float(fps) if fps else 25.0
        self.bits_per_frame = bit_rate / self.fps if self.fps else bit_rate
        self.qmin, self.qmax = qmin, qmax
        self.rc_eq = rc_eq
        self.qcomp = qcompress
        self.i_quant_factor = i_quant_factor
        self.buffer_size = buffer_size or bit_rate  # 1 second vbv
        self.buffer_fill = self.buffer_size / 2
        # complexity running estimates per picture type, initialized so
        # the first frames start near a mid qscale (~8) for this target
        bpf = max(self.bits_per_frame, 1.0)
        self.cplx = {"I": bpf * 10.0, "P": bpf * 6.0, "B": bpf * 4.0}
        self.qscale_last = 8.0
        self.frame_count = 0
        self.stats: List[RateControlEntry] = []
        self.pass2_entries: Optional[List[RateControlEntry]] = None
        self._pass2_scale = 1.0

    # -- 2-pass ---------------------------------------------------------- #

    def load_pass1(self, log_text: str):
        """reference: ratecontrol.c init_pass2"""
        entries = [RateControlEntry.parse(ln)
                   for ln in log_text.strip().splitlines() if ln.strip()]
        if not entries:
            return
        self.pass2_entries = entries
        total_rq = sum(self._rq(e.tex_bits or e.bits, e.pict_type)
                       for e in entries)
        wanted = self.bits_per_frame * len(entries)
        self._pass2_scale = wanted / max(total_rq, 1e-9)

    def stats_log(self) -> str:
        return "\n".join(e.line() for e in self.stats) + "\n"

    # -- the model -------------------------------------------------------- #

    def _rq(self, tex_bits: float, pict_type: str) -> float:
        v = expr_eval(self.rc_eq, {
            "tex": max(float(tex_bits), 1.0),
            "mv": 0.0,
            "bits": max(float(tex_bits), 1.0),
            "qComp": self.qcomp,
            "isI": 1.0 if pict_type == "I" else 0.0,
            "isP": 1.0 if pict_type == "P" else 0.0,
            "isB": 1.0 if pict_type == "B" else 0.0,
            "avgQP": self.qscale_last,
            "qscale": self.qscale_last,
        })
        if pict_type == "I":
            v /= max(self.i_quant_factor, 1e-3)
        return v

    def qscale_for_frame(self, pict_type: str) -> int:
        """reference: ratecontrol.c:831 ff_rate_estimate_qscale"""
        if self.pass2_entries is not None and \
                self.frame_count < len(self.pass2_entries):
            e = self.pass2_entries[self.frame_count]
            target_bits = self._rq(e.tex_bits or e.bits, e.pict_type) * \
                self._pass2_scale
            cplx = e.bits * e.qscale if e.bits else self.cplx[pict_type]
        else:
            cplx = self.cplx.get(pict_type, 5e5)
            target_bits = self.bits_per_frame

        # buffer feedback (reference: vbv handling in modify_qscale)
        fill_ratio = self.buffer_fill / self.buffer_size
        feedback = 1.0 + (0.5 - fill_ratio) * 1.5

        q = cplx / max(target_bits * feedback, 1.0)
        q = max(self.qmin, min(self.qmax, q))
        self.qscale_last = q
        return int(round(q))

    def frame_done(self, pict_type: str, bits_used: int, qscale: float,
                   tex_bits: Optional[int] = None):
        """Feedback after encoding one frame."""
        tex = tex_bits if tex_bits is not None else int(bits_used * 0.85)
        # exponential complexity tracking: cplx ~ bits * q
        c = bits_used * max(qscale, 1.0)
        self.cplx[pict_type] = 0.7 * self.cplx.get(pict_type, c) + 0.3 * c
        self.buffer_fill += self.bits_per_frame - bits_used
        self.buffer_fill = max(0.0, min(self.buffer_size, self.buffer_fill))
        self.stats.append(RateControlEntry(
            pict_type=pict_type, qscale=qscale, bits=bits_used,
            tex_bits=tex, mv_bits=0, misc_bits=bits_used - tex))
        self.frame_count += 1


# ---------------------------------------------------------------------- #
# Adaptive (per-macroblock) quantization
# ---------------------------------------------------------------------- #

def adaptive_quantization(q, mb_mean, mb_var, mc_mb_var, intra_mask,
                          mb_w, mb_h, *,
                          lumi_masking=0.0, dark_masking=0.0,
                          temporal_cplx_masking=0.0,
                          spatial_cplx_masking=0.0, p_masking=0.0,
                          border_masking=0.0, qmin=2, qmax=31):
    """Per-MB qscale field from psychovisual masking models
    (reference: ratecontrol.c:703 adaptive_quantization, the default
    non-NAQ path where newq = q * cplx / bits = q / factor).

    Inputs are per-MB raster arrays: mb_mean (luma mean 0..255),
    mb_var (per-pixel spatial variance, the reference's
    ``(SSD - sum^2/256) >> 8`` scale), mc_mb_var (motion-compensated
    residual variance), intra_mask (bool: MB coded intra).  Returns an
    int32 qscale per MB clipped to [qmin, qmax]; the caller is
    responsible for any codec-level dquant step constraint.
    """
    import numpy as np

    n = mb_w * mb_h
    lumi_m = lumi_masking / (128.0 * 128.0)
    dark_m = dark_masking / (128.0 * 128.0)
    spat = np.maximum(np.sqrt(np.asarray(mb_var, np.float64)), 4.0)
    temp = np.maximum(np.sqrt(np.asarray(mc_mb_var, np.float64)), 4.0)
    intra_mask = np.asarray(intra_mask, bool)

    factor = np.where(intra_mask, 1.0 + p_masking,
                      np.power(temp, -temporal_cplx_masking))
    factor = factor * np.power(spat, -spatial_cplx_masking)

    # the reference's mb_mean is integer (sum>>8): truncate before the
    # 127 threshold so boundary MBs pick the same lumi/dark branch
    mean_i = np.floor(np.asarray(mb_mean, np.float64))
    d2 = (mean_i - 128.0) ** 2
    factor = factor * np.where(mean_i > 127,
                               1.0 - d2 * lumi_m, 1.0 - d2 * dark_m)

    if border_masking:
        # distance ramp inside the outer width/5 (height/5) band
        # (reference: ratecontrol.c:751-767)
        mb_x = np.arange(n) % mb_w
        mb_y = np.arange(n) // mb_w
        mbf = np.zeros(n, np.float64)
        fw, fh = mb_w // 5, mb_h // 5
        if fw > 0:
            left = (fw - mb_x) / fw
            right = (mb_x - 4 * mb_w // 5) / fw
            mbf = np.maximum(mbf, np.where(mb_x < fw, left, 0.0))
            mbf = np.maximum(mbf, np.where(mb_x > 4 * mb_w // 5,
                                           right, 0.0))
        if fh > 0:
            top = (fh - mb_y) / fh
            bot = (mb_y - 4 * mb_h // 5) / fh
            mbf = np.maximum(mbf, np.where(mb_y < fh, top, 0.0))
            mbf = np.maximum(mbf, np.where(mb_y > 4 * mb_h // 5,
                                           bot, 0.0))
        factor = factor * (1.0 - border_masking * mbf)

    factor = np.maximum(factor, 1e-5)
    # half-up like the reference's (int)(newq + 0.5), not rint's
    # half-to-even
    newq = np.floor(float(q) / factor + 0.5)
    return np.clip(newq, qmin, qmax).astype(np.int32)


def adaptive_qscale_field(q, y, ref_y, mb_w, mb_h, *, force_intra=False,
                          lumi_masking=0.0, dark_masking=0.0,
                          temporal_cplx_masking=0.0,
                          spatial_cplx_masking=0.0, p_masking=0.0,
                          border_masking=0.0, qmin=2, qmax=31):
    """Per-MB qscale field from raw luma planes: computes the per-MB
    stats (mean, spatial variance, zero-MV residual variance vs the
    reconstructed reference as a pre-ME temporal proxy for the
    reference's mc_mb_var) and runs adaptive_quantization.  ``ref_y``
    is the previous reconstructed luma (unpadded coords) or None for
    intra pictures.  The intra/inter split mirrors the mpegvideo
    variance decision (mb_var < mc_mb_var -> intra-leaning)."""
    import numpy as np

    nmb = mb_w * mb_h
    yf = np.asarray(y)[:mb_h * 16, :mb_w * 16].astype(np.float32)
    mbs = yf.reshape(mb_h, 16, mb_w, 16).transpose(0, 2, 1, 3)
    mbs = mbs.reshape(nmb, 256)
    mb_mean = mbs.mean(1)
    mb_var = mbs.var(1)
    if force_intra or ref_y is None:
        mc_var = mb_var
        intra_mask = np.ones(nmb, bool)
    else:
        ref = np.asarray(ref_y)[:mb_h * 16, :mb_w * 16]
        d = yf - ref.astype(np.float32)
        dm = d.reshape(mb_h, 16, mb_w, 16).transpose(0, 2, 1, 3)
        mc_var = dm.reshape(nmb, 256).var(1)
        intra_mask = mb_var < mc_var
    return adaptive_quantization(
        q, mb_mean, mb_var, mc_var, intra_mask, mb_w, mb_h,
        lumi_masking=lumi_masking, dark_masking=dark_masking,
        temporal_cplx_masking=temporal_cplx_masking,
        spatial_cplx_masking=spatial_cplx_masking,
        p_masking=p_masking, border_masking=border_masking,
        qmin=qmin, qmax=qmax)
