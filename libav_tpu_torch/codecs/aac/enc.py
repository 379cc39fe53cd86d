"""AAC-LC encoder (reference role: libavcodec's native aacenc; minimal
compliant subset for round-trip validation and transcode output).

Sine window shape, per-band scalefactors sized to keep quantized
magnitudes in range, ESC codebook (11) for all coded bands, SCE/CPE with
per-channel ICS, ADTS framing. Transient frames switch to
EIGHT_SHORT_SEQUENCE (one group of 8 windows) with the spec window-state
machine (ONLY_LONG -> LONG_START -> EIGHT_SHORT -> LONG_STOP), using one
frame of lookahead for the LONG_START decision (reference: aacenc
psy-based block switching).

Counterpart of `libav_tpu/codecs/aac/enc.py`, copied: each frame's long
block, or its eight short blocks, goes through the port's
`ops/fftmdct.mdct` (a float32 `torch.matmul`) on the encoder's device,
one upload and one download per frame where the JAX encoder calls its
XLA dot. TNS, LTP (with its host replica of the decoder's IMDCT,
`_ltp_compose`), PNS, intensity, pulses, SBR and PS run on the host, as
there. torch and XLA sum the float32 products in other orders, so a
coefficient at a quantiser step can flip (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.avutil.error import AVError, EINVAL
from libav_tpu_torch.avutil.frame import Frame, Packet, PKT_FLAG_KEY
from libav_tpu_torch.avutil.opt import Option
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs.api import Encoder, MediaType, register_codec
from libav_tpu_torch.codecs.aac import tables as T
from libav_tpu_torch.codecs.aac.dec import (EIGHT_SHORT, LONG_START, LONG_STOP,
                                       ONLY_LONG, SF_OFFSET, SCE, CPE, END)
from libav_tpu_torch.codecs.aac.tables_gen import (SCALEFACTOR_BITS,
                                             SCALEFACTOR_CODE,
                                             SPECTRAL_BITS, SPECTRAL_CODES)
from libav_tpu_torch.ops import fftmdct as F
from libav_tpu_torch.ops.fftmdct import mdct


@register_codec
class AACEncoder(Encoder):
    NAME = "aac"
    TYPE = MediaType.AUDIO
    LONG_NAME = "AAC-LC (PyTorch device MDCT)"
    DEVICE_PART = True

    OPTIONS = Encoder.OPTIONS + [
        Option("quality", "quantizer quality 1 (best) - 10", "int", 3, 1, 10),
        Option("tns", "temporal noise shaping on long windows", "int",
               0, 0, 1),
        Option("pns", "perceptual noise substitution on the upper bands "
               "(long windows)", "int", 0, 0, 1),
        Option("sbr", "emit SBR (HE-AAC) extension data; 1..5 selects a "
               "stress profile (grid class/coupling/limiter variations)",
               "int", 0, 0, 5),
        Option("ps", "emit parametric stereo data in the SBR extension "
               "(HE-AACv2, mono core); 1=20-band HA, 2=fine-quant HB, "
               "3=34-band + IPD/OPD", "int", 0, 0, 3),
        Option("intensity", "intensity stereo on the upper half of the "
               "bands (stereo, long windows)", "int", 0, 0, 1),
        Option("pulse", "emit pulse_data escapes (long windows)", "int",
               0, 0, 1),
        Option("ltp", "long term prediction (AOT 4): code long-window "
               "residuals against the lagged output history", "int",
               0, 0, 1),
    ]

    FRAME_SAMPLES = 1024

    def __init__(self, params=None, options=None, *, device="cuda"):
        """AACEncoder(params, options, device=...): the MDCT runs on
        `device`."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        if self.sample_rate not in T.SAMPLE_RATES:
            raise AVError(EINVAL, f"aac: unsupported rate {self.sample_rate}")
        if self.channels not in (1, 2):
            raise AVError(EINVAL, "aac encoder: mono/stereo only (round 1)")
        self.sr_index = T.SAMPLE_RATES.index(self.sample_rate)
        self.offsets = T.swb_offsets_long(self.sample_rate)
        self.max_sfb = len(self.offsets) - 1
        self.short_offsets = T.swb_offsets_short(self.sample_rate)
        self.max_sfb_short = len(self.short_offsets) - 1
        self._buf = np.zeros((self.channels, 0), dtype=np.float64)
        self._prev = np.zeros((self.channels, 1024), dtype=np.float64)
        self._chunks = []        # lookahead queue for block switching
        self._prev_short = False
        self._pts = 0
        self._sbr_frame = 0
        self._sbr_bands = None
        if getattr(self, "ltp", 0):
            if self.tns or self.sbr or self.pns or \
                    getattr(self, "intensity", 0):
                raise AVError(EINVAL,
                              "aac: -ltp combines only with plain LC "
                              "coding tools")
            # decoder replica for the prediction state (open loop: the
            # unquantized spectrum stands in for the dequantized one;
            # the mismatch only shaves prediction gain, decode parity
            # is unaffected because the decoder adds ITS own pred)
            self._ltp_st = np.zeros((self.channels, 3072))
            self._ltp_overlap = np.zeros((self.channels, 1024))
            self._ltp_prev_shape = [0] * self.channels

    # ------------------------------------------------------------------ #

    def _encode(self, frame: Frame) -> List[Packet]:
        from libav_tpu_torch.codecs.ac3.enc import AC3Encoder
        x = AC3Encoder._to_planar(self, frame)
        self._buf = np.concatenate([self._buf, x], axis=1)
        while self._buf.shape[1] >= self.FRAME_SAMPLES:
            self._chunks.append(self._buf[:, :self.FRAME_SAMPLES])
            self._buf = self._buf[:, self.FRAME_SAMPLES:]
        pkts = []
        # keep one chunk of lookahead for the LONG_START decision
        while len(self._chunks) >= 2:
            pkts.append(self._emit(self._chunks.pop(0), self._chunks[0],
                                   frame))
        return pkts

    def _drain(self) -> List[Packet]:
        if self._buf.shape[1]:
            pad = self.FRAME_SAMPLES - self._buf.shape[1]
            self._chunks.append(np.pad(self._buf, ((0, 0), (0, pad))))
            self._buf = self._buf[:, :0]
        pkts = []
        while self._chunks:
            nxt = self._chunks[1] if len(self._chunks) > 1 else None
            pkts.append(self._emit(self._chunks.pop(0), nxt, None))
        return pkts

    @staticmethod
    def _is_transient(chunk: np.ndarray) -> bool:
        """Attack detector: a 128-sample sub-block much louder than the
        running average of the preceding ones."""
        e = (chunk ** 2).reshape(chunk.shape[0], 8, 128).sum(axis=2)
        e = e.max(axis=0)                      # loudest channel
        run = e[0] + 1e-9
        for i in range(1, 8):
            if e[i] > 8.0 * run / i and e[i] > 1e-4:
                return True
            run += e[i]
        return False

    def _emit(self, chunk, next_chunk, src) -> Packet:
        short_cur = self._is_transient(chunk)
        short_next = next_chunk is not None and \
            self._is_transient(next_chunk)
        if short_cur:
            seq = EIGHT_SHORT
        elif short_next:
            seq = LONG_START
        elif self._prev_short:
            seq = LONG_STOP
        else:
            seq = ONLY_LONG
        self._prev_short = short_cur
        return self._encode_frame(chunk, src, seq)

    # ------------------------------------------------------------------ #

    def _window_for(self, seq: int) -> np.ndarray:
        lw = F.sine_window(2048)
        sw = F.sine_window(256)
        if seq == ONLY_LONG:
            return lw
        if seq == LONG_START:
            return np.concatenate([lw[:1024], np.ones(448), sw[128:],
                                   np.zeros(448)])
        if seq == LONG_STOP:
            return np.concatenate([np.zeros(448), sw[:128], np.ones(448),
                                   lw[1024:]])
        raise AVError(EINVAL, "no composite window for EIGHT_SHORT")

    def _encode_frame(self, pcm: np.ndarray, src,
                      seq: int = ONLY_LONG) -> Packet:
        nch = self.channels
        comp = np.concatenate([self._prev, pcm], axis=1)
        self._prev = pcm.copy()
        if seq == EIGHT_SHORT:
            sw = F.sine_window(256)
            # 8 short transforms at offsets 448 + 128*i of the composite
            segs = np.stack([comp[:, 448 + 128 * i:448 + 128 * i + 256]
                             for i in range(8)], axis=1) * sw
            spec = self._mdct(segs.reshape(nch * 8, 256)
                              ).reshape(nch, 8, 128) * \
                (2.0 / 2048.0 * 67108864.0)  # same scale as long blocks
        else:
            blocks = comp * self._window_for(seq)
            spec = self._mdct(blocks) * \
                (2.0 / 2048.0 * 67108864.0)  # 2^26: see dec.py gain note

        if self.tns and seq != EIGHT_SHORT:
            # forward (all-zero) TNS filter per channel before M/S —
            # the decoder applies the inverse after M/S (spec 4.6.9
            # tool order); fixed order-2 reflection coefs, indices 2/7
            # of the 3-bit table
            from libav_tpu_torch.codecs.aac.dec import _apply_tns
            info = dict(offsets=self.offsets, max_sfb=self.max_sfb)
            tns = [[(len(self.offsets) - 1, 2, 0, 0, 0, [2, 7])]]
            for c in range(nch):
                _apply_tns(spec[c], tns, info, self.sample_rate,
                           decode=False)

        ltp_params = [None] * nch
        orig_spec = None
        if getattr(self, "ltp", 0):
            orig_spec = spec.copy()
            if seq != EIGHT_SHORT:
                from libav_tpu_torch.codecs.aac.dec import (ltp_predict,
                                                      LTP_COEF,
                                                      MAX_LTP_LONG_SFB)
                lag = 1024
                nb = min(self.max_sfb, MAX_LTP_LONG_SFB)
                lim = int(self.offsets[nb])
                for c in range(nch):
                    base = ltp_predict(self._ltp_st[c], (lag, 1.0, ()),
                                       seq, 0, self._ltp_prev_shape[c])
                    ci = min(range(len(LTP_COEF)), key=lambda i: float(
                        ((spec[c][:lim] - LTP_COEF[i] * base[:lim]) ** 2)
                        .sum()))
                    pred = LTP_COEF[ci] * base
                    used = []
                    for g in range(nb):
                        a, e0 = int(self.offsets[g]), \
                            int(self.offsets[g + 1])
                        ores = float((spec[c][a:e0] ** 2).sum())
                        rres = float(((spec[c][a:e0] -
                                       pred[a:e0]) ** 2).sum())
                        used.append(1 if rres < ores else 0)
                        if used[-1]:
                            spec[c][a:e0] -= pred[a:e0]
                    if any(used):
                        ltp_params[c] = (lag, ci, used)
                if nch == 2 and ltp_params[0] is None and \
                        ltp_params[1] is not None:
                    # the reference decoder skips ch1 LTP when ch0 has
                    # no predictor data (aacdec.c:2668): add the pred
                    # back rather than emit data it would ignore
                    c1 = ltp_params[1]
                    pred = LTP_COEF[c1[1]] * ltp_predict(
                        self._ltp_st[1], (c1[0], 1.0, ()), seq, 0,
                        self._ltp_prev_shape[1])
                    for g, u in enumerate(c1[2]):
                        if u:
                            a, e0 = int(self.offsets[g]), \
                                int(self.offsets[g + 1])
                            spec[1][a:e0] += pred[a:e0]
                    ltp_params[1] = None

        pb = PutBits()
        if nch == 1:
            pb.put_bits(3, SCE)
            pb.put_bits(4, 0)
            self._encode_ics(pb, spec[0], seq, ltp=ltp_params[0])
        elif getattr(self, "ltp", 0):
            # per-channel ics_info carries each channel's own LTP:
            # plain non-common CPE
            pb.put_bits(3, CPE)
            pb.put_bits(4, 0)
            pb.put_bits(1, 0)        # common_window = 0
            self._encode_ics(pb, spec[0], seq, ltp=ltp_params[0])
            self._encode_ics(pb, spec[1], seq, ltp=ltp_params[1])
        else:
            pb.put_bits(3, CPE)
            pb.put_bits(4, 0)
            mid = (spec[0] + spec[1]) * 0.5
            side = (spec[0] - spec[1]) * 0.5
            use_ms = float((side ** 2).sum()) < \
                0.25 * float((mid ** 2).sum()) + 1e-12
            if self.pns:
                use_ms = False       # M/S never covers noise bands
            if self.intensity and seq != EIGHT_SHORT:
                # intensity stereo: common window, ms_present=0, the
                # right channel's upper bands coded INTENSITY_HCB(2)
                # with dpcm positions (decoder rebuilds R = c*2^-p/4*L)
                pb.put_bits(1, 1)
                self._write_ics_info(pb, seq)
                pb.put_bits(2, 0)    # ms_present: none
                self._encode_ics(pb, spec[0], seq, write_info=False)
                self._encode_ics(pb, spec[1], seq, write_info=False,
                                 intensity_from=spec[0])
            elif use_ms:
                # common_window CPE with all-bands mid/side
                # (reference: aacenc; decoder reconstructs l=m+s, r=m-s)
                pb.put_bits(1, 1)
                self._write_ics_info(pb, seq)
                pb.put_bits(2, 2)    # ms_present: all bands
                self._encode_ics(pb, mid, seq, write_info=False)
                self._encode_ics(pb, side, seq, write_info=False)
            else:
                pb.put_bits(1, 0)    # common_window = 0
                self._encode_ics(pb, spec[0], seq)
                self._encode_ics(pb, spec[1], seq)
        if getattr(self, "ltp", 0):
            from libav_tpu_torch.codecs.aac.dec import ltp_update
            for c in range(nch):
                comp = self._ltp_compose(seq, self._ltp_prev_shape[c],
                                         orig_spec[c])
                out = self._ltp_overlap[c] + comp[:1024]
                self._ltp_overlap[c] = comp[1024:]
                self._ltp_st[c] = ltp_update(self._ltp_st[c], out,
                                             self._ltp_overlap[c])
                self._ltp_prev_shape[c] = 0
        if self.sbr:
            self._write_sbr_fil(pb)
        pb.put_bits(3, END)
        pb.align(0)
        body = pb.flush()

        data = self._adts(body)
        pkt = Packet(data=data, pts=self._pts, dts=self._pts,
                     duration=self.FRAME_SAMPLES, flags=PKT_FLAG_KEY)
        if src is not None:
            pkt.time_base = src.time_base
        self._pts += self.FRAME_SAMPLES
        return pkt

    def _mdct(self, blocks: np.ndarray) -> np.ndarray:
        """float64 (B, 2N) windowed blocks -> float64 (B, N) spectra:
        `fftmdct.mdct` in float32 on the encoder's device, downloaded."""
        x = torch.from_numpy(blocks.astype(np.float32)).to(self.device)
        return mdct(x).cpu().numpy().astype(np.float64)

    def _ltp_compose(self, seq: int, prev_shape: int,
                     spec: np.ndarray) -> np.ndarray:
        """Host mirror of the decoder's windowed full-2048 IMDCT
        composition (dec._imdct_channel) for the LTP state replica;
        our bitstreams always use sine shape."""
        sw = F.sine_window(256)
        lwf = F.sine_window(2048)
        comp = np.zeros(2048)
        if seq == EIGHT_SHORT:
            frames = F.imdct_ref(spec * 1024.0)
            for i in range(8):
                comp[448 + 128 * i:448 + 128 * i + 256] += frames[i] * sw
        else:
            frame = F.imdct_ref(spec[None, :] * 1024.0)[0]
            if seq == LONG_STOP:
                left = np.concatenate([np.zeros(448), sw[:128],
                                       np.ones(448)])
            else:
                left = lwf[:1024]
            if seq == LONG_START:
                right = np.concatenate([np.ones(448), sw[128:],
                                        np.zeros(448)])
            else:
                right = lwf[1024:]
            comp = frame * np.concatenate([left, right])
        return comp

    def _adts(self, body: bytes) -> bytes:
        pb = PutBits()
        frame_len = len(body) + 7
        pb.put_bits(12, 0xFFF)
        pb.put_bits(1, 1)            # MPEG-2 id (plays everywhere)
        pb.put_bits(2, 0)            # layer
        pb.put_bits(1, 1)            # protection absent
        pb.put_bits(2, 3 if getattr(self, "ltp", 0) else 1)  # profile
        pb.put_bits(4, self.sr_index)
        pb.put_bits(1, 0)
        pb.put_bits(3, self.channels)
        pb.put_bits(4, 0)
        pb.put_bits(13, frame_len)
        pb.put_bits(11, 0x7FF)
        pb.put_bits(2, 0)
        return pb.flush() + body

    # -- SBR stress emission ------------------------------------------- #
    # Legal-syntax SBR payloads for conformance-stream generation: the
    # envelope/noise values are synthetic; validity is cross-checked by
    # decoding with both our decoder and the reference (aacsbr.c) and
    # comparing PCM (tests/test_fate_cross.py).  Profiles cover the grid
    # classes, delta-time/freq coding, invf modes, add_harmonic,
    # limiter/interpolation/smoothing header variants and CPE coupling.

    # (amp_res, start, stop, xover, extra1=(fscale,alter,noise_bands),
    #  extra2=(lim_bands, lim_gains, interpol, smooth), grid)
    _SBR_PROFILES = {
        1: (0, 4, 7, 2, None, None, "fixfix1"),
        2: (1, 6, 7, 1, (1, 0, 2), None, "fixfix4"),
        3: (0, 5, 6, 0, (3, 1, 3), (2, 2, 0, 0), "varvar"),
        4: (1, 3, 7, 2, (0, 1, 1), (3, 0, 1, 1), "fixvar"),
        5: (0, 4, 7, 1, None, (1, 1, 1, 0), "fixfix2"),
    }

    def _sbr_put_huff(self, pb, name, delta):
        from libav_tpu_torch.codecs.aac import sbr_tables as ST
        bits, codes = ST.HUFFMAN[name]
        sym = delta + ST.LAV[name]
        pb.put_bits(bits[sym], codes[sym])

    def _sbr_band_counts(self):
        """Build the decoder's band tables once to know n[0], n[1], n_q."""
        if self._sbr_bands is None:
            from libav_tpu_torch.codecs.aac.sbr import SBRContext
            amp, start, stop, xover, e1, e2, grid = \
                self._SBR_PROFILES[self.sbr]
            ctx = SBRContext()
            ctx.sample_rate = 2 * self.sample_rate
            ctx.spectrum_params = (start, stop, xover) + (e1 or (2, 1, 2))
            ctx._make_f_master()
            ctx._make_f_derived()
            self._sbr_bands = (ctx.n[0], ctx.n[1], ctx.n_q)
        return self._sbr_bands

    def _write_sbr_fil(self, pb: PutBits):
        amp, start, stop, xover, e1, e2, grid = self._SBR_PROFILES[self.sbr]
        n0, n1, n_q = self._sbr_band_counts()
        fi = self._sbr_frame
        self._sbr_frame += 1
        coupling = self.channels == 2 and self.sbr == 5

        spb = PutBits()
        # -- sbr header (every frame; reset only fires on frame 0)
        spb.put_bits(1, 1)               # bs_header_flag
        spb.put_bits(1, amp)
        spb.put_bits(4, start)
        spb.put_bits(4, stop)
        spb.put_bits(3, xover)
        spb.put_bits(2, 0)               # reserved
        spb.put_bits(1, e1 is not None)
        spb.put_bits(1, e2 is not None)
        if e1 is not None:
            spb.put_bits(2, e1[0])
            spb.put_bits(1, e1[1])
            spb.put_bits(2, e1[2])
        if e2 is not None:
            spb.put_bits(2, e2[0])
            spb.put_bits(2, e2[1])
            spb.put_bits(1, e2[2])
            spb.put_bits(1, e2[3])

        # -- grid
        def put_grid():
            if grid == "fixfix1":
                spb.put_bits(2, 0)
                spb.put_bits(2, 0)
                spb.put_bits(1, 1)
                return 1, [1, 1]
            if grid == "fixfix2":
                spb.put_bits(2, 0)
                spb.put_bits(2, 1)
                spb.put_bits(1, 1)
                return 2, [1, 1, 1]
            if grid == "fixfix4":
                spb.put_bits(2, 0)
                spb.put_bits(2, 2)
                spb.put_bits(1, 1)
                return 4, [1, 1, 1, 1, 1]
            if grid == "fixvar":
                spb.put_bits(2, 1)
                spb.put_bits(2, 2)       # abs_bord_trail = 18
                spb.put_bits(2, 1)       # num_rel_trail -> num_env = 2
                spb.put_bits(2, 1)       # border at 18 - 2*1 - 2 = 14
                spb.put_bits(2, 1)       # bs_pointer
                fr = [None, 0, 1]        # read reversed: env2 then env1
                spb.put_bits(1, fr[2])
                spb.put_bits(1, fr[1])
                return 2, fr
            # varvar: t_env = [0, 2, 15, 17], 3 envelopes
            spb.put_bits(2, 3)
            spb.put_bits(2, 0)           # bs_var_bord_0
            spb.put_bits(2, 1)           # bs_var_bord_1 -> trail 17
            spb.put_bits(2, 1)           # num_rel_0
            spb.put_bits(2, 1)           # num_rel_1
            spb.put_bits(2, 0)           # lead rel border -> t1 = 2
            spb.put_bits(2, 0)           # trail rel border -> t2 = 15
            spb.put_bits(2, 0)           # bs_pointer
            for b in (1, 0, 1):
                spb.put_bits(1, b)
            return 3, [None, 1, 0, 1]

        # amp_res is forced to 0 for single-envelope FIXFIX frames
        amp_eff = 0 if grid == "fixfix1" else amp

        def put_dtdf(num_env, num_noise):
            dfe = [0] * num_env
            dfn = [0] * num_noise
            if fi > 0 and fi % 2:
                dfe[0] = 1
                dfn[0] = 1
            for b in dfe:
                spb.put_bits(1, b)
            for b in dfn:
                spb.put_bits(1, b)
            return dfe, dfn

        def put_invf():
            for i in range(n_q):
                spb.put_bits(2, (i + fi) % 4)

        def put_env(num_env, fr, dfe, ch_bal):
            if ch_bal:
                t = "t_huffman_env_bal_3_0dB" if amp_eff else \
                    "t_huffman_env_bal_1_5dB"
                f = "f_huffman_env_bal_3_0dB" if amp_eff else \
                    "f_huffman_env_bal_1_5dB"
                bits = 5 if amp_eff else 6
                base = 12
                fdel = (0, 1, -1)
            else:
                t = "t_huffman_env_3_0dB" if amp_eff else \
                    "t_huffman_env_1_5dB"
                f = "f_huffman_env_3_0dB" if amp_eff else \
                    "f_huffman_env_1_5dB"
                bits = 6 if amp_eff else 7
                base = (26 if amp_eff else 52) + 2 * (fi % 3)
                fdel = (0, 1, -1, 2, -2)
            for e in range(num_env):
                nb = n1 if fr[e + 1] else n0
                if dfe[e]:
                    for j in range(nb):
                        self._sbr_put_huff(spb, t, (1, -1, 0)[j % 3])
                else:
                    spb.put_bits(bits, base + e)
                    for j in range(1, nb):
                        self._sbr_put_huff(spb, f, fdel[j % len(fdel)])

        def put_noise(num_noise, dfn, ch_bal):
            if ch_bal:
                t, f = "t_huffman_noise_bal_3_0dB", "f_huffman_env_bal_3_0dB"
                base = 6
            else:
                t, f = "t_huffman_noise_3_0dB", "f_huffman_env_3_0dB"
                base = 10 + fi % 4
            for i in range(num_noise):
                if dfn[i]:
                    for j in range(n_q):
                        self._sbr_put_huff(spb, t, (1, -1)[j % 2])
                else:
                    spb.put_bits(5, base)
                    for j in range(1, n_q):
                        self._sbr_put_huff(spb, f, (1, -1)[j % 2])

        def put_add_harmonic():
            if self.sbr == 2:
                spb.put_bits(1, 1)
                for i in range(n1):
                    spb.put_bits(1, int(i % 4 == 0))
            else:
                spb.put_bits(1, 0)

        if self.channels == 1:
            spb.put_bits(1, 0)           # bs_data_extra
            num_env, fr = put_grid()
            num_noise = 2 if num_env > 1 else 1
            dfe, dfn = put_dtdf(num_env, num_noise)
            put_invf()
            put_env(num_env, fr, dfe, False)
            put_noise(num_noise, dfn, False)
            put_add_harmonic()
        else:
            spb.put_bits(1, 0)           # bs_data_extra
            spb.put_bits(1, int(coupling))
            if coupling:
                num_env, fr = put_grid()
                num_noise = 2 if num_env > 1 else 1
                dfe0, dfn0 = put_dtdf(num_env, num_noise)
                dfe1, dfn1 = put_dtdf(num_env, num_noise)
                put_invf()
                put_env(num_env, fr, dfe0, False)
                put_noise(num_noise, dfn0, False)
                put_env(num_env, fr, dfe1, True)
                put_noise(num_noise, dfn1, True)
            else:
                num_env, fr = put_grid()
                _, fr2 = put_grid()
                num_noise = 2 if num_env > 1 else 1
                dfe0, dfn0 = put_dtdf(num_env, num_noise)
                dfe1, dfn1 = put_dtdf(num_env, num_noise)
                put_invf()
                put_invf()
                put_env(num_env, fr, dfe0, False)
                put_env(num_env, fr2, dfe1, False)
                put_noise(num_noise, dfn0, False)
                put_noise(num_noise, dfn1, False)
            put_add_harmonic()
            put_add_harmonic()
        if self.ps and self.channels == 1:
            psb = PutBits()
            self._write_ps(psb)
            ps_bits = psb.bits_written()
            ext_bytes = (2 + ps_bits + 7) // 8
            spb.put_bits(1, 1)           # bs_extended_data
            if ext_bytes >= 15:
                spb.put_bits(4, 15)
                spb.put_bits(8, ext_bytes - 15)
            else:
                spb.put_bits(4, ext_bytes)
            spb.put_bits(2, 2)           # EXTENSION_ID_PS
            pdata = psb.flush()
            full, rem = divmod(ps_bits, 8)
            for byte in pdata[:full]:
                spb.put_bits(8, byte)
            if rem:
                spb.put_bits(rem, pdata[full] >> (8 - rem))
            pad = ext_bytes * 8 - 2 - ps_bits
            if pad:
                spb.put_bits(pad, 0)     # bs_fill_bits
        else:
            spb.put_bits(1, 0)           # bs_extended_data

        nbits = spb.bits_written()
        total = 4 + nbits                # + bs_extension_type
        cnt = (total + 7) // 8
        pb.put_bits(3, 6)                # FIL
        if cnt >= 15:
            pb.put_bits(4, 15)
            pb.put_bits(8, cnt - 14)
        else:
            pb.put_bits(4, cnt)
        pb.put_bits(4, 13)               # EXT_SBR_DATA
        pad = cnt * 8 - total            # bs_fill_bits
        if pad:
            spb.put_bits(pad, 0)
        nb = cnt * 8 - 4                 # payload bits after the ext type
        payload = spb.flush()
        full, rem = divmod(nb, 8)
        for byte in payload[:full]:
            pb.put_bits(8, byte)
        if rem:
            pb.put_bits(rem, payload[full] >> (8 - rem))

    def _write_ps(self, pb: PutBits):
        """Parametric stereo payload (ISO 14496-3 8.4.2.2 ps_data;
        decoded by aacps.c ff_ps_read_data): fixed-grid single envelope
        with df/dt-alternating IID+ICC, optional IPD/OPD."""
        from libav_tpu_torch.codecs.aac import ps_tables as PT
        fi = getattr(self, "_ps_frame", 0)
        self._ps_frame = fi + 1
        prof = self.ps
        iid_mode = {1: 1, 2: 4, 3: 2}[prof]
        icc_mode = {1: 1, 2: 4, 3: 2}[prof]
        npar = (10, 20, 34, 10, 20, 34)[iid_mode]
        nipd = (5, 11, 17, 5, 11, 17)[iid_mode]
        quant = int(iid_mode > 2)

        def huff(name, sym):
            bits, codes = PT.HUFFMAN[name]
            pb.put_bits(bits[sym], codes[sym])

        pb.put_bits(1, 1)                # enable_ps_header
        pb.put_bits(1, 1)                # enable_iid
        pb.put_bits(3, iid_mode)
        pb.put_bits(1, 1)                # enable_icc
        pb.put_bits(3, icc_mode)
        pb.put_bits(1, int(prof == 3))   # enable_ext
        pb.put_bits(1, 0)                # frame_class = fixed
        pb.put_bits(2, 1)                # num_env = 1
        iid = [((b + fi) % 9) - 4 for b in range(npar)]
        icc = [(b + fi) % 6 for b in range(npar)]
        dt = 1 if (fi % 2 and fi > 0) else 0
        # IID envelope
        pb.put_bits(1, dt)
        tname = ("huff_iid_df0", "huff_iid_df1",
                 "huff_iid_dt0", "huff_iid_dt1")[2 * dt + quant]
        off = PT.HUFF_OFFSET[tname]
        if dt:
            # repeat previous values: all deltas 0
            for b in range(npar):
                huff(tname, off)
        else:
            prev = 0
            for b in range(npar):
                huff(tname, iid[b] - prev + off)
                prev = iid[b]
        # ICC envelope
        pb.put_bits(1, dt)
        tname = "huff_icc_dt" if dt else "huff_icc_df"
        off = PT.HUFF_OFFSET[tname]
        if dt:
            for b in range(npar):
                huff(tname, off)
        else:
            prev = 0
            for b in range(npar):
                huff(tname, icc[b] - prev + off)
                prev = icc[b]
        if prof == 3:
            epb = PutBits()
            epb.put_bits(1, 1)           # enable_ipdopd
            for _ in range(1):           # num_env
                epb.put_bits(1, 0)       # ipd dt
                prev = 0
                for b in range(nipd):
                    v = (b + fi) % 8
                    d = (v - prev) & 0x07
                    # df table symbol = delta (masked); offsets are 0
                    epb.put_bits(PT.HUFFMAN["huff_ipd_df"][0][d],
                                 PT.HUFFMAN["huff_ipd_df"][1][d])
                    prev = v
                epb.put_bits(1, 0)       # opd dt
                prev = 0
                for b in range(nipd):
                    v = (7 - b + fi) % 8
                    d = (v - prev) & 0x07
                    epb.put_bits(PT.HUFFMAN["huff_opd_df"][0][d],
                                 PT.HUFFMAN["huff_opd_df"][1][d])
                    prev = v
            epb.put_bits(1, 0)           # reserved_ps
            ebits = epb.bits_written()
            ext_bytes = (2 + ebits + 7) // 8
            pb.put_bits(4, ext_bytes)    # bs_extension_size (< 15)
            pb.put_bits(2, 0)            # ps_extension_id 0
            edata = epb.flush()
            full, rem = divmod(ebits, 8)
            for byte in edata[:full]:
                pb.put_bits(8, byte)
            if rem:
                pb.put_bits(rem, edata[full] >> (8 - rem))
            pad = ext_bytes * 8 - 2 - ebits
            if pad:
                pb.put_bits(pad, 0)

    # ------------------------------------------------------------------ #

    def _write_ics_info(self, pb: PutBits, seq: int, ltp=None):
        pb.put_bits(1, 0)            # reserved
        pb.put_bits(2, seq)
        pb.put_bits(1, 0)            # window_shape: sine
        if seq == EIGHT_SHORT:
            pb.put_bits(4, self.max_sfb_short)
            pb.put_bits(7, 0x7F)     # grouping: one group of 8 windows
        else:
            pb.put_bits(6, self.max_sfb)
            if ltp is not None:      # predictor_data_present + ltp_data
                lag, ci, used = ltp
                pb.put_bits(1, 1)
                pb.put_bits(1, 1)    # ltp_data_present
                pb.put_bits(11, lag)
                pb.put_bits(3, ci)
                for u in used:
                    pb.put_bits(1, u)
            else:
                pb.put_bits(1, 0)    # predictor_data_present

    def _encode_ics(self, pb: PutBits, spec: np.ndarray,
                    seq: int = ONLY_LONG, write_info: bool = True,
                    intensity_from: np.ndarray = None, ltp=None):
        if seq == EIGHT_SHORT:
            # one group of all 8 windows: band g covers the same sfb of
            # every window, stored window-major (group layout)
            offsets8 = self.short_offsets
            max_sfb = self.max_sfb_short
            bands = [np.concatenate([spec[w, offsets8[g]:offsets8[g + 1]]
                                     for w in range(8)])
                     for g in range(max_sfb)]
            sect_bits, sect_esc = 3, 7
        else:
            offsets = self.offsets
            max_sfb = self.max_sfb
            bands = [spec[offsets[g]:offsets[g + 1]]
                     for g in range(max_sfb)]
            sect_bits, sect_esc = 5, 31
        # per-band scalefactor: amplitude such that quantized magnitudes
        # stay modest; quality scales the step
        band_cb = np.zeros(max_sfb, dtype=np.int32)
        sf = np.zeros(max_sfb, dtype=np.int32)
        bandq: list = [None] * max_sfb
        qual_shift = self.quality
        for g in range(max_sfb):
            band = bands[g]
            amax = np.abs(band).max()
            if amax < 1e-7:
                continue
            # choose sf so that max quantized magnitude ~ 40 >> quality
            target = max(40 >> (qual_shift // 3), 4)
            # |q| = |x * 2^(-0.25(sf-off))|^(3/4) -> solve for sf
            sf_f = SF_OFFSET + 4 * np.log2(amax / (target ** (4.0 / 3.0)))
            sf[g] = int(np.clip(np.ceil(sf_f), SF_OFFSET - 100,
                                SF_OFFSET + 155))
            gain = 2.0 ** (-0.25 * (sf[g] - SF_OFFSET))
            q = np.sign(band) * np.floor(
                np.abs(band * gain) ** 0.75 + 0.4054)
            q = np.clip(q, -8191, 8191)
            if np.any(q):
                band_cb[g] = T.ESC_HCB
                bandq[g] = q.astype(np.int64)

        is_pos = np.zeros(max_sfb, dtype=np.int32)
        if intensity_from is not None and seq != EIGHT_SHORT:
            # intensity stereo on the upper half: position quantizes the
            # level ratio vs the left channel; the codebook (15 / 14)
            # carries the correlation sign (in / out of phase)
            offs = self.offsets
            for g in range(max_sfb // 2, max_sfb):
                L = intensity_from[offs[g]:offs[g + 1]].astype(np.float64)
                R = bands[g].astype(np.float64)
                e0 = float((L ** 2).sum())
                e1 = float((R ** 2).sum())
                if e0 < 1e-12:
                    continue
                corr = float((L * R).sum())
                scale = np.sqrt(e1 / e0)
                pos = int(np.clip(round(-4 * np.log2(max(scale, 2.0 ** -38))),
                                  -155, 100))
                band_cb[g] = T.INTENSITY_HCB if corr >= 0 \
                    else T.INTENSITY_HCB2
                is_pos[g] = pos
                bandq[g] = None

        noise_sf = np.zeros(max_sfb, dtype=np.int32)
        if self.pns and seq != EIGHT_SHORT:
            # PNS: replace the upper bands with noise at the band's own
            # L2 energy (decoder normalizes the LCG fill to this)
            for g in range(max_sfb * 5 // 8, max_sfb):
                l2 = float(np.sqrt((bands[g].astype(np.float64) ** 2)
                                   .sum()))
                if l2 < 1e-7:
                    continue
                band_cb[g] = T.NOISE_HCB
                bandq[g] = None
                noise_sf[g] = int(np.clip(round(4 * np.log2(l2)),
                                          -100, 155))

        # scalefactor deltas are limited to +-60 by the dpcm codebook:
        # clamp the chain and re-quantize clamped bands (LTP residuals
        # especially can swing band energies by orders of magnitude)
        prev_sf = None
        for g in range(max_sfb):
            if bandq[g] is None or band_cb[g] in (0, T.NOISE_HCB) or \
                    band_cb[g] >= T.INTENSITY_HCB2:
                continue
            if prev_sf is not None and abs(int(sf[g]) - prev_sf) > 60:
                sf[g] = prev_sf + max(-60, min(60, int(sf[g]) - prev_sf))
                gain = 2.0 ** (-0.25 * (sf[g] - SF_OFFSET))
                q = np.sign(bands[g]) * np.floor(
                    np.abs(bands[g] * gain) ** 0.75 + 0.4054)
                q = np.clip(q, -8191, 8191)
                if np.any(q):
                    bandq[g] = q.astype(np.int64)
                else:
                    band_cb[g] = 0
                    bandq[g] = None
                    continue
            prev_sf = int(sf[g])

        # global_gain = first used sf (or offset)
        used = np.where((band_cb != 0) & (band_cb != T.NOISE_HCB) &
                        (band_cb < T.INTENSITY_HCB2))[0]
        global_gain = int(sf[used[0]]) if len(used) else SF_OFFSET
        pb.put_bits(8, global_gain)

        # ics_info
        if write_info:
            self._write_ics_info(pb, seq, ltp)

        # section_data: runs of equal codebook
        g = 0
        while g < max_sfb:
            cb = band_cb[g]
            run = 1
            while g + run < max_sfb and band_cb[g + run] == cb:
                run += 1
            pb.put_bits(4, int(cb))
            r = run
            while r >= sect_esc:
                pb.put_bits(sect_bits, sect_esc)
                r -= sect_esc
            pb.put_bits(sect_bits, r)
            g += run

        # scale_factor_data (dpcm vs previous coded band; noise bands
        # run on their own offset chain, first delta as 9-bit PCM)
        prev = global_gain
        prev_noise = global_gain - 90
        prev_is = 0
        noise_first = True
        for g in range(max_sfb):
            if band_cb[g] == 0:
                continue
            if band_cb[g] >= T.INTENSITY_HCB2:
                d = int(is_pos[g]) - prev_is + 60
                if not (0 <= d < 121):
                    raise AVError(EINVAL, "intensity delta out of range")
                pb.put_bits(SCALEFACTOR_BITS[d], SCALEFACTOR_CODE[d])
                prev_is = int(is_pos[g])
                continue
            if band_cb[g] == T.NOISE_HCB:
                d = int(noise_sf[g]) - prev_noise
                if noise_first:
                    noise_first = False
                    if not (-256 <= d < 256):
                        raise AVError(EINVAL, "noise PCM delta range")
                    pb.put_bits(9, d + 256)
                else:
                    if not (0 <= d + 60 < 121):
                        raise AVError(EINVAL, "noise delta range")
                    pb.put_bits(SCALEFACTOR_BITS[d + 60],
                                SCALEFACTOR_CODE[d + 60])
                prev_noise = int(noise_sf[g])
                continue
            d = int(sf[g]) - prev + 60
            if not (0 <= d < 121):
                raise AVError(EINVAL, "scalefactor delta out of range")
            pb.put_bits(SCALEFACTOR_BITS[d], SCALEFACTOR_CODE[d])
            prev = int(sf[g])

        # pulse_data: move part of one coefficient's magnitude into a
        # pulse escape (decoder adds amp back in the quantized domain —
        # spec table 4.7; exercises aacdec.c decode_pulses)
        pulse_hit = None
        if self.pulse and seq != EIGHT_SHORT:
            offs = self.offsets
            for g in range(max_sfb):
                if bandq[g] is None or band_cb[g] in (0, T.NOISE_HCB):
                    continue
                q = bandq[g]
                w = min(len(q), 32)          # 5-bit offset from band base
                k = int(np.argmax(np.abs(q[:w])))
                if abs(int(q[k])) >= 3:
                    amp = min(15, abs(int(q[k])) - 1)
                    q[k] -= amp if q[k] > 0 else -amp
                    pulse_hit = (g, int(offs[g]) + k, amp)
                    break
        if pulse_hit is not None:
            g, pos, amp = pulse_hit
            pb.put_bits(1, 1)
            pb.put_bits(2, 0)        # num_pulse - 1 = 0
            pb.put_bits(6, g)        # pulse_start_sfb
            pb.put_bits(5, pos - int(self.offsets[g]))
            pb.put_bits(4, amp)
        else:
            pb.put_bits(1, 0)        # pulse
        if self.tns and seq != EIGHT_SHORT:
            pb.put_bits(1, 1)        # tns_data_present
            pb.put_bits(2, 1)        # n_filt
            pb.put_bits(1, 0)        # coef_res (3-bit coefs)
            pb.put_bits(6, self.max_sfb)      # length: all bands
            pb.put_bits(5, 2)        # order
            pb.put_bits(1, 0)        # direction
            pb.put_bits(1, 0)        # coef_compress
            pb.put_bits(3, 2)
            pb.put_bits(3, 7)
        else:
            pb.put_bits(1, 0)        # tns
        pb.put_bits(1, 0)            # gain control

        # spectral_data with ESC codebook (pairs)
        pack = T.pack_index(T.ESC_HCB)
        codes = SPECTRAL_CODES[T.ESC_HCB - 1]
        bits = SPECTRAL_BITS[T.ESC_HCB - 1]
        for g in range(max_sfb):
            if band_cb[g] in (0, T.NOISE_HCB) or \
                    band_cb[g] >= T.INTENSITY_HCB2:
                continue
            quant = bandq[g]
            for k in range(0, len(quant), 2):
                a, b = int(quant[k]), int(quant[k + 1])
                ia, ib = min(abs(a), 16), min(abs(b), 16)
                idx = pack(ia, ib)
                pb.put_bits(bits[idx], codes[idx])
                for v, iv in ((a, ia), (b, ib)):
                    if iv != 0:
                        pb.put_bits(1, 1 if v < 0 else 0)
                for v in (a, b):
                    if abs(v) >= 16:
                        mag = abs(v)
                        n = mag.bit_length() - 1
                        pb.put_bits(n - 4, (1 << (n - 4)) - 1)  # n-4 ones
                        pb.put_bits(1, 0)
                        pb.put_bits(n, mag - (1 << n))
