"""AAC Parametric Stereo decoder (HE-AAC v2; ISO/IEC 14496-3 8.6.4).

Reference behavior: libavcodec/aacps.c — ff_ps_read_data :151 (header,
envelopes, IID/ICC/IPD/OPD Huffman deltas), hybrid analysis/synthesis
filterbanks :288-415, decorrelation (transient detection + 3-link
allpass chain) :612, stereo processing (HA/HB mixing matrices with
per-slot interpolation) :737, ff_ps_apply :893 — and the aacpsdsp.c
kernels, replicated in vectorized numpy over the 32-slot frame.

Plugs into the SBR chain: the element's mono QMF matrix X (38x64
complex) is split into hybrid bands, a decorrelated copy is mixed per
IID/ICC parameter band, and both channels return through hybrid
synthesis — exactly ff_ps_apply's position before sbr_qmf_synthesis.
"""

from __future__ import annotations

import numpy as np

from libav_tpu_torch.bitstream.vlc import VLC
from libav_tpu_torch.codecs.aac import ps_tables as PT

NR_PAR_BANDS = (20, 34)
NR_BANDS = (71, 91)
DECAY_CUTOFF = (10, 32)
NR_ALLPASS_BANDS = (30, 50)
SHORT_DELAY_BAND = (42, 62)
NUM_ENV_TAB = ((0, 1, 2, 4), (1, 2, 3, 4))
NR_IIDICC_PAR_TAB = (10, 20, 34, 10, 20, 34)
NR_IPDOPD_PAR_TAB = (5, 11, 17, 5, 11, 17)
_AP_LINKS = 3
_MAX_DELAY = 14
_MAX_AP_DELAY = 5
_SLOTS = 32
DECAY_SLOPE = 0.05
_A = (0.65143905753106, 0.56471812200776, 0.48954165955695)

_vlcs = {}


def _vlc(name):
    v = _vlcs.get(name)
    if v is None:
        bits, codes = PT.HUFFMAN[name]
        v = _vlcs[name] = VLC(9, codes, bits)
    return v


_HUFF_IID = ("huff_iid_df0", "huff_iid_df1", "huff_iid_dt0",
             "huff_iid_dt1")


class PSContext:
    def __init__(self):
        self.start = False
        self.enable_iid = 0
        self.iid_quant = 0
        self.nr_iid_par = 0
        self.nr_ipdopd_par = 0
        self.enable_icc = 0
        self.icc_mode = 0
        self.nr_icc_par = 0
        self.enable_ext = 0
        self.enable_ipdopd = 0
        self.frame_class = 0
        self.num_env = 0
        self.num_env_old = 0
        self.border_position = np.zeros(6, dtype=np.int64)
        self.iid_par = np.zeros((6, 34), dtype=np.int64)
        self.icc_par = np.zeros((6, 34), dtype=np.int64)
        self.ipd_par = np.zeros((6, 34), dtype=np.int64)
        self.opd_par = np.zeros((6, 34), dtype=np.int64)
        self.is34bands = 0
        self.is34bands_old = 0
        # dsp state
        self.in_buf = np.zeros((5, 44), dtype=np.complex128)
        self.delay = np.zeros((91, _SLOTS + _MAX_DELAY),
                              dtype=np.complex128)
        self.ap_delay = np.zeros((50, _AP_LINKS, _SLOTS + _MAX_AP_DELAY),
                                 dtype=np.complex128)
        self.peak_decay_nrg = np.zeros(34)
        self.power_smooth = np.zeros(34)
        self.peak_decay_diff_smooth = np.zeros(34)
        self.H = np.zeros((4, 2, 6, 34))     # H11,H12,H21,H22 [re/im]
        self.ipd_hist = np.zeros(17, dtype=np.int64)
        self.opd_hist = np.zeros(17, dtype=np.int64)

    # -- bitstream ------------------------------------------------------

    def _read_par(self, gb, par, table, e, dt, num, offset, mask,
                  maxabs=None):
        vlc = _vlc(table)
        if dt:
            e_prev = max(e - 1 if e else self.num_env_old - 1, 0)
            base = par[e_prev]
        else:
            base = None
        val = 0
        for b in range(num):
            d = vlc.read(gb) - offset
            if dt:
                val = int(base[b]) + d
            else:
                val += d
            if mask:
                val &= mask
            par[e][b] = val
            if maxabs is not None and abs(val) > maxabs:
                raise ValueError("illegal PS parameter")

    def read_data(self, gb, bits_left: int) -> int:
        """ff_ps_read_data — returns bits consumed; on error resets
        parameters and consumes bits_left."""
        start_pos = gb.bits_read()
        try:
            header = gb.get_bits(1)
            if header:
                self.enable_iid = gb.get_bits(1)
                if self.enable_iid:
                    iid_mode = gb.get_bits(3)
                    if iid_mode > 5:
                        raise ValueError("iid_mode reserved")
                    self.nr_iid_par = NR_IIDICC_PAR_TAB[iid_mode]
                    self.iid_quant = int(iid_mode > 2)
                    self.nr_ipdopd_par = NR_IPDOPD_PAR_TAB[iid_mode]
                self.enable_icc = gb.get_bits(1)
                if self.enable_icc:
                    self.icc_mode = gb.get_bits(3)
                    if self.icc_mode > 5:
                        raise ValueError("icc_mode reserved")
                    self.nr_icc_par = NR_IIDICC_PAR_TAB[self.icc_mode]
                self.enable_ext = gb.get_bits(1)
            self.frame_class = gb.get_bits(1)
            self.num_env_old = self.num_env
            self.num_env = NUM_ENV_TAB[self.frame_class][gb.get_bits(2)]
            self.border_position[0] = -1
            if self.frame_class:
                for e in range(1, self.num_env + 1):
                    self.border_position[e] = gb.get_bits(5)
            else:
                for e in range(1, self.num_env + 1):
                    self.border_position[e] = \
                        (e * _SLOTS >> (self.num_env.bit_length() - 1)) - 1
            if self.enable_iid:
                for e in range(self.num_env):
                    dt = gb.get_bits(1)
                    t = _HUFF_IID[2 * dt + self.iid_quant]
                    self._read_par(gb, self.iid_par, t, e, dt,
                                   self.nr_iid_par, PT.HUFF_OFFSET[t], 0,
                                   maxabs=7 + 8 * self.iid_quant)
            else:
                self.iid_par[:] = 0
            if self.enable_icc:
                for e in range(self.num_env):
                    dt = gb.get_bits(1)
                    t = "huff_icc_dt" if dt else "huff_icc_df"
                    self._read_par(gb, self.icc_par, t, e, dt,
                                   self.nr_icc_par, PT.HUFF_OFFSET[t], 0)
                    if np.any(self.icc_par[e][:self.nr_icc_par] > 7) or \
                            np.any(self.icc_par[e][:self.nr_icc_par] < 0):
                        raise ValueError("illegal icc")
            else:
                self.icc_par[:] = 0
            if self.enable_ext:
                cnt = gb.get_bits(4)
                if cnt == 15:
                    cnt += gb.get_bits(8)
                cnt *= 8
                while cnt > 7:
                    ext_id = gb.get_bits(2)
                    cnt -= 2 + self._read_ext(gb, ext_id)
                if cnt < 0:
                    raise ValueError("ps extension overflow")
                gb.skip_bits(cnt)
            # fix up envelopes (fake envelope covering the frame tail)
            if not self.num_env or \
                    self.border_position[self.num_env] < _SLOTS - 1:
                source = self.num_env - 1 if self.num_env else \
                    self.num_env_old - 1
                if source >= 0 and source != self.num_env:
                    if self.enable_iid:
                        self.iid_par[self.num_env] = self.iid_par[source]
                    if self.enable_icc:
                        self.icc_par[self.num_env] = self.icc_par[source]
                    if self.enable_ipdopd:
                        self.ipd_par[self.num_env] = self.ipd_par[source]
                        self.opd_par[self.num_env] = self.opd_par[source]
                self.num_env += 1
                self.border_position[self.num_env] = _SLOTS - 1
            self.is34bands_old = self.is34bands
            if self.enable_iid or self.enable_icc:
                self.is34bands = int(
                    (self.enable_iid and self.nr_iid_par == 34) or
                    (self.enable_icc and self.nr_icc_par == 34))
            if not self.enable_ipdopd:
                self.ipd_par[:] = 0
                self.opd_par[:] = 0
            if header:
                self.start = True
            consumed = gb.bits_read() - start_pos
            if consumed <= bits_left:
                return consumed
            raise ValueError("PS overread")
        except Exception:
            self.start = False
            gb.skip_bits(start_pos + bits_left - gb.bits_read())
            self.iid_par[:] = 0
            self.icc_par[:] = 0
            self.ipd_par[:] = 0
            self.opd_par[:] = 0
            return bits_left

    def _read_ext(self, gb, ext_id) -> int:
        if ext_id:
            return 0
        pos = gb.bits_read()
        self.enable_ipdopd = gb.get_bits(1)
        if self.enable_ipdopd:
            for e in range(self.num_env):
                dt = gb.get_bits(1)
                self._read_par(gb, self.ipd_par,
                               "huff_ipd_dt" if dt else "huff_ipd_df",
                               e, dt, self.nr_ipdopd_par, 0, 0x07)
                dt = gb.get_bits(1)
                self._read_par(gb, self.opd_par,
                               "huff_opd_dt" if dt else "huff_opd_df",
                               e, dt, self.nr_ipdopd_par, 0, 0x07)
        gb.get_bits(1)      # reserved_ps
        return gb.bits_read() - pos

    # -- hybrid filterbank ----------------------------------------------

    def _hybrid_analysis(self, X):
        """X: (38, 64) complex QMF -> (nr_bands, 32) hybrid bands."""
        is34 = self.is34bands
        inb = self.in_buf
        new = np.zeros((5, 44), dtype=np.complex128)
        new[:, :6] = inb[:, :6]
        for i in range(5):
            new[i, 6:] = X[:, i]
        out = np.zeros((NR_BANDS[is34], _SLOTS), dtype=np.complex128)

        def fir(band, filt):
            """13-tap symmetric complex FIR per sub-subband
            (ps_hybrid_analysis_c semantics)."""
            n = filt.shape[0]
            res = np.zeros((n, _SLOTS), dtype=np.complex128)
            src = new[band]
            for i in range(_SLOTS):
                w = src[i:i + 13]
                s = filt[:, 6] * w[6]
                for j in range(6):
                    f = filt[:, j]
                    in0, in1 = w[j], w[12 - j]
                    s = s + (f.real * (in0.real + in1.real) -
                             f.imag * (in0.imag - in1.imag)) + \
                        1j * (f.real * (in0.imag + in1.imag) +
                              f.imag * (in0.real - in1.real))
                res[:, i] = s
            return res

        if is34:
            out[0:12] = fir(0, PT.F34_0_12)
            out[12:20] = fir(1, PT.F34_1_8)
            out[20:24] = fir(2, PT.F34_2_4)
            out[24:28] = fir(3, PT.F34_2_4)
            out[28:32] = fir(4, PT.F34_2_4)
            # ileave: out[27 + i] for i >= 5 comes straight from X
            out[32:91] = X[:_SLOTS, 5:64].T
        else:
            # hybrid6_cx on band 0 with reorder + merges
            t = fir(0, PT.F20_0_8)
            out[0] = t[6]
            out[1] = t[7]
            out[2] = t[0]
            out[3] = t[1]
            out[4] = t[2] + t[5]
            out[5] = t[3] + t[4]
            # hybrid2_re on bands 1 and 2 (real 13-tap, 2 subbands)
            for band, base, rev in ((1, 6, 1), (2, 8, 0)):
                src = new[band]
                g = PT.G1_Q2
                for i in range(_SLOTS):
                    w = src[i:i + 13]
                    inph = g[6] * w[6]
                    op = 0
                    for j in range(1, 6, 2):
                        op = op + g[j] * (w[j] + w[12 - j])
                    out[base + rev][i] = inph + op
                    out[base + (1 - rev)][i] = inph - op
            out[10:71] = X[:_SLOTS, 3:64].T
        # history update: memcpy(in[i], in[i]+32, 6) (aacps.c:369)
        self.in_buf = np.zeros((5, 44), dtype=np.complex128)
        self.in_buf[:, :6] = new[:, 32:38]
        return out

    def _hybrid_synthesis(self, hyb):
        """(nr_bands, 32) hybrid -> (38, 64) QMF (only 32 slots live)."""
        is34 = self.is34bands
        X = np.zeros((38, 64), dtype=np.complex128)
        if is34:
            X[:_SLOTS, 0] = hyb[0:12].sum(axis=0)
            X[:_SLOTS, 1] = hyb[12:20].sum(axis=0)
            X[:_SLOTS, 2] = hyb[20:24].sum(axis=0)
            X[:_SLOTS, 3] = hyb[24:28].sum(axis=0)
            X[:_SLOTS, 4] = hyb[28:32].sum(axis=0)
            X[:_SLOTS, 5:64] = hyb[32:91].T
        else:
            X[:_SLOTS, 0] = hyb[0:6].sum(axis=0)
            X[:_SLOTS, 1] = hyb[6:8].sum(axis=0)
            X[:_SLOTS, 2] = hyb[8:10].sum(axis=0)
            X[:_SLOTS, 3:64] = hyb[10:71].T
        return X

    # -- decorrelation ----------------------------------------------------

    def _decorrelate(self, s):
        is34 = self.is34bands
        k_to_i = PT.K_TO_I_34 if is34 else PT.K_TO_I_20
        nbands = NR_BANDS[is34]
        npar = NR_PAR_BANDS[is34]
        out = np.zeros_like(s)

        if is34 != self.is34bands_old:
            self.peak_decay_nrg[:] = 0
            self.power_smooth[:] = 0
            self.peak_decay_diff_smooth[:] = 0
            self.delay[:] = 0
            self.ap_delay[:] = 0

        power = np.zeros((34, _SLOTS))
        for k in range(nbands):
            i = int(k_to_i[k])
            power[i] += np.abs(s[k]) ** 2

        peak_decay_factor = 0.76592833836465
        transient_impact = 1.5
        a_smooth = 0.25
        tg = np.ones((34, _SLOTS))
        for i in range(npar):
            pd = self.peak_decay_nrg[i]
            psm = self.power_smooth[i]
            pdd = self.peak_decay_diff_smooth[i]
            for n in range(_SLOTS):
                pd = max(pd * peak_decay_factor, power[i][n])
                psm += a_smooth * (power[i][n] - psm)
                pdd += a_smooth * (pd - power[i][n] - pdd)
                denom = transient_impact * pdd
                tg[i][n] = psm / denom if denom > psm else 1.0
            self.peak_decay_nrg[i] = pd
            self.power_smooth[i] = psm
            self.peak_decay_diff_smooth[i] = pdd

        for k in range(NR_ALLPASS_BANDS[is34]):
            b = int(k_to_i[k])
            g = 1.0 - DECAY_SLOPE * (k - DECAY_CUTOFF[is34])
            g = min(max(g, 0.0), 1.0)
            self.delay[k][: _MAX_DELAY] = self.delay[k][_SLOTS:]
            self.delay[k][_MAX_DELAY:] = s[k]
            ap = self.ap_delay[k]
            for m in range(_AP_LINKS):
                ap[m][:_MAX_AP_DELAY] = ap[m][_SLOTS:]
            # ps_decorrelate_c
            ag = [a * g for a in _A]
            phi = PT.PHI_FRACT[is34][k]
            Qf = PT.Q_FRACT_ALLPASS[is34][k]
            dl = self.delay[k]
            for n in range(_SLOTS):
                v = dl[_MAX_DELAY - 2 + n] * phi
                for m in range(_AP_LINKS):
                    link = ap[m][n + 2 - m]
                    apd = v
                    v = link * Qf[m] - ag[m] * v
                    ap[m][n + 5] = apd + ag[m] * v
                out[k][n] = tg[b][n] * v
        for k in range(NR_ALLPASS_BANDS[is34], SHORT_DELAY_BAND[is34]):
            i = int(k_to_i[k])
            self.delay[k][: _MAX_DELAY] = self.delay[k][_SLOTS:]
            self.delay[k][_MAX_DELAY:] = s[k]
            out[k] = tg[i] * self.delay[k][_MAX_DELAY - 14:
                                           _MAX_DELAY - 14 + _SLOTS]
        for k in range(SHORT_DELAY_BAND[is34], nbands):
            i = int(k_to_i[k])
            self.delay[k][: _MAX_DELAY] = self.delay[k][_SLOTS:]
            self.delay[k][_MAX_DELAY:] = s[k]
            out[k] = tg[i] * self.delay[k][_MAX_DELAY - 1:
                                           _MAX_DELAY - 1 + _SLOTS]
        return out

    # -- parameter band remapping -----------------------------------------

    @staticmethod
    def _map_idx_10_to_20(par, full):
        out = np.zeros(34, par.dtype)
        b = 9 if full else 4
        for i in range(b, -1, -1):
            out[2 * i + 1] = out[2 * i] = par[i]
        return out

    @staticmethod
    def _map_idx_34_to_20(par, full):
        out = np.zeros(34, par.dtype)
        out[0] = (2 * par[0] + par[1]) // 3
        out[1] = (par[1] + 2 * par[2]) // 3
        out[2] = (2 * par[3] + par[4]) // 3
        out[3] = (par[4] + 2 * par[5]) // 3
        out[4] = (par[6] + par[7]) // 2
        out[5] = (par[8] + par[9]) // 2
        out[6] = par[10]
        out[7] = par[11]
        out[8] = (par[12] + par[13]) // 2
        out[9] = (par[14] + par[15]) // 2
        out[10] = par[16]
        if full:
            out[11] = par[17]
            out[12] = par[18]
            out[13] = par[19]
            out[14] = (par[20] + par[21]) // 2
            out[15] = (par[22] + par[23]) // 2
            out[16] = (par[24] + par[25]) // 2
            out[17] = (par[26] + par[27]) // 2
            out[18] = (par[28] + par[29] + par[30] + par[31]) // 4
            out[19] = (par[32] + par[33]) // 2
        return out

    _SRC_10_TO_34_LO = (0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 4, 4)
    _SRC_10_TO_34_HI = (5, 5, 6, 6, 7, 7, 7, 7, 8, 8, 8, 8, 9, 9, 9, 9,
                        9, 9)

    @classmethod
    def _map_idx_10_to_34(cls, par, full):
        out = np.zeros(34, par.dtype)
        for i, s in enumerate(cls._SRC_10_TO_34_LO):
            out[i] = par[s]
        if full:
            for i, s in enumerate(cls._SRC_10_TO_34_HI):
                out[16 + i] = par[s]
        else:
            out[16] = 0
        return out

    @staticmethod
    def _map_idx_20_to_34(par, full):
        out = np.zeros(34, par.dtype)
        out[0] = par[0]
        out[1] = (par[0] + par[1]) // 2
        out[2] = par[1]
        out[3] = par[2]
        out[4] = (par[2] + par[3]) // 2
        out[5] = par[3]
        out[6] = par[4]
        out[7] = par[4]
        out[8] = par[5]
        out[9] = par[5]
        out[10] = par[6]
        out[11] = par[7]
        out[12] = par[8]
        out[13] = par[8]
        out[14] = par[9]
        out[15] = par[9]
        out[16] = par[10]
        if full:
            out[17] = par[11]
            out[18] = par[12]
            out[19] = par[13]
            out[20] = par[14]
            out[21] = par[14]
            out[22] = par[15]
            out[23] = par[15]
            out[24] = par[16]
            out[25] = par[16]
            out[26] = par[17]
            out[27] = par[17]
            out[28] = par[18]
            out[29] = par[18]
            out[30] = par[18]
            out[31] = par[18]
            out[32] = par[19]
            out[33] = par[19]
        return out

    def _remap(self, par, num_par, full):
        """Remap an index envelope array to the active band count."""
        is34 = self.is34bands
        out = np.zeros((self.num_env, 34), par.dtype)
        for e in range(self.num_env):
            if is34:
                if num_par in (20, 11):
                    out[e] = self._map_idx_20_to_34(par[e], full)
                elif num_par in (10, 5):
                    out[e] = self._map_idx_10_to_34(par[e], full)
                else:
                    out[e] = par[e][:34]
            else:
                if num_par in (34, 17):
                    out[e] = self._map_idx_34_to_20(par[e], full)
                elif num_par in (10, 5):
                    out[e] = self._map_idx_10_to_20(par[e], full)
                else:
                    out[e] = par[e][:34]
        return out

    @staticmethod
    def _map_val_34_to_20(par):
        p = par.copy()
        par[0] = (2 * p[0] + p[1]) / 3
        par[1] = (p[1] + 2 * p[2]) / 3
        par[2] = (2 * p[3] + p[4]) / 3
        par[3] = (p[4] + 2 * p[5]) / 3
        par[4] = (p[6] + p[7]) / 2
        par[5] = (p[8] + p[9]) / 2
        par[6] = p[10]
        par[7] = p[11]
        par[8] = (p[12] + p[13]) / 2
        par[9] = (p[14] + p[15]) / 2
        par[10] = p[16]
        par[11] = p[17]
        par[12] = p[18]
        par[13] = p[19]
        par[14] = (p[20] + p[21]) / 2
        par[15] = (p[22] + p[23]) / 2
        par[16] = (p[24] + p[25]) / 2
        par[17] = (p[26] + p[27]) / 2
        par[18] = (p[28] + p[29] + p[30] + p[31]) / 4
        par[19] = (p[32] + p[33]) / 2

    @staticmethod
    def _map_val_20_to_34(par):
        p = par.copy()
        par[33] = p[19]
        par[32] = p[19]
        par[31] = p[18]
        par[30] = p[18]
        par[29] = p[18]
        par[28] = p[18]
        par[27] = p[17]
        par[26] = p[17]
        par[25] = p[16]
        par[24] = p[16]
        par[23] = p[15]
        par[22] = p[15]
        par[21] = p[14]
        par[20] = p[14]
        par[19] = p[13]
        par[18] = p[12]
        par[17] = p[11]
        par[16] = p[10]
        par[15] = p[9]
        par[14] = p[9]
        par[13] = p[8]
        par[12] = p[8]
        par[11] = p[7]
        par[10] = p[6]
        par[9] = p[5]
        par[8] = p[5]
        par[7] = p[4]
        par[6] = p[4]
        par[5] = p[3]
        par[4] = (p[2] + p[3]) / 2
        par[3] = p[2]
        par[2] = p[1]
        par[1] = (p[0] + p[1]) / 2
        par[0] = p[0]

    # -- stereo processing --------------------------------------------------

    def _stereo_processing(self, l, r):
        is34 = self.is34bands
        k_to_i = PT.K_TO_I_34 if is34 else PT.K_TO_I_20
        H = self.H
        if self.num_env_old:
            H[:, :, 0, :] = H[:, :, self.num_env_old, :]
        iid_m = self._remap(self.iid_par, self.nr_iid_par, 1)
        icc_m = self._remap(self.icc_par, self.nr_icc_par, 1)
        if self.enable_ipdopd:
            ipd_m = self._remap(self.ipd_par, self.nr_ipdopd_par, 0)
            opd_m = self._remap(self.opd_par, self.nr_ipdopd_par, 0)
        if is34 and not self.is34bands_old:
            for c in range(4):
                for p in range(2):
                    self._map_val_20_to_34(H[c][p][0])
            self.ipd_hist[:] = 0
            self.opd_hist[:] = 0
        elif not is34 and self.is34bands_old:
            for c in range(4):
                for p in range(2):
                    self._map_val_34_to_20(H[c][p][0])
            self.ipd_hist[:] = 0
            self.opd_hist[:] = 0

        H_LUT = PT.HA if self.icc_mode < 3 else PT.HB
        for e in range(self.num_env):
            for b in range(NR_PAR_BANDS[is34]):
                hx = H_LUT[int(iid_m[e][b]) + 7 + 23 * self.iid_quant][
                    int(icc_m[e][b])]
                h = list(hx)
                hi = [0.0, 0.0, 0.0, 0.0]
                if self.enable_ipdopd and b < self.nr_ipdopd_par:
                    opd_idx = int(self.opd_hist[b]) * 8 + int(opd_m[e][b])
                    ipd_idx = int(self.ipd_hist[b]) * 8 + int(ipd_m[e][b])
                    opd_re = PT.PD_RE_SMOOTH[opd_idx]
                    opd_im = PT.PD_IM_SMOOTH[opd_idx]
                    ipd_re = PT.PD_RE_SMOOTH[ipd_idx]
                    ipd_im = PT.PD_IM_SMOOTH[ipd_idx]
                    self.opd_hist[b] = opd_idx & 0x3F
                    self.ipd_hist[b] = ipd_idx & 0x3F
                    ipd_adj_re = opd_re * ipd_re + opd_im * ipd_im
                    ipd_adj_im = opd_im * ipd_re - opd_re * ipd_im
                    hi = [h[0] * opd_im, h[1] * ipd_adj_im,
                          h[2] * opd_im, h[3] * ipd_adj_im]
                    h = [h[0] * opd_re, h[1] * ipd_adj_re,
                         h[2] * opd_re, h[3] * ipd_adj_re]
                for c in range(4):
                    H[c][0][e + 1][b] = h[c]
                    H[c][1][e + 1][b] = hi[c]
            start = int(self.border_position[e])
            stop = int(self.border_position[e + 1])
            width = 1.0 / (stop - start)
            for k in range(NR_BANDS[is34]):
                b = int(k_to_i[k])
                h0 = np.array([H[c][0][e][b] for c in range(4)])
                h1 = np.array([H[c][1][e][b] for c in range(4)])
                if self.enable_ipdopd and \
                        ((is34 and 9 <= k <= 13) or (not is34 and k <= 1)):
                    h1 = -h1
                t0 = np.array([H[c][0][e + 1][b] for c in range(4)])
                t1 = np.array([H[c][1][e + 1][b] for c in range(4)])
                hs0 = (t0 - h0) * width
                hs1 = (t1 - h1) * width
                n = np.arange(1, stop - start + 1)
                cur0 = h0[None, :] + n[:, None] * hs0[None, :]
                lseg = l[k][start + 1:stop + 1].copy()
                rseg = r[k][start + 1:stop + 1].copy()
                if self.enable_ipdopd:
                    cur1 = h1[None, :] + n[:, None] * hs1[None, :]
                    hc = cur0 + 1j * cur1
                    l[k][start + 1:stop + 1] = \
                        hc[:, 0] * lseg + hc[:, 2] * rseg
                    r[k][start + 1:stop + 1] = \
                        hc[:, 1] * lseg + hc[:, 3] * rseg
                else:
                    l[k][start + 1:stop + 1] = \
                        cur0[:, 0] * lseg + cur0[:, 2] * rseg
                    r[k][start + 1:stop + 1] = \
                        cur0[:, 1] * lseg + cur0[:, 3] * rseg

    # -- entry ---------------------------------------------------------------

    def apply(self, X, top: int):
        """X: (38, 64) complex mono QMF; returns (L, R) same shape
        (ff_ps_apply)."""
        is34 = self.is34bands
        top += NR_BANDS[is34] - 64
        if top < NR_BANDS[is34]:
            self.delay[max(top, 0):NR_BANDS[is34]] = 0
        if top < NR_ALLPASS_BANDS[is34]:
            self.ap_delay[max(top, 0):NR_ALLPASS_BANDS[is34]] = 0
        lbuf = self._hybrid_analysis(X)
        rbuf = self._decorrelate(lbuf)
        self._stereo_processing(lbuf, rbuf)
        L = self._hybrid_synthesis(lbuf)
        R = self._hybrid_synthesis(rbuf)
        return L, R
