"""Spectral Band Replication decoder (HE-AAC; ISO/IEC 14496-3 4.6.18).

Reference behavior: libavcodec/aacsbr.c (parse: read_sbr_header :224,
read_sbr_grid :627, read_sbr_envelope :805; tables: sbr_make_f_master
:321, sbr_make_f_derived :560, sbr_hf_calc_npatches :508; DSP chain:
ff_sbr_apply :1652 — QMF analysis, LF/HF generation with covariance
inverse filtering, HF adjustment with limiter/boost gains, noise and
sinusoid assembly, QMF synthesis) + libavcodec/sbrdsp.c kernels.

TPU-shaped re-expression: the reference's shuffle+iMDCT QMF banks are
*linear* maps, so they are materialized once as small matrices (by
pushing a basis through a literal transcription of the shuffles) and
each frame's filterbank is then one einsum over all 32 time slots —
MXU-friendly and trivially batchable.  The serial part (bitstream
parse, per-band recursions) stays host-side numpy like the rest of the
audio codecs.
"""

from __future__ import annotations

import numpy as np

from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.bitstream.vlc import VLC
from libav_tpu_torch.codecs.aac import sbr_tables as ST

FIXFIX, FIXVAR, VARFIX, VARVAR = range(4)
ENVELOPE_ADJUSTMENT_OFFSET = 2
NOISE_FLOOR_OFFSET = 6.0
_CEIL_LOG2 = (0, 1, 2, 2, 3, 3)

_vlcs = {}


def _vlc(name):
    v = _vlcs.get(name)
    if v is None:
        bits, codes = ST.HUFFMAN[name]
        v = _vlcs[name] = VLC(9, codes, bits)
    return v


# ---------------------------------------------------------------------------
# QMF banks as precomputed linear operators (aacsbr.c:1153,1175 +
# sbrdsp.c shuffles + mdct_template.c imdct_half, replicated on a basis)

def _imdct_half_mat(scale: float) -> np.ndarray:
    """64x64 real matrix of ff_imdct_half for N=128 with the given mdct
    scale (mdct_template.c:139; theta/scale handling ff_mdct_init:71-78).
    Input: 64 floats; output: 32 interleaved re/im pairs viewed flat."""
    n, n2, n4, n8 = 128, 64, 32, 16
    theta = 1.0 / 8.0 + (n4 if scale < 0 else 0)
    s = np.sqrt(abs(scale))
    i = np.arange(n4)
    alpha = 2 * np.pi * (i + theta) / n
    tcos = -np.cos(alpha) * s
    tsin = -np.sin(alpha) * s
    twid = tcos + 1j * tsin

    out = np.zeros((64, 64))
    for col in range(64):
        inp = np.zeros(64)
        inp[col] = 1.0
        # pre rotation: z[k] = (in[n2-1-2k] + j*in[2k]) * twid[k]
        z = (inp[n2 - 1 - 2 * i] + 1j * inp[2 * i]) * twid
        # inverse FFT (un-normalized): Z[k] = sum z[n] e^{+2pi j kn/32}
        z = np.fft.ifft(z) * n4
        # post rotation + reordering
        zz = z.copy()
        for k in range(n8):
            a = z[n8 - k - 1]
            b = z[n8 + k]
            r0 = a.imag * tsin[n8 - k - 1] - a.real * tcos[n8 - k - 1]
            i1 = a.imag * tcos[n8 - k - 1] + a.real * tsin[n8 - k - 1]
            r1 = b.imag * tsin[n8 + k] - b.real * tcos[n8 + k]
            i0 = b.imag * tcos[n8 + k] + b.real * tsin[n8 + k]
            zz[n8 - k - 1] = r0 + 1j * i0
            zz[n8 + k] = r1 + 1j * i1
        flat = np.empty(64)
        flat[0::2] = zz.real
        flat[1::2] = zz.imag
        out[:, col] = flat
    return out


def _build_analysis_matrix() -> np.ndarray:
    """Complex (32, 64) matrix A with W[k] = sum_n A[k, n] * u[n]
    (sbr_qmf_analysis: pre_shuffle -> imdct_half(scale=-2*32768) ->
    post_shuffle)."""
    M = _imdct_half_mat(-2.0 * 32768.0)
    A = np.zeros((32, 64), dtype=np.complex128)
    for col in range(64):
        u = np.zeros(64)
        u[col] = 1.0
        z = np.zeros(128)
        z[:64] = u
        # sbr_qmf_pre_shuffle_c (sbrdsp.c:63)
        z[64] = u[0]
        z[65] = u[1]
        for k in range(1, 31, 2):
            z[64 + 2 * k + 0] = -u[64 - k]
            z[64 + 2 * k + 1] = u[k + 1]
            z[64 + 2 * k + 2] = -u[63 - k]
            z[64 + 2 * k + 3] = u[k + 2]
        z[64 + 62] = -u[33]
        z[64 + 63] = u[32]
        flat = M @ z[64:]
        # sbr_qmf_post_shuffle_c: W[k] = (-z[63-k], z[k])
        k = np.arange(32)
        A[:, col] = -flat[63 - k] + 1j * flat[k]
    return A


def _build_synthesis_matrix() -> np.ndarray:
    """Real (128, 128) matrix S with v = S @ [re(X_0..63), im(X_0..63)]
    (sbr_qmf_synthesis upsampled path: neg_odd_64 -> 2x imdct_half
    (scale=1/(64*32768)) -> qmf_deint_bfly)."""
    M = _imdct_half_mat(1.0 / (64.0 * 32768.0))
    S = np.zeros((128, 128))
    for col in range(128):
        xr = np.zeros(64)
        xi = np.zeros(64)
        if col < 64:
            xr[col] = 1.0
        else:
            xi[col - 64] = 1.0
        xi[1::2] = -xi[1::2]            # sbr_neg_odd_64_c
        buf0 = M @ xr
        buf1 = M @ xi
        v = np.empty(128)
        i = np.arange(64)
        v[i] = buf1[i] - buf0[63 - i]   # sbr_qmf_deint_bfly_c
        v[127 - i] = buf1[i] + buf0[63 - i]
        S[:, col] = v
    return S


_ANA_MAT = None
_SYN_MAT = None
_WIN_DS = None


def _mats():
    global _ANA_MAT, _SYN_MAT, _WIN_DS
    if _ANA_MAT is None:
        _ANA_MAT = _build_analysis_matrix()
        _SYN_MAT = _build_synthesis_matrix()
        _WIN_DS = ST.QMF_WINDOW[::2].copy()
    return _ANA_MAT, _SYN_MAT, _WIN_DS


# ---------------------------------------------------------------------------


class SBRChannel:
    """Per-channel persistent state (sbr.h SBRData)."""

    def __init__(self):
        self.bs_frame_class = FIXFIX
        self.bs_num_env = 0
        self.bs_num_noise = 0
        self.bs_freq_res = np.zeros(7, dtype=np.int64)
        self.t_env = np.zeros(8, dtype=np.int64)
        self.t_q = np.zeros(3, dtype=np.int64)
        self.t_env_num_env_old = 0
        self.bs_amp_res = 0
        self.bs_invf_mode = np.zeros((2, 5), dtype=np.int64)
        self.bs_add_harmonic_flag = 0
        self.bs_add_harmonic = np.zeros(48, dtype=np.int64)
        self.env_facs = np.zeros((6, 48))
        self.noise_facs = np.zeros((3, 5))
        self.bs_df_env = np.zeros(5, dtype=np.int64)
        self.bs_df_noise = np.zeros(2, dtype=np.int64)
        self.e_a = [-1, -1]
        self.bw_array = np.zeros(5)
        self.s_indexmapped = np.zeros((8, 48), dtype=np.int64)
        self.g_temp = np.zeros((42, 48))
        self.q_temp = np.zeros((42, 48))
        self.f_indexnoise = 0
        self.f_indexsine = 0
        # filterbank state
        self.x_ana = np.zeros(1312)          # analysis input history
        self.W = np.zeros((2, 32, 32), dtype=np.complex128)
        self.Ypos = 0
        self.Y = np.zeros((2, 38, 64), dtype=np.complex128)
        self.v_hist = np.zeros((10, 128))    # synthesis: newest first


class SBRContext:
    """One per SCE/CPE element (sbr.h SpectralBandReplication)."""

    def __init__(self):
        self.start = False
        self.reset = False
        self.sample_rate = 0
        self.bs_amp_res_header = 1
        self.spectrum_params = None          # (start, stop, xover, fscale,
                                             #  alter, noise_bands)
        self.bs_limiter_bands = 2
        self.bs_limiter_gains = 2
        self.bs_interpol_freq = 1
        self.bs_smoothing_mode = 1
        self.bs_coupling = 0
        self.k = [0, 0, 0]
        self.kx = [32, 32]                   # sbr_turnoff defaults
        self.m = [0, 0]
        self.kx_and_m_pushed = False
        self.n_master = 0
        self.f_master = None
        self.n = [0, 0]
        self.f_tablehigh = None
        self.f_tablelow = None
        self.n_q = 0
        self.f_tablenoise = None
        self.n_lim = 0
        self.f_tablelim = None
        self.num_patches = 0
        self.patch_num_subbands = []
        self.patch_start_subband = []
        self.data = [SBRChannel(), SBRChannel()]
        self.ps = None                       # PSContext when HE-AACv2

    def _turnoff(self):
        self.start = False
        self.kx[1] = 32
        self.m[1] = 0

    # -- header/tables ------------------------------------------------

    def _read_header(self, gb):
        old_lim = self.bs_limiter_bands
        self.start = True
        self.bs_amp_res_header = gb.get_bits(1)
        sp = (gb.get_bits(4), gb.get_bits(4), gb.get_bits(3))
        gb.skip_bits(2)
        extra1 = gb.get_bits(1)
        extra2 = gb.get_bits(1)
        if extra1:
            sp = sp + (gb.get_bits(2), gb.get_bits(1), gb.get_bits(2))
        else:
            sp = sp + (2, 1, 2)
        if sp != self.spectrum_params:
            self.reset = True
        self.spectrum_params = sp
        if extra2:
            self.bs_limiter_bands = gb.get_bits(2)
            self.bs_limiter_gains = gb.get_bits(2)
            self.bs_interpol_freq = gb.get_bits(1)
            self.bs_smoothing_mode = gb.get_bits(1)
        else:
            self.bs_limiter_bands = 2
            self.bs_limiter_gains = 2
            self.bs_interpol_freq = 1
            self.bs_smoothing_mode = 1
        if self.bs_limiter_bands != old_lim and not self.reset:
            self._make_f_tablelim()

    def _make_f_master(self):
        """aacsbr.c:321 (14496-3 sp04 p194)."""
        sr = self.sample_rate
        (bs_start, bs_stop, bs_xover, fscale, alter, _nb) = \
            self.spectrum_params
        if sr == 16000:
            offs = ST.SBR_OFFSET[0]
        elif sr == 22050:
            offs = ST.SBR_OFFSET[1]
        elif sr == 24000:
            offs = ST.SBR_OFFSET[2]
        elif sr == 32000:
            offs = ST.SBR_OFFSET[3]
        elif sr in (44100, 48000, 64000):
            offs = ST.SBR_OFFSET[4]
        elif sr in (88200, 96000, 128000, 176400, 192000):
            offs = ST.SBR_OFFSET[5]
        else:
            raise AVError(INVALIDDATA, f"unsupported SBR rate {sr}")
        temp = 3000 if sr < 32000 else (4000 if sr < 64000 else 5000)
        start_min = ((temp << 7) + (sr >> 1)) // sr
        stop_min = ((temp << 8) + (sr >> 1)) // sr
        self.k[0] = start_min + offs[bs_start]
        if bs_stop < 14:
            self.k[2] = stop_min
            dk = sorted(_make_bands(stop_min, 64, 13))
            self.k[2] += sum(dk[:bs_stop])
        elif bs_stop == 14:
            self.k[2] = 2 * self.k[0]
        else:
            self.k[2] = 3 * self.k[0]
        self.k[2] = min(64, self.k[2])
        max_sb = 48 if sr <= 32000 else (35 if sr == 44100 else 32)
        if self.k[2] - self.k[0] > max_sb:
            raise AVError(INVALIDDATA, "too many QMF subbands")
        if not fscale:
            dk = alter + 1
            n_master = ((self.k[2] - self.k[0] + (dk & 2)) >> dk) << 1
            if n_master <= 0 or bs_xover >= n_master:
                raise AVError(INVALIDDATA, "invalid n_master/xover")
            fm = [dk] * (n_master + 1)
            k2diff = self.k[2] - self.k[0] - n_master * dk
            if k2diff < 0:
                fm[1] -= 1
                fm[2] -= (k2diff < -1)
            elif k2diff:
                fm[n_master] += 1
            fm[0] = self.k[0]
            for i in range(1, n_master + 1):
                fm[i] += fm[i - 1]
            self.n_master = n_master
            self.f_master = np.array(fm, dtype=np.int64)
        else:
            half_bands = 7 - fscale
            if 49 * self.k[2] > 110 * self.k[0]:
                two_regions = True
                self.k[1] = 2 * self.k[0]
            else:
                two_regions = False
                self.k[1] = self.k[2]
            num_bands_0 = int(np.rint(
                half_bands * np.log2(self.k[1] / float(self.k[0])))) * 2
            if num_bands_0 <= 0:
                raise AVError(INVALIDDATA, "invalid num_bands_0")
            vk0 = sorted(_make_bands(self.k[0], self.k[1], num_bands_0))
            vdk0_max = vk0[-1]
            if min(vk0) <= 0:
                raise AVError(INVALIDDATA, "invalid vDk0")
            fm = [self.k[0]]
            for d in vk0:
                fm.append(fm[-1] + d)
            if two_regions:
                invwarp = 0.76923076923076923077 if alter else 1.0
                num_bands_1 = int(np.rint(
                    half_bands * invwarp *
                    np.log2(self.k[2] / float(self.k[1])))) * 2
                vk1 = _make_bands(self.k[1], self.k[2], num_bands_1)
                if min(vk1) < vdk0_max:
                    vk1 = sorted(vk1)
                    change = min(vdk0_max - vk1[0],
                                 (vk1[-1] - vk1[0]) >> 1)
                    vk1[0] += change
                    vk1[-1] -= change
                vk1 = sorted(vk1)
                if min(vk1) <= 0:
                    raise AVError(INVALIDDATA, "invalid vDk1")
                for d in vk1:
                    fm.append(fm[-1] + d)
                self.n_master = num_bands_0 + num_bands_1
            else:
                self.n_master = num_bands_0
            if bs_xover >= self.n_master:
                raise AVError(INVALIDDATA, "xover >= n_master")
            self.f_master = np.array(fm, dtype=np.int64)

    def _calc_patches(self):
        """aacsbr.c:508 (14496-3 sp04 p216 fig. 4.46)."""
        sr = self.sample_rate
        msb = self.k[0]
        usb = self.kx[1]
        goal_sb = ((1000 << 11) + (sr >> 1)) // sr
        self.num_patches = 0
        self.patch_num_subbands = []
        self.patch_start_subband = []
        if goal_sb < self.kx[1] + self.m[1]:
            k = 0
            while self.f_master[k] < goal_sb:
                k += 1
        else:
            k = self.n_master
        sb = 0
        while True:
            odd = 0
            i = k
            while i == k or sb > (self.k[0] - 1 + msb - odd):
                sb = int(self.f_master[i])
                odd = (sb + self.k[0]) & 1
                i -= 1
            if self.num_patches > 5:
                raise AVError(INVALIDDATA, "too many patches")
            pn = max(sb - usb, 0)
            ps = self.k[0] - odd - pn
            self.patch_num_subbands.append(pn)
            self.patch_start_subband.append(ps)
            if pn > 0:
                usb = sb
                msb = sb
                self.num_patches += 1
            else:
                msb = self.kx[1]
                self.patch_num_subbands.pop()
                self.patch_start_subband.pop()
            if self.f_master[k] - sb < 3:
                k = self.n_master
            if sb == self.kx[1] + self.m[1]:
                break
        if self.num_patches > 1 and self.patch_num_subbands[-1] < 3:
            self.num_patches -= 1
            self.patch_num_subbands.pop()
            self.patch_start_subband.pop()

    def _make_f_tablelim(self):
        """aacsbr.c:177."""
        if self.bs_limiter_bands > 0:
            bands_warped = (1.32715174233856803909,
                            1.18509277094158210129,
                            1.11987160404675912501)
            warp = bands_warped[self.bs_limiter_bands - 1]
            patch_borders = [self.kx[1]]
            for pn in self.patch_num_subbands:
                patch_borders.append(patch_borders[-1] + pn)
            lim = list(self.f_tablelow) + patch_borders[1:-1] \
                if self.num_patches > 1 else list(self.f_tablelow)
            lim.sort()
            n_lim = self.n[0] + self.num_patches - 1
            # in-place merge walk (aacsbr.c:203-216)
            out = 0
            inp = 1
            pb = patch_borders[:self.num_patches + 1]
            while out < n_lim:
                if lim[inp] >= lim[out] * warp:
                    out += 1
                    lim[out] = lim[inp]
                    inp += 1
                elif lim[inp] == lim[out] or lim[inp] not in pb:
                    inp += 1
                    n_lim -= 1
                elif lim[out] not in pb:
                    lim[out] = lim[inp]
                    inp += 1
                    n_lim -= 1
                else:
                    out += 1
                    lim[out] = lim[inp]
                    inp += 1
            self.n_lim = n_lim
            self.f_tablelim = np.array(lim[:n_lim + 1], dtype=np.int64)
        else:
            self.n_lim = 1
            self.f_tablelim = np.array(
                [self.f_tablelow[0], self.f_tablelow[self.n[0]]],
                dtype=np.int64)

    def _make_f_derived(self):
        """aacsbr.c:560."""
        bs_xover = self.spectrum_params[2]
        self.n[1] = self.n_master - bs_xover
        self.n[0] = (self.n[1] + 1) >> 1
        self.f_tablehigh = self.f_master[bs_xover:
                                         bs_xover + self.n[1] + 1].copy()
        self.m[1] = int(self.f_tablehigh[self.n[1]] - self.f_tablehigh[0])
        self.kx[1] = int(self.f_tablehigh[0])
        if self.kx[1] + self.m[1] > 64 or self.kx[1] > 32:
            raise AVError(INVALIDDATA, "SBR frequency borders too high")
        low = [int(self.f_tablehigh[0])]
        temp = self.n[1] & 1
        for k in range(1, self.n[0] + 1):
            low.append(int(self.f_tablehigh[2 * k - temp]))
        self.f_tablelow = np.array(low, dtype=np.int64)
        nb = self.spectrum_params[5]
        self.n_q = max(1, int(np.rint(
            nb * np.log2(self.k[2] / float(self.kx[1])))))
        if self.n_q > 5:
            raise AVError(INVALIDDATA, "too many noise bands")
        noise = [int(self.f_tablelow[0])]
        temp = 0
        for k in range(1, self.n_q + 1):
            temp += (self.n[0] - temp) // (self.n_q + 1 - k)
            noise.append(int(self.f_tablelow[temp]))
        self.f_tablenoise = np.array(noise, dtype=np.int64)
        self._calc_patches()
        self._make_f_tablelim()
        self.data[0].f_indexnoise = 0
        self.data[1].f_indexnoise = 0

    # -- per-frame data -----------------------------------------------

    def _read_grid(self, gb, ch):
        cd = self.data[ch]
        abs_bord_trail = 16
        old_num_env = cd.bs_num_env
        cd.bs_freq_res[0] = cd.bs_freq_res[cd.bs_num_env]
        cd.bs_amp_res = self.bs_amp_res_header
        cd.t_env_num_env_old = int(cd.t_env[cd.bs_num_env])
        bs_pointer = 0
        cd.bs_frame_class = gb.get_bits(2)
        if cd.bs_frame_class == FIXFIX:
            cd.bs_num_env = 1 << gb.get_bits(2)
            if cd.bs_num_env == 1:
                cd.bs_amp_res = 0
            if cd.bs_num_env > 4:
                raise AVError(INVALIDDATA, "too many FIXFIX envelopes")
            cd.t_env[0] = 0
            cd.t_env[cd.bs_num_env] = abs_bord_trail
            step = (abs_bord_trail + (cd.bs_num_env >> 1)) // cd.bs_num_env
            for i in range(cd.bs_num_env - 1):
                cd.t_env[i + 1] = cd.t_env[i] + step
            cd.bs_freq_res[1] = gb.get_bits(1)
            for i in range(1, cd.bs_num_env):
                cd.bs_freq_res[i + 1] = cd.bs_freq_res[1]
        elif cd.bs_frame_class == FIXVAR:
            abs_bord_trail += gb.get_bits(2)
            num_rel_trail = gb.get_bits(2)
            cd.bs_num_env = num_rel_trail + 1
            cd.t_env[0] = 0
            cd.t_env[cd.bs_num_env] = abs_bord_trail
            for i in range(num_rel_trail):
                cd.t_env[cd.bs_num_env - 1 - i] = \
                    cd.t_env[cd.bs_num_env - i] - 2 * gb.get_bits(2) - 2
            bs_pointer = gb.get_bits(_CEIL_LOG2[cd.bs_num_env])
            for i in range(cd.bs_num_env):
                cd.bs_freq_res[cd.bs_num_env - i] = gb.get_bits(1)
        elif cd.bs_frame_class == VARFIX:
            cd.t_env[0] = gb.get_bits(2)
            num_rel_lead = gb.get_bits(2)
            cd.bs_num_env = num_rel_lead + 1
            cd.t_env[cd.bs_num_env] = abs_bord_trail
            for i in range(num_rel_lead):
                cd.t_env[i + 1] = cd.t_env[i] + 2 * gb.get_bits(2) + 2
            bs_pointer = gb.get_bits(_CEIL_LOG2[cd.bs_num_env])
            for i in range(cd.bs_num_env):
                cd.bs_freq_res[i + 1] = gb.get_bits(1)
        else:
            cd.t_env[0] = gb.get_bits(2)
            abs_bord_trail += gb.get_bits(2)
            num_rel_lead = gb.get_bits(2)
            num_rel_trail = gb.get_bits(2)
            cd.bs_num_env = num_rel_lead + num_rel_trail + 1
            if cd.bs_num_env > 5:
                raise AVError(INVALIDDATA, "too many VARVAR envelopes")
            cd.t_env[cd.bs_num_env] = abs_bord_trail
            for i in range(num_rel_lead):
                cd.t_env[i + 1] = cd.t_env[i] + 2 * gb.get_bits(2) + 2
            for i in range(num_rel_trail):
                cd.t_env[cd.bs_num_env - 1 - i] = \
                    cd.t_env[cd.bs_num_env - i] - 2 * gb.get_bits(2) - 2
            bs_pointer = gb.get_bits(_CEIL_LOG2[cd.bs_num_env])
            for i in range(cd.bs_num_env):
                cd.bs_freq_res[i + 1] = gb.get_bits(1)
        if bs_pointer > cd.bs_num_env + 1:
            raise AVError(INVALIDDATA, "bs_pointer out of range")
        for i in range(1, cd.bs_num_env + 1):
            if cd.t_env[i - 1] > cd.t_env[i]:
                raise AVError(INVALIDDATA, "non monotone time borders")
        cd.bs_num_noise = (cd.bs_num_env > 1) + 1
        cd.t_q[0] = cd.t_env[0]
        cd.t_q[cd.bs_num_noise] = cd.t_env[cd.bs_num_env]
        if cd.bs_num_noise > 1:
            if cd.bs_frame_class == FIXFIX:
                idx = cd.bs_num_env >> 1
            elif cd.bs_frame_class & 1:      # FIXVAR or VARVAR
                idx = cd.bs_num_env - max(bs_pointer - 1, 1)
            else:                             # VARFIX
                if not bs_pointer:
                    idx = 1
                elif bs_pointer == 1:
                    idx = cd.bs_num_env - 1
                else:
                    idx = bs_pointer - 1
            cd.t_q[1] = cd.t_env[idx]
        cd.e_a[0] = -1 if cd.e_a[1] != old_num_env else 0
        cd.e_a[1] = -1
        if (cd.bs_frame_class & 1) and bs_pointer:
            cd.e_a[1] = cd.bs_num_env + 1 - bs_pointer
        elif cd.bs_frame_class == 2 and bs_pointer > 1:
            cd.e_a[1] = bs_pointer - 1

    def _copy_grid(self, dst_ch, src_ch):
        dst, src = self.data[dst_ch], self.data[src_ch]
        dst.bs_freq_res[0] = dst.bs_freq_res[dst.bs_num_env]
        dst.t_env_num_env_old = int(dst.t_env[dst.bs_num_env])
        dst.e_a[0] = -1 if dst.e_a[1] != dst.bs_num_env else 0
        dst.bs_freq_res[1:] = src.bs_freq_res[1:]
        dst.t_env[:] = src.t_env
        dst.t_q[:] = src.t_q
        dst.bs_num_env = src.bs_num_env
        dst.bs_amp_res = src.bs_amp_res
        dst.bs_num_noise = src.bs_num_noise
        dst.bs_frame_class = src.bs_frame_class
        dst.e_a[1] = src.e_a[1]

    def _read_dtdf(self, gb, ch):
        cd = self.data[ch]
        for i in range(cd.bs_num_env):
            cd.bs_df_env[i] = gb.get_bits(1)
        for i in range(cd.bs_num_noise):
            cd.bs_df_noise[i] = gb.get_bits(1)

    def _read_invf(self, gb, ch):
        cd = self.data[ch]
        cd.bs_invf_mode[1] = cd.bs_invf_mode[0]
        for i in range(self.n_q):
            cd.bs_invf_mode[0][i] = gb.get_bits(2)

    def _read_envelope(self, gb, ch):
        cd = self.data[ch]
        delta = 2 if (ch == 1 and self.bs_coupling == 1) else 1
        odd = self.n[1] & 1
        if self.bs_coupling and ch:
            if cd.bs_amp_res:
                bits, t, f = 5, 't_huffman_env_bal_3_0dB', \
                    'f_huffman_env_bal_3_0dB'
            else:
                bits, t, f = 6, 't_huffman_env_bal_1_5dB', \
                    'f_huffman_env_bal_1_5dB'
        else:
            if cd.bs_amp_res:
                bits, t, f = 6, 't_huffman_env_3_0dB', 'f_huffman_env_3_0dB'
            else:
                bits, t, f = 7, 't_huffman_env_1_5dB', 'f_huffman_env_1_5dB'
        t_huff, t_lav = _vlc(t), ST.LAV[t]
        f_huff, f_lav = _vlc(f), ST.LAV[f]
        for i in range(cd.bs_num_env):
            if cd.bs_df_env[i]:
                if cd.bs_freq_res[i + 1] == cd.bs_freq_res[i]:
                    for j in range(self.n[cd.bs_freq_res[i + 1]]):
                        cd.env_facs[i + 1][j] = cd.env_facs[i][j] + \
                            delta * (t_huff.read(gb) - t_lav)
                elif cd.bs_freq_res[i + 1]:
                    for j in range(self.n[1]):
                        k = (j + odd) >> 1
                        cd.env_facs[i + 1][j] = cd.env_facs[i][k] + \
                            delta * (t_huff.read(gb) - t_lav)
                else:
                    for j in range(self.n[0]):
                        k = 2 * j - odd if j else 0
                        cd.env_facs[i + 1][j] = cd.env_facs[i][k] + \
                            delta * (t_huff.read(gb) - t_lav)
            else:
                cd.env_facs[i + 1][0] = delta * gb.get_bits(bits)
                for j in range(1, self.n[cd.bs_freq_res[i + 1]]):
                    cd.env_facs[i + 1][j] = cd.env_facs[i + 1][j - 1] + \
                        delta * (f_huff.read(gb) - f_lav)
        cd.env_facs[0] = cd.env_facs[cd.bs_num_env]

    def _read_noise(self, gb, ch):
        cd = self.data[ch]
        delta = 2 if (ch == 1 and self.bs_coupling == 1) else 1
        if self.bs_coupling and ch:
            t, f = 't_huffman_noise_bal_3_0dB', 'f_huffman_env_bal_3_0dB'
        else:
            t, f = 't_huffman_noise_3_0dB', 'f_huffman_env_3_0dB'
        t_huff, t_lav = _vlc(t), ST.LAV[t]
        f_huff, f_lav = _vlc(f), ST.LAV[f]
        for i in range(cd.bs_num_noise):
            if cd.bs_df_noise[i]:
                for j in range(self.n_q):
                    cd.noise_facs[i + 1][j] = cd.noise_facs[i][j] + \
                        delta * (t_huff.read(gb) - t_lav)
            else:
                cd.noise_facs[i + 1][0] = delta * gb.get_bits(5)
                for j in range(1, self.n_q):
                    cd.noise_facs[i + 1][j] = \
                        cd.noise_facs[i + 1][j - 1] + \
                        delta * (f_huff.read(gb) - f_lav)
        cd.noise_facs[0] = cd.noise_facs[cd.bs_num_noise]

    def _read_data(self, gb, is_cpe):
        try:
            if not is_cpe:
                if gb.get_bits(1):
                    gb.skip_bits(4)
                self._read_grid(gb, 0)
                self._read_dtdf(gb, 0)
                self._read_invf(gb, 0)
                self._read_envelope(gb, 0)
                self._read_noise(gb, 0)
                self.data[0].bs_add_harmonic_flag = gb.get_bits(1)
                if self.data[0].bs_add_harmonic_flag:
                    for i in range(self.n[1]):
                        self.data[0].bs_add_harmonic[i] = gb.get_bits(1)
            else:
                if gb.get_bits(1):
                    gb.skip_bits(8)
                self.bs_coupling = gb.get_bits(1)
                if self.bs_coupling:
                    self._read_grid(gb, 0)
                    self._copy_grid(1, 0)
                    self._read_dtdf(gb, 0)
                    self._read_dtdf(gb, 1)
                    self._read_invf(gb, 0)
                    self.data[1].bs_invf_mode[1] = \
                        self.data[1].bs_invf_mode[0]
                    self.data[1].bs_invf_mode[0] = \
                        self.data[0].bs_invf_mode[0]
                    self._read_envelope(gb, 0)
                    self._read_noise(gb, 0)
                    self._read_envelope(gb, 1)
                    self._read_noise(gb, 1)
                else:
                    self._read_grid(gb, 0)
                    self._read_grid(gb, 1)
                    self._read_dtdf(gb, 0)
                    self._read_dtdf(gb, 1)
                    self._read_invf(gb, 0)
                    self._read_invf(gb, 1)
                    self._read_envelope(gb, 0)
                    self._read_envelope(gb, 1)
                    self._read_noise(gb, 0)
                    self._read_noise(gb, 1)
                for ch in range(2):
                    self.data[ch].bs_add_harmonic_flag = gb.get_bits(1)
                    if self.data[ch].bs_add_harmonic_flag:
                        for i in range(self.n[1]):
                            self.data[ch].bs_add_harmonic[i] = \
                                gb.get_bits(1)
        except AVError:
            self._turnoff()
            return
        if gb.get_bits(1):                   # bs_extended_data
            nbl = gb.get_bits(4)
            if nbl == 15:
                nbl += gb.get_bits(8)
            nbl <<= 3
            while nbl > 7:
                nbl -= 2
                ext_id = gb.get_bits(2)
                if ext_id == 2:              # EXTENSION_ID_PS
                    from libav_tpu_torch.codecs.aac.ps import PSContext
                    if self.ps is None:
                        self.ps = PSContext()
                    nbl -= self.ps.read_data(gb, nbl)
                else:
                    gb.skip_bits(nbl)
                    nbl = 0
            if nbl > 0:
                gb.skip_bits(nbl)

    def decode_extension(self, gb, crc: bool, cnt: int, is_cpe: bool,
                         core_rate: int):
        """Parse one EXT_SBR_DATA(_CRC) fill payload.  `gb` is positioned
        right after the 4 extension_type bits; exactly cnt*8-4 bits are
        consumed (ff_decode_sbr_extension aacsbr.c:1059)."""
        end = gb.bits_read() + cnt * 8 - 4
        self.reset = False
        if not self.sample_rate:
            self.sample_rate = 2 * core_rate
        if crc:
            gb.skip_bits(10)
        self.kx[0] = self.kx[1]
        self.m[0] = self.m[1]
        self.kx_and_m_pushed = True
        if gb.get_bits(1):
            self._read_header(gb)
        if self.reset:
            try:
                self._make_f_master()
                self._make_f_derived()
            except AVError:
                self._turnoff()
        if self.start:
            self._read_data(gb, is_cpe)
        if gb.bits_read() > end:
            self._turnoff()
        gb.skip_bits(end - gb.bits_read())

    # -- DSP chain ------------------------------------------------------

    def _dequant(self, is_cpe):
        """aacsbr.c:1106 — in-place quantized -> linear (the [0] rows
        were already saved in quantized form at read time)."""
        if is_cpe and self.bs_coupling:
            d0, d1 = self.data
            alpha = 1.0 if d0.bs_amp_res else 0.5
            pan_offset = 12.0 if d0.bs_amp_res else 24.0
            for e in range(1, d0.bs_num_env + 1):
                nn = self.n[d0.bs_freq_res[e]]
                t1 = np.exp2(d0.env_facs[e][:nn] * alpha + 7.0)
                t2 = np.exp2((pan_offset - d1.env_facs[e][:nn]) * alpha)
                fac = t1 / (1.0 + t2)
                d0.env_facs[e][:nn] = fac
                d1.env_facs[e][:nn] = fac * t2
            for e in range(1, d0.bs_num_noise + 1):
                t1 = np.exp2(NOISE_FLOOR_OFFSET -
                             d0.noise_facs[e][:self.n_q] + 1)
                t2 = np.exp2(12 - d1.noise_facs[e][:self.n_q])
                fac = t1 / (1.0 + t2)
                d0.noise_facs[e][:self.n_q] = fac
                d1.noise_facs[e][:self.n_q] = fac * t2
        else:
            for ch in range((1 if not is_cpe else 2)):
                cd = self.data[ch]
                alpha = 1.0 if cd.bs_amp_res else 0.5
                for e in range(1, cd.bs_num_env + 1):
                    nn = self.n[cd.bs_freq_res[e]]
                    cd.env_facs[e][:nn] = np.exp2(
                        alpha * cd.env_facs[e][:nn] + 6.0)
                for e in range(1, cd.bs_num_noise + 1):
                    cd.noise_facs[e][:self.n_q] = np.exp2(
                        NOISE_FLOOR_OFFSET - cd.noise_facs[e][:self.n_q])

    def _qmf_analysis(self, cd, pcm):
        """aacsbr.c:1153 — all 32 slots as one windowed-fold + matmul."""
        A, _, win_ds = _mats()
        x = cd.x_ana
        x[:288] = x[1024:]
        x[288:] = pcm
        # R[i, n] = x[32 i + n], n = 0..319
        idx = 32 * np.arange(32)[:, None] + np.arange(320)[None, :]
        z = x[idx][:, ::-1] * win_ds[None, :]          # vector_fmul_reverse
        u = z.reshape(32, 5, 64).sum(axis=1)           # sum64x5
        W = u @ A.T                                    # (32 slots, 32 bands)
        cd.W[cd.Ypos] = W

    def _lf_gen(self, cd):
        """aacsbr.c:1301 — X_low[k][i] over 40 slots (8 history)."""
        X_low = np.zeros((32, 40), dtype=np.complex128)
        kx1 = self.kx[1]
        X_low[:kx1, 8:40] = cd.W[cd.Ypos].T[:kx1]
        kx0 = self.kx[0]
        X_low[:kx0, 0:8] = cd.W[1 - cd.Ypos].T[:kx0, 24:32]
        return X_low

    def _hf_inverse_filter(self, X_low):
        """sbrdsp.c sbr_autocorrelate_c + aacsbr.c:1225."""
        k0 = self.k[0]
        x = X_low[:k0]                                  # (k0, 40)
        lo = x[:, 0:38]
        hi = x[:, 1:39]
        r01_lo = np.sum(lo.conj() * hi, axis=1)         # phi[1][1]
        r01_hi = np.sum(x[:, 1:38].conj() * x[:, 2:39], axis=1) \
            + x[:, 38].conj() * x[:, 39]                # phi[0][0]
        r02 = np.sum(x[:, 0:38].conj() * x[:, 2:40], axis=1)  # phi[0][1]
        e_lo = np.sum(np.abs(x[:, 0:38]) ** 2, axis=1)  # phi[2][1][0]
        e_hi = np.sum(np.abs(x[:, 1:39]) ** 2, axis=1)  # phi[1][0][0]
        dk = e_lo * e_hi - np.abs(r01_lo) ** 2 / 1.000001
        alpha1 = np.zeros(k0, dtype=np.complex128)
        nz = dk != 0
        alpha1[nz] = (r01_hi[nz] * r01_lo[nz] - r02[nz] * e_hi[nz]) / dk[nz]
        alpha0 = np.zeros(k0, dtype=np.complex128)
        nz = e_hi != 0
        alpha0[nz] = -(r01_hi[nz] + alpha1[nz] * r01_lo[nz].conj()) \
            / e_hi[nz]
        bad = (np.abs(alpha1) ** 2 >= 16.0) | (np.abs(alpha0) ** 2 >= 16.0)
        alpha0[bad] = 0
        alpha1[bad] = 0
        return alpha0, alpha1

    def _chirp(self, cd):
        """aacsbr.c:1280."""
        bw_tab = (0.0, 0.75, 0.9, 0.98)
        for i in range(self.n_q):
            if cd.bs_invf_mode[0][i] + cd.bs_invf_mode[1][i] == 1:
                new_bw = 0.6
            else:
                new_bw = bw_tab[cd.bs_invf_mode[0][i]]
            if new_bw < cd.bw_array[i]:
                new_bw = 0.75 * new_bw + 0.25 * cd.bw_array[i]
            else:
                new_bw = 0.90625 * new_bw + 0.09375 * cd.bw_array[i]
            cd.bw_array[i] = 0.0 if new_bw < 0.015625 else new_bw

    def _hf_gen(self, cd, X_low, alpha0, alpha1):
        """aacsbr.c:1326 + sbrdsp.c sbr_hf_gen_c."""
        X_high = np.zeros((64, 40), dtype=np.complex128)
        kx1 = self.kx[1]
        k = kx1
        g = 0
        start = 2 * int(cd.t_env[0]) + ENVELOPE_ADJUSTMENT_OFFSET
        end = 2 * int(cd.t_env[cd.bs_num_env]) + ENVELOPE_ADJUSTMENT_OFFSET
        for j in range(self.num_patches):
            for x in range(self.patch_num_subbands[j]):
                p = self.patch_start_subband[j] + x
                while g <= self.n_q and k >= self.f_tablenoise[g]:
                    g += 1
                g -= 1
                if g < 0:
                    raise AVError(INVALIDDATA, "no noise band for subband")
                bw = cd.bw_array[g]
                a0 = alpha0[p] * bw
                a1 = alpha1[p] * bw * bw
                X_high[k, start:end] = (X_low[p, start:end] +
                                        a0 * X_low[p, start - 1:end - 1] +
                                        a1 * X_low[p, start - 2:end - 2])
                k += 1
        return X_high

    def _mapping(self, cd):
        """aacsbr.c:1400 — band-table spreading of env/noise/sinusoids."""
        kx1 = self.kx[1]
        m1 = self.m[1]
        ne = cd.bs_num_env
        e_origmapped = np.zeros((ne, 48))
        q_mapped = np.zeros((ne, 48))
        s_mapped = np.zeros((ne, 48), dtype=np.int64)
        cd.s_indexmapped[1:8] = 0
        for e in range(ne):
            fr = cd.bs_freq_res[e + 1]
            table = self.f_tablehigh if fr else self.f_tablelow
            if kx1 != table[0]:
                raise AVError(INVALIDDATA, "stale SBR frequency tables")
            for i in range(self.n[fr]):
                e_origmapped[e, table[i] - kx1:table[i + 1] - kx1] = \
                    cd.env_facs[e + 1][i]
            kq = int((cd.bs_num_noise > 1) and
                     (cd.t_env[e] >= cd.t_q[1]))
            for i in range(self.n_q):
                q_mapped[e,
                         self.f_tablenoise[i] - kx1:
                         self.f_tablenoise[i + 1] - kx1] = \
                    cd.noise_facs[kq + 1][i]
            for i in range(self.n[1]):
                if cd.bs_add_harmonic_flag:
                    mid = (self.f_tablehigh[i] +
                           self.f_tablehigh[i + 1]) >> 1
                    cd.s_indexmapped[e + 1][mid - kx1] = \
                        cd.bs_add_harmonic[i] * \
                        ((e >= cd.e_a[1]) or
                         (cd.s_indexmapped[0][mid - kx1] == 1))
            for i in range(self.n[1]):
                t0 = self.f_tablehigh[i] - kx1
                t1 = self.f_tablehigh[i + 1] - kx1
                s_mapped[e, t0:t1] = int(
                    np.any(cd.s_indexmapped[e + 1][t0:t1]))
        cd.s_indexmapped[0] = cd.s_indexmapped[ne]
        return e_origmapped[:, :m1], q_mapped[:, :m1], s_mapped[:, :m1]

    def _env_estimate(self, cd, X_high):
        """aacsbr.c:1455."""
        kx1 = self.kx[1]
        m1 = self.m[1]
        ne = cd.bs_num_env
        e_curr = np.zeros((ne, 48))
        if self.bs_interpol_freq:
            for e in range(ne):
                recip = 0.5 / (cd.t_env[e + 1] - cd.t_env[e])
                ilb = int(cd.t_env[e]) * 2 + ENVELOPE_ADJUSTMENT_OFFSET
                iub = int(cd.t_env[e + 1]) * 2 + ENVELOPE_ADJUSTMENT_OFFSET
                seg = X_high[kx1:kx1 + m1, ilb:iub]
                e_curr[e, :m1] = np.sum(np.abs(seg) ** 2, axis=1) * recip
        else:
            for e in range(ne):
                env_size = 2 * (int(cd.t_env[e + 1]) - int(cd.t_env[e]))
                ilb = int(cd.t_env[e]) * 2 + ENVELOPE_ADJUSTMENT_OFFSET
                iub = int(cd.t_env[e + 1]) * 2 + ENVELOPE_ADJUSTMENT_OFFSET
                fr = cd.bs_freq_res[e + 1]
                table = self.f_tablehigh if fr else self.f_tablelow
                for p in range(self.n[fr]):
                    den = env_size * (table[p + 1] - table[p])
                    s = np.sum(np.abs(
                        X_high[table[p]:table[p + 1], ilb:iub]) ** 2) / den
                    e_curr[e, table[p] - kx1:table[p + 1] - kx1] = s
        return e_curr[:, :m1]

    def _gain_calc(self, cd, e_origmapped, q_mapped, s_mapped, e_curr):
        """aacsbr.c:1501 — limiter + boost per limiter band."""
        limgain = (0.70795, 1.0, 1.41254, 1e10)
        kx1 = self.kx[1]
        ne = cd.bs_num_env
        m1 = self.m[1]
        eps = np.finfo(np.float32).eps
        gain = np.zeros((ne, m1))
        q_m = np.zeros((ne, m1))
        s_m = np.zeros((ne, m1))
        for e in range(ne):
            delta = 0 if (e == cd.e_a[1] or e == cd.e_a[0]) else 1
            for k in range(self.n_lim):
                lo = int(self.f_tablelim[k]) - kx1
                hi = int(self.f_tablelim[k + 1]) - kx1
                eo = e_origmapped[e, lo:hi]
                qmap = q_mapped[e, lo:hi]
                ec = e_curr[e, lo:hi]
                smap = s_mapped[e, lo:hi]
                sidx = cd.s_indexmapped[e + 1][lo:hi]
                temp = eo / (1.0 + qmap)
                q_m[e, lo:hi] = np.sqrt(temp * qmap)
                s_m[e, lo:hi] = np.sqrt(temp * sidx)
                g = np.where(
                    smap == 0,
                    np.sqrt(eo / ((1.0 + ec) * (1.0 + qmap * delta))),
                    np.sqrt(eo * qmap / ((1.0 + ec) * (1.0 + qmap))))
                gain[e, lo:hi] = g
                gain_max = limgain[self.bs_limiter_gains] * np.sqrt(
                    (eps + np.sum(eo)) / (eps + np.sum(ec)))
                gain_max = min(100000.0, gain_max)
                qmm = q_m[e, lo:hi] * gain_max / np.maximum(
                    gain[e, lo:hi], 1e-300)
                q_m[e, lo:hi] = np.minimum(q_m[e, lo:hi], qmm)
                gain[e, lo:hi] = np.minimum(gain[e, lo:hi], gain_max)
                sum0 = np.sum(eo)
                sum1 = np.sum(ec * gain[e, lo:hi] ** 2 +
                              s_m[e, lo:hi] ** 2 +
                              (delta * (s_m[e, lo:hi] == 0)) *
                              q_m[e, lo:hi] ** 2)
                boost = min(1.584893192,
                            np.sqrt((eps + sum0) / (eps + sum1)))
                gain[e, lo:hi] *= boost
                q_m[e, lo:hi] *= boost
                s_m[e, lo:hi] *= boost
        return gain, q_m, s_m

    def _hf_assemble(self, cd, X_high, gain, q_m, s_m):
        """aacsbr.c:1557 — gains + noise + sinusoids into Y[Ypos]."""
        h_SL = 4 * (not self.bs_smoothing_mode)
        kx = self.kx[1]
        m_max = self.m[1]
        h_smooth = (0.33333333333333, 0.30150283239582, 0.21816949906249,
                    0.11516383427084, 0.03183050093751)
        phi_t = ((1, 0, -1, 0), (0, 1, 0, -1))
        g_temp, q_temp = cd.g_temp, cd.q_temp
        indexnoise = cd.f_indexnoise
        indexsine = cd.f_indexsine
        Y1 = cd.Y[cd.Ypos]
        if self.reset:
            for i in range(h_SL):
                g_temp[i + 2 * int(cd.t_env[0])][:m_max] = gain[0]
                q_temp[i + 2 * int(cd.t_env[0])][:m_max] = q_m[0]
        elif h_SL:
            for i in range(4):
                g_temp[i + 2 * int(cd.t_env[0])] = \
                    g_temp[i + 2 * cd.t_env_num_env_old]
                q_temp[i + 2 * int(cd.t_env[0])] = \
                    q_temp[i + 2 * cd.t_env_num_env_old]
        for e in range(cd.bs_num_env):
            for i in range(2 * int(cd.t_env[e]), 2 * int(cd.t_env[e + 1])):
                g_temp[h_SL + i][:m_max] = gain[e]
                q_temp[h_SL + i][:m_max] = q_m[e]
        noise_tab = ST.NOISE_TABLE
        for e in range(cd.bs_num_env):
            for i in range(2 * int(cd.t_env[e]), 2 * int(cd.t_env[e + 1])):
                if h_SL and e != cd.e_a[0] and e != cd.e_a[1]:
                    g_filt = np.zeros(m_max)
                    q_filt = np.zeros(m_max)
                    for j in range(h_SL + 1):
                        g_filt += g_temp[i + h_SL - j][:m_max] * h_smooth[j]
                        q_filt += q_temp[i + h_SL - j][:m_max] * h_smooth[j]
                else:
                    g_filt = g_temp[i + h_SL][:m_max]
                    q_filt = q_temp[i][:m_max]
                row = X_high[kx:kx + m_max,
                             i + ENVELOPE_ADJUSTMENT_OFFSET] * g_filt
                sm = s_m[e]
                phi_sign = 1 - 2 * (kx & 1)
                if e != cd.e_a[0] and e != cd.e_a[1]:
                    # sbr_hf_apply_noise_<indexsine> (sbrdsp.c:215)
                    m = np.arange(m_max)
                    nidx = (indexnoise + 1 + m) & 0x1ff
                    use_noise = sm == 0
                    if indexsine == 0:
                        sre, sim = sm, np.zeros(m_max)
                    elif indexsine == 2:
                        sre, sim = -sm, np.zeros(m_max)
                    else:
                        alt = np.where(m % 2 == 0, 1.0, -1.0)
                        sgn = phi_sign if indexsine == 1 else -phi_sign
                        sre = np.zeros(m_max)
                        sim = sm * sgn * alt
                    add = np.where(
                        use_noise,
                        q_filt * (noise_tab[nidx, 0] +
                                  1j * noise_tab[nidx, 1]),
                        sre + 1j * sim)
                else:
                    m = np.arange(m_max)
                    alt = np.where(m % 2 == 0, 1.0, -1.0)
                    add = sm * (phi_t[0][indexsine] +
                                1j * phi_t[1][indexsine] *
                                phi_sign * alt)
                Y1[i, kx:kx + m_max] = row + add
                indexnoise = (indexnoise + m_max) & 0x1ff
                indexsine = (indexsine + 1) & 3
        cd.f_indexnoise = indexnoise
        cd.f_indexsine = indexsine

    def _x_gen(self, cd, X_low):
        """aacsbr.c:1361 — splice low band and adjusted high band."""
        X = np.zeros((38, 64), dtype=np.complex128)
        i_temp = max(2 * cd.t_env_num_env_old - 32, 0)
        Y0 = cd.Y[1 - cd.Ypos]
        Y1 = cd.Y[cd.Ypos]
        kx0, m0 = self.kx[0], self.m[0]
        kx1, m1 = self.kx[1], self.m[1]
        X[0:i_temp, :kx0] = \
            X_low[:kx0, ENVELOPE_ADJUSTMENT_OFFSET:
                  ENVELOPE_ADJUSTMENT_OFFSET + i_temp].T
        X[0:i_temp, kx0:kx0 + m0] = Y0[32:32 + i_temp, kx0:kx0 + m0]
        X[i_temp:38, :kx1] = \
            X_low[:kx1, ENVELOPE_ADJUSTMENT_OFFSET + i_temp:
                  ENVELOPE_ADJUSTMENT_OFFSET + 38].T
        X[i_temp:32, kx1:kx1 + m1] = Y1[i_temp:32, kx1:kx1 + m1]
        return X

    def _qmf_synthesis(self, cd, X):
        """aacsbr.c:1175 upsampled path via the precomputed per-slot
        matrix + 10-tap polyphase windowing."""
        _, S, _ = _mats()
        win = ST.QMF_WINDOW
        out = np.empty(2048)
        vh = cd.v_hist
        for i in range(32):
            xr = np.concatenate([X[i].real, X[i].imag])
            v = S @ xr
            vh = np.roll(vh, 1, axis=0)
            vh[0] = v
            acc = np.zeros(64)
            for p in range(5):
                acc += vh[2 * p][:64] * win[128 * p:128 * p + 64]
                acc += vh[2 * p + 1][64:] * win[128 * p + 64:128 * p + 128]
            out[64 * i:64 * i + 64] = acc
        cd.v_hist = vh
        return out

    def apply(self, pcm_channels):
        """Run the SBR chain on the element's core channels (1024 each,
        nominal +/-1.0 float scale); returns 2048-sample channels
        (ff_sbr_apply aacsbr.c:1652)."""
        nch = len(pcm_channels)
        is_cpe = nch == 2
        if not self.kx_and_m_pushed:
            self.kx[0] = self.kx[1]
            self.m[0] = self.m[1]
        else:
            self.kx_and_m_pushed = False
        if self.start:
            self._dequant(is_cpe)
        out = []
        for ch in range(nch):
            cd = self.data[ch]
            self._qmf_analysis(cd, np.asarray(pcm_channels[ch],
                                              dtype=np.float64))
            X_low = self._lf_gen(cd)
            cd.Ypos ^= 1
            if self.start:
                try:
                    alpha0, alpha1 = self._hf_inverse_filter(X_low)
                    self._chirp(cd)
                    X_high = self._hf_gen(cd, X_low, alpha0, alpha1)
                    e_orig, q_map, s_map = self._mapping(cd)
                    e_curr = self._env_estimate(cd, X_high)
                    gain, q_m, s_m = self._gain_calc(cd, e_orig, q_map,
                                                     s_map, e_curr)
                    self._hf_assemble(cd, X_high, gain, q_m, s_m)
                except AVError:
                    self._turnoff()
            X = self._x_gen(cd, X_low)
            if nch == 1 and self.ps is not None:
                # HE-AACv2: mono -> stereo through parametric stereo
                # (ff_sbr_apply ps branch); the second SBRChannel holds
                # the right channel's synthesis state
                if self.ps.start:
                    L, R = self.ps.apply(X, self.kx[1] + self.m[1])
                else:
                    L, R = X, X.copy()
                return [self._qmf_synthesis(self.data[0], L),
                        self._qmf_synthesis(self.data[1], R)]
            out.append(self._qmf_synthesis(cd, X))
        return out


def _make_bands(start, stop, num_bands):
    """aacsbr.c:286 make_bands — float32 semantics like the reference."""
    base = np.float32(stop / np.float32(start)) ** np.float32(
        1.0 / num_bands)
    prod = np.float32(start)
    previous = start
    bands = []
    for _ in range(num_bands - 1):
        prod = np.float32(prod * base)
        present = int(np.rint(prod))
        bands.append(present - previous)
        previous = present
    bands.append(stop - previous)
    return bands
