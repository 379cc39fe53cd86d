"""AAC-LC decoder (reference: aacdec.c aac_decode_frame :2967 ->
decode_ics :1861 -> imdct_and_windowing :2409).

Counterpart of `libav_tpu/codecs/aac/dec.py`, copied: the bitstream,
spectral tools, windowing, overlap-add, SBR and PS run on the host; the
IMDCT of each channel and frame (`_imdct_channel`) is the port's
`ops/fftmdct.imdct`, a float32 matrix product on the decoder's device.
Its sums round apart from XLA's by a few float32 ulps (ROADMAP.md §3)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from libav_tpu_torch.avutil import hwdevice, log
from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.avutil.samplefmt import default_channel_layout
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec
from libav_tpu_torch.codecs.aac import tables as T

# syntax element ids
SCE, CPE, CCE, LFE, DSE, PCE, FIL, END = range(8)

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = range(4)
SF_OFFSET = 100


def parse_adts_header(data: bytes):
    """Returns (sample_rate, channels, frame_len, header_len, aot) or
    None.  aot = profile + 1 (reference adts_header.c:60)."""
    if len(data) < 7 or data[0] != 0xFF or (data[1] & 0xF0) != 0xF0:
        return None
    gb = GetBits(data)
    gb.skip_bits(12)
    gb.get_bits(1)           # id
    gb.get_bits(2)           # layer
    protection_absent = gb.get_bits(1)
    profile = gb.get_bits(2)
    sr_index = gb.get_bits(4)
    gb.get_bits(1)           # private
    ch_config = gb.get_bits(3)
    gb.get_bits(4)           # orig/home/copyright x2
    frame_len = gb.get_bits(13)
    gb.get_bits(11)          # buffer fullness
    gb.get_bits(2)           # num raw blocks - 1
    hdr = 7 if protection_absent else 9
    if sr_index >= len(T.SAMPLE_RATES):
        return None
    return (T.SAMPLE_RATES[sr_index], ch_config, frame_len, hdr,
            profile + 1)


def _decode_spectrum(gb, cb, count):
    """count quantized coefficients from codebook cb."""
    vlc = T.spectral_vlc(cb)
    unpack = T.unpack_index(cb)
    dim, signed, _ = T.CB_INFO[cb]
    out = np.zeros(count, dtype=np.int32)
    k = 0
    while k < count:
        idx = vlc.read(gb)
        vals = list(unpack(idx))
        if not signed:
            for i, v in enumerate(vals):
                if v != 0 and gb.get_bits(1):
                    vals[i] = -v
        if cb == T.ESC_HCB:
            for i, v in enumerate(vals):
                if abs(v) == 16:
                    n = 4
                    while gb.get_bits(1):
                        n += 1
                    esc = gb.get_bits(n)
                    mag = (1 << n) + esc
                    vals[i] = mag if v > 0 else -mag
        out[k:k + dim] = vals
        k += dim
    return out


# LTP coefficient codebook (reference aacdectab.h:41)
LTP_COEF = [0.570829, 0.696616, 0.813004, 0.911304,
            0.984900, 1.067894, 1.194601, 1.369533]
MAX_LTP_LONG_SFB = 40


def decode_ltp(gb: GetBits, max_sfb: int) -> tuple:
    """ltp_data() (reference aacdec.c:1156 decode_ltp):
    (lag, coef, used[sfb]) for long windows."""
    lag = gb.get_bits(11)
    coef = LTP_COEF[gb.get_bits(3)]
    used = [gb.get_bits(1) for _ in range(min(max_sfb,
                                              MAX_LTP_LONG_SFB))]
    return (lag, coef, used)


def read_ics_info(gb: GetBits, sample_rate: int, aot: int = 2) -> dict:
    """ics_info() (reference: aacdec.c decode_ics_info) -> dict shared
    by both channels of a common_window CPE."""
    gb.get_bits(1)           # ics_reserved
    window_sequence = gb.get_bits(2)
    window_shape = gb.get_bits(1)
    ltp = None
    pred_present = False
    if window_sequence == EIGHT_SHORT:
        max_sfb = gb.get_bits(4)
        grouping = gb.get_bits(7)
        group_len = [1]
        for i in range(7):
            if grouping & (1 << (6 - i)):
                group_len[-1] += 1
            else:
                group_len.append(1)
        offsets = T.swb_offsets_short(sample_rate)
        sect_bits, sect_esc = 3, 7
    else:
        max_sfb = gb.get_bits(6)
        if gb.get_bits(1):   # predictor_data_present
            pred_present = True
            if aot == 4:     # AOT_AAC_LTP (reference aacdec.c:1252)
                if gb.get_bits(1):
                    ltp = decode_ltp(gb, max_sfb)
            else:
                raise AVError(INVALIDDATA,
                              "main-profile prediction unsupported")
        group_len = [1]
        offsets = T.swb_offsets_long(sample_rate)
        sect_bits, sect_esc = 5, 31
    if max_sfb > len(offsets) - 1:
        raise AVError(INVALIDDATA, "max_sfb too large")
    return dict(seq=window_sequence, shape=window_shape, max_sfb=max_sfb,
                group_len=group_len, offsets=offsets,
                sect_bits=sect_bits, sect_esc=sect_esc,
                ltp=ltp, pred_present=pred_present)


def _ltp_windows(seq: int, shape: int, prev_shape: int):
    """The 2048-sample analysis window for LTP's forward MDCT
    (reference aacdec.c windowing_and_mdct_ltp): left half by the
    PREVIOUS window shape, right half by the current, with the
    start/stop shapes collapsing to flat+short segments."""
    from libav_tpu_torch.ops import fftmdct as F

    def lw(sh):
        return F.kbd_window(2048) if sh else F.sine_window(2048)

    def sw(sh):
        return F.kbd_window(256, alpha=6.0) if sh else F.sine_window(256)

    if seq == LONG_STOP:
        left = np.concatenate([np.zeros(448), sw(prev_shape)[:128],
                               np.ones(448)])
    else:
        left = lw(prev_shape)[:1024]
    if seq == LONG_START:
        right = np.concatenate([np.ones(448), sw(shape)[128:],
                                np.zeros(448)])
    else:
        right = lw(shape)[1024:]
    return np.concatenate([left, right])


def ltp_predict(state: np.ndarray, ltp: tuple, seq: int, shape: int,
                prev_shape: int) -> np.ndarray:
    """Predicted spectrum from the 3072-sample LTP state (reference
    aacdec.c:2342 apply_ltp): lagged+scaled history, windowed, forward
    MDCT back to 1024 spectral lines in the decoder's spec units
    (mdct_ref/1024 is the exact inverse of our imdct chain)."""
    from libav_tpu_torch.ops import fftmdct as F
    lag, coef, _used = ltp
    num = min(2048, lag + 1024)
    pt = np.zeros(2048)
    pt[:num] = state[2048 - lag:2048 - lag + num] * coef
    pt *= _ltp_windows(seq, shape, prev_shape)
    return F.mdct_ref(pt) / 1024.0


def ltp_update(state: np.ndarray, out: np.ndarray,
               overlap: np.ndarray) -> np.ndarray:
    """Roll the LTP state (reference aacdec.c:2374 update_ltp): [t-1
    output, t output, t's windowed aliasing extension].  With our
    full-2048 IMDCT the reference's per-window-sequence saved_ltp
    reconstruction is identically the new overlap buffer (the IMDCT
    half-output symmetries fold its buf_mdct expressions into
    comp[1024:2048])."""
    return np.concatenate([state[1024:2048], out, overlap])


def _decode_tns(gb: GetBits, is_short: bool) -> list:
    """tns_data (spec 4.4.2.7; reference aacdec.c decode_tns): per
    window a list of (length, order, direction, coef_res, raw_coefs,
    coef_compress)."""
    n_windows = 8 if is_short else 1
    nf_bits, len_bits, ord_bits = (1, 4, 3) if is_short else (2, 6, 5)
    out = []
    for w in range(n_windows):
        filters = []
        n_filt = gb.get_bits(nf_bits)
        coef_res = gb.get_bits(1) if n_filt else 0
        for _ in range(n_filt):
            length = gb.get_bits(len_bits)
            order = gb.get_bits(ord_bits)
            direction = compress = 0
            coefs = []
            if order:
                direction = gb.get_bits(1)
                compress = gb.get_bits(1)
                coef_len = coef_res + 3 - compress
                coefs = [gb.get_bits(coef_len) for _ in range(order)]
            filters.append((length, order, direction, coef_res,
                            compress, coefs))
        out.append(filters)
    return out


def _apply_tns(spec, tns, info, sample_rate, decode=True):
    """All-pole (decode) / all-zero (encode) TNS filtering over the
    flattened window spectra (spec 4.6.9.3; reference aacdec.c
    apply_tns)."""
    offsets = info["offsets"]
    max_sfb = info["max_sfb"]
    is_short = spec.ndim == 2
    sri = T.sample_rate_index(sample_rate)
    max_bands = (T.TNS_MAX_BANDS_128 if is_short
                 else T.TNS_MAX_BANDS_1024)[sri]
    mmm = min(max_bands, max_sfb)
    nb = len(offsets) - 1
    for w, filters in enumerate(tns):
        buf = spec[w] if is_short else spec
        top = nb
        for (length, order, direction, coef_res, compress,
             raw) in filters:
            bottom = max(0, top - length)
            if order == 0:
                top = bottom
                continue
            dq = T.tns_dequant_table(compress, coef_res)
            lpc = T.tns_lpc([dq[c] for c in raw])
            start = int(offsets[min(bottom, mmm)])
            end = int(offsets[min(top, mmm)])
            top = bottom
            size = end - start
            if size <= 0:
                continue
            inc = -1 if direction else 1
            if direction:
                start = end - 1
            if decode:          # AR (the decoder inverts the filter)
                for m in range(size):
                    s = start + m * inc
                    for i in range(1, min(m, order) + 1):
                        buf[s] -= buf[s - i * inc] * lpc[i - 1]
            else:               # MA (encoder forward filter)
                src = buf.copy()
                for m in range(size):
                    s = start + m * inc
                    for i in range(1, min(m, order) + 1):
                        buf[s] += src[s - i * inc] * lpc[i - 1]
    return spec


def _finish_ics(ics, sample_rate):
    """Post-stereo per-channel tools (TNS; spec tool order 4.6:
    M/S and intensity before TNS) -> (seq, shape, spec) as the IMDCT
    stage expects."""
    seq, shape, spec, tns, info, _cb, _is, _ltp = ics
    if tns is not None:
        _apply_tns(spec, tns, info, sample_rate)
    return seq, shape, spec


def _apply_intensity(s0, s1, ms_mask, info):
    """Intensity stereo: right channel bands coded INTENSITY_HCB(2)
    reuse the left spectrum scaled by 2^(-pos/4), sign from the
    codebook (in/out of phase) further flipped by an M/S mask bit
    (reference aacdec.c apply_intensity_stereo :1969)."""
    band_cb, is_pos = s1[5], s1[6]
    spec0, spec1 = s0[2], s1[2]
    offsets = info["offsets"]
    group_len = info["group_len"]
    wstart = 0
    for g, L in enumerate(group_len):
        for b in range(info["max_sfb"]):
            cb = int(band_cb[g, b])
            if cb not in (T.INTENSITY_HCB, T.INTENSITY_HCB2):
                continue
            c = -1 + 2 * (cb - 14)       # HCB2(14) -> -1, HCB(15) -> +1
            if ms_mask is not None:
                c *= 1 - 2 * int(ms_mask[g, b])
            scale = c * 2.0 ** (-0.25 * is_pos[g, b])
            a, e = int(offsets[b]), int(offsets[b + 1])
            if info["seq"] == EIGHT_SHORT:
                for w in range(L):
                    spec1[wstart + w, a:e] = spec0[wstart + w, a:e] * scale
            else:
                spec1[a:e] = spec0[a:e] * scale
        wstart += L


def _lcg(state: int) -> int:
    """reference aacdec.c:954 lcg_random (int32 wraparound)."""
    v = (state * 1664525 + 1013904223) & 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def _noise_fill(vals, rng, energy_gain):
    """PNS band synthesis (reference aacdec.c:1580): raw LCG int32
    samples normalized to the signalled energy — float32 arithmetic and
    serial energy accumulation mirror the reference exactly."""
    n = len(vals)
    e = np.float32(0.0)
    raw = np.empty(n, dtype=np.float32)
    s = rng[0]
    for k in range(n):
        s = _lcg(s)
        f = np.float32(s)
        raw[k] = f
        e = np.float32(e + np.float32(f * f))
    rng[0] = s
    scale = np.float32(np.float32(energy_gain) / np.float32(np.sqrt(e)))
    return (raw * scale).astype(np.float64)


def decode_ics(gb: GetBits, sample_rate: int, info: dict = None,
               rng=None, aot: int = 2, ltp="inherit"):
    """One individual_channel_stream (reference: aacdec.c decode_ics
    :1861). Returns (window_sequence, window_shape, spec) where spec is
    (1024,) for long sequences or (8, 128) for EIGHT_SHORT. `info` is
    the shared ics_info of a common_window CPE (skips the inline one)."""
    global_gain = gb.get_bits(8)
    if rng is None:
        rng = [0x1F2E3D4C]
    if info is None:
        info = read_ics_info(gb, sample_rate, aot)
    if ltp == "inherit":
        ltp = info.get("ltp")
    window_sequence = info["seq"]
    window_shape = info["shape"]
    max_sfb = info["max_sfb"]
    group_len = info["group_len"]
    offsets = info["offsets"]
    sect_bits, sect_esc = info["sect_bits"], info["sect_esc"]
    num_groups = len(group_len)

    # section_data (sections never span group boundaries)
    band_cb = np.zeros((num_groups, max_sfb), dtype=np.int32)
    for g in range(num_groups):
        k = 0
        while k < max_sfb:
            cb = gb.get_bits(4)
            sect_len = 0
            while True:
                incr = gb.get_bits(sect_bits)
                sect_len += incr
                if incr != sect_esc:
                    break
            if k + sect_len > max_sfb:
                raise AVError(INVALIDDATA, "section overflow")
            band_cb[g, k:k + sect_len] = cb
            k += sect_len

    # scale_factor_data (dpcm runs across groups; noise bands keep a
    # separate running offset, reference aacdec.c decode_scalefactors
    # offset[1], first occurrence as 9-bit PCM)
    sf = np.zeros((num_groups, max_sfb), dtype=np.int32)
    noise_gain = np.zeros((num_groups, max_sfb), dtype=np.int32)
    is_pos = np.zeros((num_groups, max_sfb), dtype=np.int32)
    sf_vlc = T.scalefactor_vlc()
    cur = global_gain
    noise_off = global_gain - 90            # NOISE_OFFSET
    is_off = 0                              # intensity positions dpcm
    noise_flag = True
    for g in range(num_groups):
        for b in range(max_sfb):
            cb = band_cb[g, b]
            if cb == T.ZERO_HCB:
                continue
            if cb in (T.INTENSITY_HCB, T.INTENSITY_HCB2):
                # intensity stereo position (reference aacdec.c:1342:
                # dpcm from 0 on its own running offset, clip -155..100)
                is_off += sf_vlc.read(gb) - 60
                is_pos[g, b] = max(-155, min(100, is_off))
                continue
            if cb == T.NOISE_HCB:
                if noise_flag:
                    noise_flag = False
                    noise_off += gb.get_bits(9) - 256
                else:
                    noise_off += sf_vlc.read(gb) - 60
                noise_gain[g, b] = max(-100, min(155, noise_off))
                continue
            cur += sf_vlc.read(gb) - 60
            sf[g, b] = cur

    # pulse / tns / gain control
    pulse = None
    if gb.get_bits(1):
        # pulse_data (spec table 4.7; reference aacdec.c decode_pulses)
        if window_sequence == EIGHT_SHORT:
            raise AVError(INVALIDDATA, "pulse in eight-short sequence")
        num_pulse = gb.get_bits(2) + 1
        pulse_swb = gb.get_bits(6)
        if pulse_swb >= len(offsets) - 1:
            raise AVError(INVALIDDATA, "pulse swb out of range")
        pos = int(offsets[pulse_swb]) + gb.get_bits(5)
        pulse = []
        for i in range(num_pulse):
            if i:
                pos += gb.get_bits(5)
            if pos > 1023:
                raise AVError(INVALIDDATA, "pulse position out of range")
            pulse.append((pos, gb.get_bits(4)))
    tns = None
    if gb.get_bits(1):
        tns = _decode_tns(gb, window_sequence == EIGHT_SHORT)
    if gb.get_bits(1):
        raise AVError(INVALIDDATA, "gain control not supported")

    # spectral_data: groups -> sfb -> windows-in-group -> coefficients
    if window_sequence == EIGHT_SHORT:
        spec = np.zeros((8, 128), dtype=np.float64)
        wstart = 0
        for g in range(num_groups):
            L = group_len[g]
            for b in range(max_sfb):
                cb = int(band_cb[g, b])
                s0, e0 = int(offsets[b]), int(offsets[b + 1])
                width = e0 - s0
                if cb == T.ZERO_HCB or cb >= T.INTENSITY_HCB2:
                    continue     # zero/intensity bands carry no data
                if cb == T.NOISE_HCB:
                    # negative: the reference carries sf = -pow2sf for
                    # noise (aacdec.c:1368) and our unit convention is
                    # the global negation of its pipeline
                    eg = -(2.0 ** (0.25 * noise_gain[g, b] - 26.0))
                    for w in range(L):
                        spec[wstart + w, s0:e0] = _noise_fill(
                            np.empty(width), rng, eg)
                    continue
                q = _decode_spectrum(gb, cb, L * width).astype(np.float64)
                # -26: PCM fullscale convention (1/32768 output scale x
                # IMDCT normalization), matching the reference decoder's
                # absolute level (aacdec.c pow2sf_tab offset)
                gain = 2.0 ** (0.25 * (sf[g, b] - SF_OFFSET) - 26.0)
                vals = np.sign(q) * np.abs(q) ** (4.0 / 3.0) * gain
                vals = vals.reshape(L, width)
                for w in range(L):
                    spec[wstart + w, s0:e0] = vals[w]
            wstart += L
        return (window_sequence, window_shape, spec, tns, info, band_cb,
                is_pos, ltp)

    quant = np.zeros(1024, dtype=np.int32)
    noise_vals = {}
    for b in range(max_sfb):
        cb = int(band_cb[0, b])
        if cb == T.ZERO_HCB or cb >= T.INTENSITY_HCB2:
            continue             # zero/intensity bands carry no data
        s0, e0 = int(offsets[b]), int(offsets[b + 1])
        if cb == T.NOISE_HCB:
            eg = -(2.0 ** (0.25 * noise_gain[0, b] - 26.0))
            noise_vals[b] = _noise_fill(np.empty(e0 - s0), rng, eg)
            continue
        quant[s0:e0] = _decode_spectrum(gb, cb, e0 - s0)

    # inverse quantization: x = sign(q)*|q|^(4/3) * 2^(0.25*(sf-offset))
    q = quant.astype(np.float64)
    mag = np.abs(q) ** (4.0 / 3.0)
    gains = np.zeros(1024)
    for b in range(max_sfb):
        if band_cb[0, b] != T.ZERO_HCB:
            gains[offsets[b]:offsets[b + 1]] = \
                2.0 ** (0.25 * (sf[0, b] - SF_OFFSET) - 26.0)
    spec_out = np.sign(q) * mag * gains
    for b, v in noise_vals.items():
        spec_out[int(offsets[b]):int(offsets[b + 1])] = v
    if pulse is not None:
        # add pulse amplitudes in the quantized domain (reference
        # aacdec.c decode_spectrum_and_dequant pulse tail): reconstruct
        # q from the dequantized value, grow |q| by amp, requantize
        for pos, amp in pulse:
            b = int(np.searchsorted(offsets, pos, side="right")) - 1
            if band_cb[0, b] == T.NOISE_HCB or gains[pos] == 0:
                continue
            co = spec_out[pos] / gains[pos]      # = sign(q)*|q|^(4/3)
            if co:
                qv = co / np.sqrt(np.sqrt(abs(co)))   # back to q
                ico = qv + (amp if qv > 0 else -amp)
            else:
                ico = -float(amp)
            spec_out[pos] = np.cbrt(abs(ico)) * ico * gains[pos]
    return (window_sequence, window_shape, spec_out,
            tns, info, band_cb, is_pos, ltp)


def _apply_mid_side(mid, side, mask, info):
    """In-place M/S -> L/R on dequantized spectra (spec 4.6.8.1.1:
    l = m + s, r = m - s per masked band)."""
    offsets = info["offsets"]
    group_len = info["group_len"]
    wstart = 0
    for g, L in enumerate(group_len):
        for b in range(info["max_sfb"]):
            if not mask[g, b]:
                continue
            s0, e0 = int(offsets[b]), int(offsets[b + 1])
            if info["seq"] == EIGHT_SHORT:
                for w in range(L):
                    m = mid[wstart + w, s0:e0].copy()
                    sd = side[wstart + w, s0:e0].copy()
                    mid[wstart + w, s0:e0] = m + sd
                    side[wstart + w, s0:e0] = m - sd
            else:
                m = mid[s0:e0].copy()
                sd = side[s0:e0].copy()
                mid[s0:e0] = m + sd
                side[s0:e0] = m - sd
        wstart += L


@register_codec
class AACDecoder(Decoder):
    NAME = "aac"
    TYPE = MediaType.AUDIO
    LONG_NAME = "AAC-LC (PyTorch device IMDCT)"

    def __init__(self, params=None, options=None, *, device):
        """AACDecoder(params, options, device=...): the IMDCT runs on
        `device`; the output frames' float planes are numpy on the
        host."""
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        self._overlap = None
        self._prev_shape = []
        self._aot = 2
        self._ltp_state = None       # (nch, 3072) float64
        self.ltp_frames = 0          # streams stats (test visibility)
        # PNS noise generator state (reference aacdec.c:1101
        # random_state init; persists across frames)
        self._rng = [0x1F2E3D4C]
        # SBR contexts keyed by element ordinal within the frame
        # (reference: per-ChannelElement SpectralBandReplication)
        self._sbr = {}

    def _flush(self):
        self._overlap = None
        self._prev_shape = []
        self._sbr = {}
        self._ltp_state = None

    def _decode(self, pkt: Packet) -> List[Frame]:
        data = pkt.data
        hdr = parse_adts_header(data)
        if hdr is not None:
            sample_rate, ch_config, frame_len, hlen, self._aot = hdr
            body = data[hlen:frame_len]
        else:
            sample_rate = self.sample_rate or 44100
            body = data
        gb = GetBits(body)
        specs = []
        elements = []        # (is_cpe, first_channel_index) per SCE/CPE
        while True:
            ele = gb.get_bits(3)
            if ele == END:
                break
            tag_bits = gb.get_bits(4)  # element_instance_tag
            if ele == SCE:
                elements.append((False, len(specs)))
                specs.append(self._ltp_finish(
                    decode_ics(gb, sample_rate, rng=self._rng,
                               aot=self._aot),
                    sample_rate, len(specs)))
            elif ele == CPE:
                elements.append((True, len(specs)))
                common = gb.get_bits(1)
                if common:
                    # shared ics_info + mid/side stereo (reference:
                    # aacdec.c decode_cpe :2020 + decode_mid_side_stereo)
                    info = read_ics_info(gb, sample_rate, self._aot)
                    # second channel's own LTP rides between ics_info
                    # and ms_present (reference aacdec.c:2023-2026)
                    ltp1 = None
                    if info.get("pred_present"):
                        if gb.get_bits(1):
                            ltp1 = decode_ltp(gb, info["max_sfb"])
                    ms_present = gb.get_bits(2)
                    if ms_present == 3:
                        raise AVError(INVALIDDATA, "ms_present=3 reserved")
                    ng = len(info["group_len"])
                    if ms_present == 1:
                        mask = np.array([gb.get_bits(1)
                                         for _ in range(ng *
                                                        info["max_sfb"])],
                                        dtype=bool).reshape(ng,
                                                            info["max_sfb"])
                    elif ms_present == 2:
                        mask = np.ones((ng, info["max_sfb"]), dtype=bool)
                    else:
                        mask = None
                    s0 = decode_ics(gb, sample_rate, info,
                                    rng=self._rng, aot=self._aot)
                    s1 = decode_ics(gb, sample_rate, info,
                                    rng=self._rng, aot=self._aot,
                                    ltp=ltp1)
                    if mask is not None:
                        # M/S never applies to noise bands (reference
                        # aacdec.c:1948)
                        ok = (s0[5] < T.NOISE_HCB) & (s1[5] < T.NOISE_HCB)
                        _apply_mid_side(s0[2], s1[2], mask & ok, info)
                    _apply_intensity(s0, s1, mask, info)
                    specs.append(self._ltp_finish(s0, sample_rate,
                                                  len(specs)))
                    specs.append(self._ltp_finish(s1, sample_rate,
                                                  len(specs)))
                else:
                    s0 = decode_ics(gb, sample_rate, rng=self._rng,
                                    aot=self._aot)
                    s1 = decode_ics(gb, sample_rate, rng=self._rng,
                                    aot=self._aot)
                    # the reference applies ch1 LTP only when ch0's ics
                    # carried predictor data (aacdec.c:2668-2673)
                    if not s0[4].get("pred_present"):
                        s1 = s1[:7] + (None,)
                    _apply_intensity(s0, s1, None, s1[4])
                    specs.append(self._ltp_finish(s0, sample_rate,
                                                  len(specs)))
                    specs.append(self._ltp_finish(s1, sample_rate,
                                                  len(specs)))
            elif ele == FIL:
                cnt = tag_bits
                if cnt == 15:
                    cnt += gb.get_bits(8) - 1
                if cnt > 0:
                    # extension_payload (reference aacdec.c
                    # decode_extension_payload): SBR extends the
                    # immediately preceding SCE/CPE
                    ext_type = gb.get_bits(4)
                    if ext_type in (13, 14) and elements:   # EXT_SBR_DATA
                        from libav_tpu_torch.codecs.aac.sbr import SBRContext
                        idx = len(elements) - 1
                        ctx = self._sbr.get(idx)
                        if ctx is None:
                            ctx = self._sbr[idx] = SBRContext()
                        ctx.decode_extension(gb, ext_type == 14, cnt,
                                             elements[idx][0], sample_rate)
                    else:
                        gb.skip_bits(8 * cnt - 4)
            elif ele == DSE:
                gb.get_bits(1)
                cnt = gb.get_bits(8)
                if cnt == 255:
                    cnt += gb.get_bits(8)
                gb.skip_bits(8 * cnt)
            else:
                raise AVError(INVALIDDATA, f"element {ele} not supported")
            if gb.bits_left() < 3:
                break
        if not specs:
            return []
        nch = len(specs)
        if self._overlap is None or self._overlap.shape[0] != nch:
            self._overlap = np.zeros((nch, 1024), dtype=np.float64)
            self._prev_shape = [0] * nch
        pcm = [self._imdct_channel(c, *specs[c]) for c in range(nch)]
        out_rate, out_samples = sample_rate, 1024
        if self._sbr:
            # HE-AAC: run SBR per element (pure upsampling mode for any
            # element without its own SBR data, like sbr_turnoff)
            from libav_tpu_torch.codecs.aac.sbr import SBRContext
            out = []
            for idx, (is_cpe, ch0) in enumerate(elements):
                ctx = self._sbr.get(idx)
                if ctx is None:
                    ctx = self._sbr[idx] = SBRContext()
                chans = pcm[ch0:ch0 + (2 if is_cpe else 1)]
                out.extend(ctx.apply(chans))
            pcm = out
            nch = len(pcm)       # PS upmixes mono elements to stereo
            out_rate, out_samples = sample_rate * 2, 2048
        f = Frame(nb_samples=out_samples, sample_rate=out_rate,
                  format="fltp", channels=nch,
                  channel_layout=default_channel_layout(nch))
        f.planes = [p.astype(np.float32) for p in pcm]
        f.pts = pkt.pts
        f.time_base = pkt.time_base
        return [f]

    def _ltp_finish(self, ics, sample_rate: int, ch: int):
        """apply_ltp (reference aacdec.c:2342) before the TNS decode in
        _finish_ics — LTP's prediction gets TNS ANALYSIS filtering, the
        summed spectrum gets the synthesis filter."""
        seq, shape, spec, tns, info, _cb, _is, ltp = ics
        if self._aot == 4 and ltp is not None and seq != EIGHT_SHORT \
                and self._ltp_state is not None \
                and ch < self._ltp_state.shape[0]:
            prev = self._prev_shape[ch] if ch < len(self._prev_shape) \
                else 0
            pred = ltp_predict(self._ltp_state[ch], ltp, seq, shape,
                               prev)
            if tns is not None:
                _apply_tns(pred, tns, info, sample_rate, decode=False)
            offsets = info["offsets"]
            _lag, _coef, used = ltp
            for sfb, u in enumerate(used):
                if u:
                    a, e = int(offsets[sfb]), int(offsets[sfb + 1])
                    spec[a:e] += pred[a:e]
            self.ltp_frames += 1
        return _finish_ics(ics, sample_rate)

    def _imdct(self, spec: np.ndarray) -> np.ndarray:
        """float32 (B, N) spectra -> float64 (B, 2N): `fftmdct.imdct` on
        the decoder's device, downloaded."""
        from libav_tpu_torch.ops import fftmdct as F
        out = F.imdct(torch.from_numpy(spec).to(self.device))
        return out.cpu().numpy().astype(np.float64)

    def _imdct_channel(self, ch: int, seq: int, shape: int,
                       spec: np.ndarray) -> np.ndarray:
        """IMDCT + window sequence overlap-add (reference: aacdec.c
        imdct_and_windowing :2409 — long/start/short/stop composition;
        the left half of each window uses the previous frame's shape)."""
        from libav_tpu_torch.ops import fftmdct as F

        def lw(sh):
            return F.kbd_window(2048) if sh else F.sine_window(2048)

        def sw(sh):
            return F.kbd_window(256, alpha=6.0) if sh else F.sine_window(256)

        prev = self._prev_shape[ch]
        comp = np.zeros(2048)
        if seq == EIGHT_SHORT:
            # same absolute spectral convention as long blocks (the
            # reference inits both MDCTs with equal 1/(32768*N) style
            # scale): 1024, NOT N_short/2=128
            frames = self._imdct((spec * 1024.0).astype(np.float32))
            for i in range(8):
                w = np.concatenate([sw(prev if i == 0 else shape)[:128],
                                    sw(shape)[128:]])
                comp[448 + 128 * i:448 + 128 * i + 256] += frames[i] * w
        else:
            frame = self._imdct(
                (spec[None, :] * 1024.0).astype(np.float32))[0]
            if seq == LONG_STOP:
                left = np.concatenate([np.zeros(448), sw(prev)[:128],
                                       np.ones(448)])
            else:
                left = lw(prev)[:1024]
            if seq == LONG_START:
                right = np.concatenate([np.ones(448), sw(shape)[128:],
                                        np.zeros(448)])
            else:
                right = lw(shape)[1024:]
            comp = frame * np.concatenate([left, right])
        out = self._overlap[ch] + comp[:1024]
        self._overlap[ch] = comp[1024:]
        self._prev_shape[ch] = shape
        if self._aot == 4:
            if self._ltp_state is None or \
                    ch >= self._ltp_state.shape[0]:
                n = self._overlap.shape[0]
                st = np.zeros((n, 3072), dtype=np.float64)
                if self._ltp_state is not None:
                    st[:self._ltp_state.shape[0]] = self._ltp_state
                self._ltp_state = st
            self._ltp_state[ch] = ltp_update(self._ltp_state[ch], out,
                                             self._overlap[ch])
        return out
