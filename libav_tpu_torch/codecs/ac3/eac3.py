"""E-AC-3 (ATSC A/52B Annex E) decode support: bitstream-info/audio-frame
header parse, AHT (adaptive hybrid transform: GAQ dequant + 6-point
IDCT), spectral extension, and the eac3 band-structure rule.

reference: libavcodec/eac3dec.c (ff_eac3_parse_header,
ff_eac3_decode_transform_coeffs_aht_ch, ff_eac3_apply_spectral_extension)
and the s->eac3 branches of libavcodec/ac3dec.c decode_audio_block.
"""

from __future__ import annotations

import numpy as np

from libav_tpu_torch.avutil.error import AVError, INVALIDDATA, PATCHWELCOME
from libav_tpu_torch.codecs.ac3 import eac3_tables as E
from libav_tpu_torch.codecs.ac3 import tables as T

CPL = -1

FRAME_TYPE_INDEPENDENT = 0
FRAME_TYPE_DEPENDENT = 1
FRAME_TYPE_AC3_CONVERT = 2
FRAME_TYPE_RESERVED = 3

EAC3_BLOCKS = (1, 2, 3, 6)

EXP_REUSE = 0


def parse_frame_info(data: bytes, i: int = 0):
    """Minimal header probe at a 0x0B77 sync position: returns dict with
    frame_bytes / sample_rate / channels / num_blocks / bsid / eac3, or
    None if the header is invalid or truncated (reference:
    ac3_parser.c ff_ac3_parse_header)."""
    if i + 8 > len(data) or data[i:i + 2] != b"\x0b\x77":
        return None
    bsid = data[i + 5] >> 3
    if bsid > 16:
        return None
    if bsid <= 10:
        fscod = data[i + 4] >> 6
        frmsizecod = data[i + 4] & 0x3F
        if fscod == 3 or frmsizecod >= 38:
            return None
        sr_shift = max(bsid - 8, 0)
        acmod = data[i + 6] >> 5
        # lfeon follows acmod and acmod-dependent mix level fields
        bits = (data[i + 6] << 8) | data[i + 7]
        pos = 3
        if acmod & 1 and acmod != 1:
            pos += 2
        if acmod & 4:
            pos += 2
        if acmod == 2:
            pos += 2
        lfeon = (bits >> (15 - pos)) & 1
        return dict(frame_bytes=int(T.FRAME_SIZE[frmsizecod][fscod]) * 2,
                    sample_rate=int(T.SAMPLE_RATES[fscod]) >> sr_shift,
                    channels=int(T.CHANNELS[acmod]) + lfeon,
                    num_blocks=6, bsid=bsid, eac3=False, acmod=acmod)
    # E-AC-3: strmtyp(2) substreamid(3) frmsiz(11) fscod(2)
    # [fscod2|numblkscod](2) acmod(3) lfeon(1) bsid(5)
    v = int.from_bytes(data[i + 2:i + 6], "big")
    frame_type = v >> 30
    if frame_type == FRAME_TYPE_RESERVED:
        return None
    frame_bytes = (((v >> 16) & 0x7FF) + 1) * 2
    fscod = (v >> 14) & 3
    if fscod == 3:
        fscod2 = (v >> 12) & 3
        if fscod2 == 3:
            return None
        sample_rate = int(T.SAMPLE_RATES[fscod2]) // 2
        num_blocks = 6
    else:
        sample_rate = int(T.SAMPLE_RATES[fscod])
        num_blocks = EAC3_BLOCKS[(v >> 12) & 3]
    acmod = (v >> 9) & 7
    lfeon = (v >> 8) & 1
    return dict(frame_bytes=frame_bytes, sample_rate=sample_rate,
                channels=int(T.CHANNELS[acmod]) + lfeon,
                num_blocks=num_blocks, bsid=bsid, eac3=True, acmod=acmod,
                frame_type=frame_type, substreamid=(v >> 27) & 7)


def parse_frame_header(gb, acmod, lfeon, num_blocks, frame_type, fscod,
                       nfchans, lfe_ch, frame_bytes):
    """E-AC-3 bitstream info tail + audio frame header (everything after
    the 5-bit bsid; reference: eac3dec.c ff_eac3_parse_header :290).
    Returns the per-frame syntax-state dict ("e")."""
    if fscod == 3:
        raise AVError(PATCHWELCOME, "E-AC-3 reduced sampling rate")

    # volume control params
    for _ in range(2 if acmod == 0 else 1):
        gb.get_bits(5)              # dialnorm
        if gb.get_bits(1):
            gb.get_bits(8)          # compr

    # mixing metadata
    if gb.get_bits(1):
        if acmod > 2:
            gb.get_bits(2)          # preferred downmix
            if acmod & 1:
                gb.get_bits(6)      # ltrt/loro center mix levels
            if acmod & 4:
                gb.get_bits(6)      # ltrt/loro surround mix levels
        if lfeon and gb.get_bits(1):
            gb.get_bits(5)          # lfe mix level
        if frame_type == FRAME_TYPE_INDEPENDENT:
            for _ in range(2 if acmod == 0 else 1):
                if gb.get_bits(1):
                    gb.get_bits(6)  # program scale factor
            if gb.get_bits(1):
                gb.get_bits(6)      # external program scale factor
            mixdef = gb.get_bits(2)
            if mixdef == 1:
                gb.get_bits(5)
            elif mixdef == 2:
                gb.get_bits(12)
            elif mixdef == 3:
                gb.skip_bits((gb.get_bits(5) + 2) * 8)
            if acmod < 2:
                for _ in range(2 if acmod == 0 else 1):
                    if gb.get_bits(1):
                        gb.get_bits(14)   # pan mean + reserved
            if gb.get_bits(1):
                for blk in range(num_blocks):
                    if num_blocks == 1 or gb.get_bits(1):
                        gb.get_bits(5)    # mix config
    # informational metadata
    if gb.get_bits(1):
        gb.get_bits(5)              # bsmod + copyright + original
        if acmod == 2:
            gb.get_bits(4)          # dsurmod + dheadphonmod
        if acmod >= 6:
            gb.get_bits(2)          # dsurexmod
        for _ in range(2 if acmod == 0 else 1):
            if gb.get_bits(1):
                gb.get_bits(8)      # mixlevel + roomtyp + adconvtyp
        gb.get_bits(1)              # sourcefscod (fscod != 3 here)
    if frame_type == FRAME_TYPE_INDEPENDENT and num_blocks != 6:
        gb.get_bits(1)              # convsync
    if frame_type == FRAME_TYPE_AC3_CONVERT and \
            (num_blocks == 6 or gb.get_bits(1)):
        gb.get_bits(6)              # frmsizecod
    if gb.get_bits(1):              # addbsie
        n = gb.get_bits(6)
        gb.skip_bits((n + 1) * 8)

    # audio frame syntax flags
    if num_blocks == 6:
        ac3_exponent_strategy = gb.get_bits(1)
        parse_aht_info = gb.get_bits(1)
    else:
        ac3_exponent_strategy = 1
        parse_aht_info = 0
    e = dict(num_blocks=num_blocks, frame_type=frame_type)
    e["snr_offset_strategy"] = gb.get_bits(2)
    parse_transient_proc_info = gb.get_bits(1)
    e["block_switch_syntax"] = gb.get_bits(1)
    e["dither_flag_syntax"] = gb.get_bits(1)
    e["bit_allocation_syntax"] = gb.get_bits(1)
    e["fast_gain_syntax"] = gb.get_bits(1)
    e["dba_syntax"] = gb.get_bits(1)
    e["skip_syntax"] = gb.get_bits(1)
    parse_spx_atten_data = gb.get_bits(1)

    # coupling strategy occurrence / use per block
    cpl_strategy_exists = [False] * num_blocks
    cpl_in_use = [False] * num_blocks
    if acmod > 1:
        for blk in range(num_blocks):
            cpl_strategy_exists[blk] = (blk == 0) or bool(gb.get_bits(1))
            if cpl_strategy_exists[blk]:
                cpl_in_use[blk] = bool(gb.get_bits(1))
            else:
                cpl_in_use[blk] = cpl_in_use[blk - 1]
    num_cpl_blocks = sum(cpl_in_use)
    e["cpl_strategy_exists"] = cpl_strategy_exists
    e["cpl_in_use_frame"] = cpl_in_use

    # exponent strategy data: exp_strategy[blk] maps {CPL, 0..nrows-1}
    exp_strategy = [dict() for _ in range(num_blocks)]
    if ac3_exponent_strategy:
        for blk in range(num_blocks):
            chans = ([CPL] if cpl_in_use[blk] else []) + list(range(nfchans))
            for ch in chans:
                exp_strategy[blk][ch] = gb.get_bits(2)
    else:
        chans = ([CPL] if (acmod > 1 and num_cpl_blocks) else []) \
            + list(range(nfchans))
        for ch in chans:
            idx = gb.get_bits(5)
            for blk in range(6):
                exp_strategy[blk][ch] = E.FRM_EXPSTR[idx][blk]
    if lfeon:
        for blk in range(num_blocks):
            exp_strategy[blk][lfe_ch] = gb.get_bits(1)
    if frame_type == FRAME_TYPE_INDEPENDENT and \
            (num_blocks == 6 or gb.get_bits(1)):
        gb.skip_bits(5 * nfchans)   # converter channel exponent strategy
    e["exp_strategy"] = exp_strategy

    # AHT usage per channel
    nrows = nfchans + (1 if lfeon else 0)
    aht = {ch: False for ch in [CPL] + list(range(nrows))}
    if parse_aht_info:
        chans = ([CPL] if num_cpl_blocks == 6 else []) + list(range(nrows))
        for ch in chans:
            use = all(exp_strategy[blk].get(ch, EXP_REUSE) == EXP_REUSE
                      for blk in range(1, 6))
            if ch == CPL:
                use = use and not any(cpl_strategy_exists[1:6])
            aht[ch] = bool(use and gb.get_bits(1))
    e["aht"] = aht

    # per-frame SNR offset (strategy 0)
    e["frame_snr_offset"] = None
    if not e["snr_offset_strategy"]:
        csnr = (gb.get_bits(6) - 15) << 4
        e["frame_snr_offset"] = (csnr + gb.get_bits(4)) << 2

    # transient pre-noise processing (side info, unused — like reference)
    if parse_transient_proc_info:
        for ch in range(nfchans):
            if gb.get_bits(1):
                gb.get_bits(18)     # location + length

    # spectral extension attenuation
    e["spx_atten_code"] = {}
    for ch in range(nfchans):
        if parse_spx_atten_data and gb.get_bits(1):
            e["spx_atten_code"][ch] = gb.get_bits(5)
        else:
            e["spx_atten_code"][ch] = -1

    # block start information (offsets; unused — like reference)
    if num_blocks > 1 and gb.get_bits(1):
        nbits = (num_blocks - 1) * \
            (4 + max(frame_bytes - 2, 1).bit_length() - 1)
        gb.skip_bits(nbits)
    return e


def band_structure(gb, blk, eac3, start_subband, end_subband,
                   default_struct, prev):
    """Shared cpl/spx banding decode (reference: ac3dec.c
    decode_band_structure :710, ecpl always 0 here). Returns
    (num_bands, band_sizes) or `prev` unchanged for the eac3
    "no change" case."""
    n_subbands = end_subband - start_subband
    if not eac3 or gb.get_bits(1):
        struct = [gb.get_bits(1) for _ in range(n_subbands - 1)]
    elif blk == 0:
        struct = list(default_struct[start_subband + 1:
                                     start_subband + n_subbands])
    else:
        return prev
    sizes = [12]
    for b in struct:
        if b:
            sizes[-1] += 12
        else:
            sizes.append(12)
    return len(sizes), sizes


# ---------------------------------------------------------------------- #
# AHT: gain adaptive quantization + 6-point IDCT (eac3dec.c :154-288)

GAQ_NO, GAQ_12, GAQ_14, GAQ_124 = 0, 1, 2, 3

# lrint(M_SQRT2*cos(k*M_PI/12)*(1<<23)) for k = 2, 0, 5
_COEFF_0 = 10273905
_COEFF_1 = 11863283
_COEFF_2 = 3070444


def _idct6(pm):
    """6-point IDCT of one bin's pre-mantissas, 24-bit fixed point."""
    odd1 = pm[1] - pm[3] - pm[5]
    even2 = (pm[2] * _COEFF_0) >> 23
    tmp = (pm[4] * _COEFF_1) >> 23
    odd0 = ((pm[1] + pm[5]) * _COEFF_2) >> 23
    even0 = pm[0] + (tmp >> 1)
    even1 = pm[0] - tmp
    t = even0
    even0 = t + even2
    even2 = t - even2
    t = odd0
    odd0 = t + pm[1] + pm[3]
    odd2 = t + pm[5] - pm[3]
    pm[0] = even0 + odd0
    pm[1] = even1 + odd1
    pm[2] = even2 + odd2
    pm[3] = even2 - odd2
    pm[4] = even1 - odd1
    pm[5] = even0 - odd0


def decode_aht_ch(gb, hebap, start, end, lfg):
    """All 6 blocks of pre-mantissas for one AHT channel, decoded at
    block 0 (reference: ff_eac3_decode_transform_coeffs_aht_ch).
    Returns int array (256, 6)."""
    pre = np.zeros((256, 6), dtype=np.int64)
    gaq_mode = gb.get_bits(2)
    end_bap = 12 if gaq_mode < 2 else 17

    gaq_gain = []
    if gaq_mode in (GAQ_12, GAQ_14):
        for bin_ in range(start, end):
            if 7 < hebap[bin_] < end_bap:
                gaq_gain.append(gb.get_bits(1) << (gaq_mode - 1))
    elif gaq_mode == GAQ_124:
        gc = 2
        for bin_ in range(start, end):
            if 7 < hebap[bin_] < 17:
                gc += 1
                if gc == 3:
                    code = gb.get_bits(5)
                    if code > 26:
                        code = 26
                    gaq_gain.extend(E.UNGROUP_3_IN_5[code])
                    gc = 0

    gs = 0
    for bin_ in range(start, end):
        hb = int(hebap[bin_])
        bits = E.BITS_VS_HEBAP[hb]
        pm = [0] * 6
        if hb == 0:
            for blk in range(6):
                pm[blk] = (lfg.get() & 0x7FFFFF) - 0x400000
        elif hb < 8:
            v = gb.get_bits(bits)
            row = E.MANTISSA_VQ[hb][v]
            for blk in range(6):
                pm[blk] = row[blk] << 8
        else:
            if gaq_mode != GAQ_NO and hb < end_bap:
                log_gain = gaq_gain[gs]
                gs += 1
            else:
                log_gain = 0
            gbits = bits - log_gain
            for blk in range(6):
                mant = gb.get_sbits(gbits)
                if log_gain and mant == -(1 << (gbits - 1)):
                    # large mantissa
                    mbits = bits - (2 - log_gain)
                    mant = gb.get_sbits(mbits)
                    mant <<= (23 - (mbits - 1))
                    if mant >= 0:
                        b = 1 << (23 - log_gain)
                    else:
                        b = E.GAQ_REMAP_2_4_B[hb - 8][log_gain - 1] << 8
                    mant += ((E.GAQ_REMAP_2_4_A[hb - 8][log_gain - 1]
                              * mant) >> 15) + b
                else:
                    mant <<= 24 - bits
                    if not log_gain:
                        mant += (E.GAQ_REMAP_1[hb - 8] * mant) >> 15
                pm[blk] = mant
        _idct6(pm)
        pre[bin_] = pm
    return pre


# ---------------------------------------------------------------------- #
# Spectral extension (eac3dec.c ff_eac3_apply_spectral_extension :65)

def spx_strategy(gb, blk, acmod, nfchans, st):
    """SPX strategy parse (ac3dec.c spx_strategy :759); mutates st."""
    if acmod == 1:               # mono: the only channel always in spx
        st["chinspx"] = [True]
    else:
        st["chinspx"] = [bool(gb.get_bits(1)) for _ in range(nfchans)]
    dst_start = gb.get_bits(2)
    start_subband = gb.get_bits(3) + 2
    if start_subband > 7:
        start_subband += start_subband - 7
    end_subband = gb.get_bits(3) + 5
    if end_subband > 7:
        end_subband += end_subband - 7
    dst_start_freq = dst_start * 12 + 25
    src_start_freq = start_subband * 12 + 25
    dst_end_freq = end_subband * 12 + 25
    if start_subband >= end_subband:
        raise AVError(INVALIDDATA, "invalid spx range")
    if dst_start_freq >= src_start_freq:
        raise AVError(INVALIDDATA, "invalid spx copy start bin")
    st["spx_dst_start"] = dst_start_freq
    st["spx_src_start"] = src_start_freq
    st["spx_dst_end"] = dst_end_freq
    prev = (st.get("num_spx_bands", 0), st.get("spx_band_sizes", []))
    st["num_spx_bands"], st["spx_band_sizes"] = band_structure(
        gb, blk, True, start_subband, end_subband,
        E.DEFAULT_SPX_BAND_STRUCT, prev)


def spx_coordinates(gb, nfchans, st):
    """SPX coordinates parse (ac3dec.c spx_coordinates :812);
    mutates st noise/signal blend arrays."""
    for ch in range(nfchans):
        if st["chinspx"][ch]:
            if st["first_spx_coords"][ch] or gb.get_bits(1):
                st["first_spx_coords"][ch] = False
                spx_blend = gb.get_bits(5) * (1.0 / 32)
                master = gb.get_bits(2) * 3
                bin_ = st["spx_src_start"]
                for bnd in range(st["num_spx_bands"]):
                    bandsize = st["spx_band_sizes"][bnd]
                    nratio = ((bin_ + (bandsize >> 1))
                              / st["spx_dst_end"]) - spx_blend
                    nratio = min(max(nratio, 0.0), 1.0)
                    nblend = np.sqrt(np.float32(3.0 * nratio))
                    sblend = np.sqrt(np.float32(1.0 - nratio))
                    bin_ += bandsize
                    exp = gb.get_bits(4)
                    mant = gb.get_bits(2)
                    if exp == 15:
                        mant <<= 1
                    else:
                        mant += 4
                    mant <<= (25 - exp - master)
                    coord = mant * (1.0 / (1 << 23))
                    st["spx_noise_blend"][ch][bnd] = nblend * coord
                    st["spx_signal_blend"][ch][bnd] = sblend * coord
        else:
            st["first_spx_coords"][ch] = True


def apply_spectral_extension(st, coeffs, nfchans, spx_atten_code, lfg):
    """Copy low-band coefficients into the extension region, blend with
    LFG noise at the signalled per-band energies, notch at wrap points
    (reference: ff_eac3_apply_spectral_extension). Operates on the
    float coefficient rows in place."""
    dst_start = st["spx_dst_start"]
    src_start = st["spx_src_start"]
    nbands = st["num_spx_bands"]
    sizes = st["spx_band_sizes"]

    wrapflag = [False] * nbands
    wrapflag[0] = True
    copy_sizes = []
    bin_ = dst_start
    for bnd in range(nbands):
        bandsize = sizes[bnd]
        if bin_ + bandsize > src_start:
            copy_sizes.append(bin_ - dst_start)
            bin_ = dst_start
            wrapflag[bnd] = True
        i = 0
        while i < bandsize:
            if bin_ == src_start:
                copy_sizes.append(bin_ - dst_start)
                bin_ = dst_start
            csz = min(bandsize - i, src_start - bin_)
            bin_ += csz
            i += csz
    copy_sizes.append(bin_ - dst_start)

    for ch in range(nfchans):
        if not st["chinspx"][ch]:
            continue
        row = coeffs[ch]
        bin_ = src_start
        for csz in copy_sizes:
            row[bin_:bin_ + csz] = row[dst_start:dst_start + csz]
            bin_ += csz

        rms = []
        bin_ = src_start
        for bnd in range(nbands):
            seg = row[bin_:bin_ + sizes[bnd]].astype(np.float32)
            rms.append(np.sqrt(np.float32((seg * seg).sum())
                               / sizes[bnd]))
            bin_ += sizes[bnd]

        if spx_atten_code.get(ch, -1) >= 0:
            atten = E.SPX_ATTEN_TAB[spx_atten_code[ch]]
            bin_ = src_start - 2
            for bnd in range(nbands):
                if wrapflag[bnd]:
                    row[bin_] *= atten[0]
                    row[bin_ + 1] *= atten[1]
                    row[bin_ + 2] *= atten[2]
                    row[bin_ + 3] *= atten[1]
                    row[bin_ + 4] *= atten[0]
                bin_ += sizes[bnd]

        bin_ = src_start
        for bnd in range(nbands):
            nscale = st["spx_noise_blend"][ch][bnd] * rms[bnd] \
                * (1.0 / -2147483648.0)
            sscale = st["spx_signal_blend"][ch][bnd]
            for _ in range(sizes[bnd]):
                v = lfg.get()
                noise = nscale * (v - 4294967296 if v >= 2147483648 else v)
                row[bin_] = row[bin_] * sscale + noise
                bin_ += 1
