"""MPEG audio Layer III granule decoding (reference behavior:
mpegaudiodec_template.c mp_decode_layer3 :1271, huffman_decode :830,
compute_stereo :1016, compute_antialias :1161, compute_imdct :1191,
reorder_block :981; MPEG-1 and MPEG-2 LSF).

The serial part (side info, scalefactors, Huffman) is host bit reading;
requantization, stereo, antialias and the hybrid IMDCT are vectorized
numpy over the 576-sample granule.  The IMDCT is the direct spec
transform (ISO 11172-3 2.4.3.4.6) — the reference's imdct36 fast
factorization computes the same map.
"""

from __future__ import annotations

import numpy as np

from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.bitstream.vlc import VLC
from libav_tpu_torch.codecs.mpegaudio import tables as T

_SBLIMIT = 32
_ISQRT2 = 0.70710678118654752440


# -- static tables -------------------------------------------------------

def _band_index_long():
    out = []
    for r in range(9):
        idx = [0]
        for b in T.BAND_SIZE_LONG[r]:
            idx.append(idx[-1] + b)
        out.append(idx)
    return out


_BAND_INDEX_LONG = _band_index_long()

_pair_vlcs = {}
_quad_vlc = None


def _pair_vlc(tid):
    v = _pair_vlcs.get(tid)
    if v is None:
        xsize, bits, codes = T.HUFF_PAIR[tid]
        v = _pair_vlcs[tid] = (VLC(9, codes, bits), xsize)
    return v


def _quad_vlc_a():
    global _quad_vlc
    if _quad_vlc is None:
        _quad_vlc = VLC(7, T.QUAD_CODES[0], T.QUAD_BITS[0])
    return _quad_vlc


def _is_tables():
    is_tab = np.zeros((2, 16))
    for i in range(7):
        if i != 6:
            f = np.tan(i * np.pi / 12.0)
            v = f / (1.0 + f)
        else:
            v = 1.0
        is_tab[0][i] = v
        is_tab[1][6 - i] = v
    is_lsf = np.zeros((2, 2, 16))
    for i in range(16):
        for j in range(2):
            e = -(j + 1) * ((i + 1) >> 1)
            f = 2.0 ** (e / 4.0)
            k = i & 1
            is_lsf[j][k ^ 1][i] = f
            is_lsf[j][k][i] = 1.0
    return is_tab, is_lsf


_IS_TABLE, _IS_TABLE_LSF = _is_tables()

_CS = 1.0 / np.sqrt(1.0 + np.square(T.CI_TABLE))
_CA = _CS * np.array(T.CI_TABLE)


def _imdct_mats():
    # 36-point: x[n] = sum_k X[k] cos(pi/72 (2n+19)(2k+1))
    n = np.arange(36)[:, None]
    k = np.arange(18)[None, :]
    M36 = np.cos(np.pi / 72.0 * (2 * n + 1 + 18) * (2 * k + 1))
    n = np.arange(12)[:, None]
    k = np.arange(6)[None, :]
    M12 = np.cos(np.pi / 24.0 * (2 * n + 1 + 6) * (2 * k + 1))
    return M36, M12


_M36, _M12 = _imdct_mats()


def _windows():
    i = np.arange(36)
    w = {0: np.sin(np.pi / 36.0 * (i + 0.5))}
    w1 = w[0].copy()
    w1[30:] = 0.0
    w1[24:30] = np.sin(np.pi / 12.0 * (np.arange(24, 30) - 18 + 0.5))
    w1[18:24] = 1.0
    w[1] = w1
    w3 = w[0].copy()
    w3[:6] = 0.0
    w3[6:12] = np.sin(np.pi / 12.0 * (np.arange(6, 12) - 6 + 0.5))
    w3[12:18] = 1.0
    w[3] = w3
    w[2] = np.sin(np.pi / 12.0 * (np.arange(12) + 0.5))
    return w


_WIN = _windows()


class _Granule:
    __slots__ = ("part2_3_length", "big_values", "global_gain",
                 "scalefac_compress", "block_type", "switch_point",
                 "table_select", "subblock_gain", "region_size",
                 "preflag", "scalefac_scale", "count1table_select",
                 "scfsi", "scale_factors", "sb_hybrid", "long_end",
                 "short_start")

    def __init__(self):
        self.scfsi = 0
        self.scale_factors = np.zeros(40, dtype=np.int64)
        self.sb_hybrid = np.zeros(576)


class Layer3Decoder:
    """Persistent Layer III state: bit reservoir + per-channel IMDCT
    overlap."""

    def __init__(self):
        self._store = b""                # bit reservoir (main data tail)
        self._overlap = np.zeros((2, 32, 18))
        self._prev_granules = [None, None]

    # -- side info -----------------------------------------------------

    def _read_side(self, gb: GetBits, hdr):
        nch = hdr["channels"]
        lsf = hdr["lsf"]
        sri = self._sri(hdr)
        if lsf:
            main_data_begin = gb.get_bits(8)
            gb.skip_bits(nch)
            nb_granules = 1
        else:
            main_data_begin = gb.get_bits(9)
            gb.skip_bits(3 if nch == 2 else 5)
            nb_granules = 2
        grans = [[_Granule() for _ in range(nb_granules)]
                 for _ in range(nch)]
        if not lsf:
            for ch in range(nch):
                grans[ch][0].scfsi = 0
                grans[ch][1].scfsi = gb.get_bits(4)
        for gr in range(nb_granules):
            for ch in range(nch):
                g = grans[ch][gr]
                g.part2_3_length = gb.get_bits(12)
                g.big_values = gb.get_bits(9)
                if g.big_values > 288:
                    g.big_values = 288
                g.global_gain = gb.get_bits(8)
                if (hdr["mode"] == 1 and
                        (hdr["mode_ext"] & 3) == 2):   # MS only
                    g.global_gain -= 2
                g.scalefac_compress = gb.get_bits(9 if lsf else 4)
                if gb.get_bits(1):               # blocksplit_flag
                    g.block_type = gb.get_bits(2)
                    g.switch_point = gb.get_bits(1)
                    g.table_select = [gb.get_bits(5) for _ in range(2)] \
                        + [0]
                    g.subblock_gain = [gb.get_bits(3) for _ in range(3)]
                    # init_short_region
                    if g.block_type == 2:
                        r0 = 36 // 2 if sri != 8 else 72 // 2
                    else:
                        if sri <= 2:
                            r0 = 36 // 2
                        elif sri != 8:
                            r0 = 54 // 2
                        else:
                            r0 = 108 // 2
                    g.region_size = [r0, 576 // 2, 576 // 2]
                else:
                    g.block_type = 0
                    g.switch_point = 0
                    g.table_select = [gb.get_bits(5) for _ in range(3)]
                    ra1 = gb.get_bits(4)
                    ra2 = gb.get_bits(3)
                    bil = _BAND_INDEX_LONG[sri]
                    g.region_size = [bil[ra1 + 1] >> 1,
                                     bil[min(ra1 + ra2 + 2, 22)] >> 1,
                                     576 // 2]
                    g.subblock_gain = [0, 0, 0]
                # region_offset2size
                j = 0
                rs = []
                for i in range(3):
                    k = min(g.region_size[i], g.big_values)
                    rs.append(k - j)
                    j = k
                g.region_size = rs
                # compute_band_indexes
                if g.block_type == 2:
                    if g.switch_point:
                        g.long_end = 8 if sri <= 2 else 6
                        g.short_start = 3
                    else:
                        g.long_end = 0
                        g.short_start = 0
                else:
                    g.long_end = 22
                    g.short_start = 13
                g.preflag = 0 if lsf else gb.get_bits(1)
                g.scalefac_scale = gb.get_bits(1)
                g.count1table_select = gb.get_bits(1)
        return main_data_begin, nb_granules, grans

    @staticmethod
    def _sri(hdr):
        """reference sample_rate_index: freq table row + 3*lsf(+3)"""
        base = hdr["sr_index"]
        if hdr["mpeg25"]:
            return base + 6
        return base + 3 if hdr["lsf"] else base

    # -- scale factors ---------------------------------------------------

    @staticmethod
    def _split(sf, n):
        if n == 3:
            m = (sf * 171) >> 9
            return sf - 3 * m, m
        if n == 4:
            return sf & 3, sf >> 2
        if n == 5:
            m = (sf * 205) >> 10
            return sf - 5 * m, m
        if n == 6:
            m = (sf * 171) >> 10
            return sf - 6 * m, m
        return 0, sf

    def _read_scale_factors(self, gb, g, g0, hdr, ch):
        lsf = hdr["lsf"]
        if not lsf:
            slen1 = T.SLEN_TABLE[0][g.scalefac_compress]
            slen2 = T.SLEN_TABLE[1][g.scalefac_compress]
            j = 0
            if g.block_type == 2:
                n = 17 if g.switch_point else 18
                for _ in range(n):
                    g.scale_factors[j] = gb.get_bits(slen1) if slen1 else 0
                    j += 1
                for _ in range(18):
                    g.scale_factors[j] = gb.get_bits(slen2) if slen2 else 0
                    j += 1
                for _ in range(3):
                    g.scale_factors[j] = 0
                    j += 1
            else:
                sc = g0.scale_factors if g0 is not None else None
                for k in range(4):
                    n = 6 if k == 0 else 5
                    if (g.scfsi & (0x8 >> k)) == 0:
                        slen = slen1 if k < 2 else slen2
                        for _ in range(n):
                            g.scale_factors[j] = \
                                gb.get_bits(slen) if slen else 0
                            j += 1
                    else:
                        for _ in range(n):
                            g.scale_factors[j] = sc[j]
                            j += 1
                g.scale_factors[j] = 0
        else:
            if g.block_type == 2:
                tindex = 2 if g.switch_point else 1
            else:
                tindex = 0
            sf = g.scalefac_compress
            intensity_ch1 = (hdr["mode_ext"] & 1) and ch == 1
            if intensity_ch1:
                sf >>= 1
                if sf < 180:
                    d, sf = self._split(sf, 0)
                    s2, sf = self._split(sf, 6)
                    s1, sf = self._split(sf, 6)
                    slen = [sf, s1, s2, 0]
                    tindex2 = 3
                elif sf < 244:
                    sf -= 180
                    d, sf = self._split(sf, 0)
                    s2, sf = self._split(sf, 4)
                    s1, sf = self._split(sf, 4)
                    slen = [sf, s1, s2, 0]
                    tindex2 = 4
                else:
                    sf -= 244
                    d, sf = self._split(sf, 0)
                    s2, sf = self._split(sf, 0)
                    s1, sf = self._split(sf, 3)
                    slen = [sf, s1, s2, 0]
                    tindex2 = 5
            else:
                if sf < 400:
                    s3, sf = self._split(sf, 4)
                    s2, sf = self._split(sf, 4)
                    s1, sf = self._split(sf, 5)
                    slen = [sf, s1, s2, s3]
                    tindex2 = 0
                elif sf < 500:
                    sf -= 400
                    s3, sf = self._split(sf, 0)
                    s2, sf = self._split(sf, 4)
                    s1, sf = self._split(sf, 5)
                    slen = [sf, s1, s2, s3]
                    tindex2 = 1
                else:
                    sf -= 500
                    s3, sf = self._split(sf, 0)
                    s2, sf = self._split(sf, 0)
                    s1, sf = self._split(sf, 3)
                    slen = [sf, s1, s2, s3]
                    tindex2 = 2
                    g.preflag = 1
            j = 0
            for k in range(4):
                n = T.LSF_NSF_TABLE[tindex2][tindex][k]
                sl = slen[k]
                for _ in range(n):
                    g.scale_factors[j] = gb.get_bits(sl) if sl else 0
                    j += 1
            g.scale_factors[j:40] = 0

    # -- exponents + huffman ----------------------------------------------

    def _exponents(self, g, sri):
        exps = np.zeros(576, dtype=np.int64)
        gain = g.global_gain - 210
        shift = g.scalefac_scale + 1
        bstab = T.BAND_SIZE_LONG[sri]
        pretab = T.PRETAB[g.preflag]
        p = 0
        for i in range(g.long_end):
            v0 = gain - ((int(g.scale_factors[i]) + pretab[i]) << shift)
            ln = bstab[i]
            exps[p:p + ln] = v0
            p += ln
        if g.short_start < 13:
            bstab = T.BAND_SIZE_SHORT[sri]
            gains = [gain - (g.subblock_gain[l] << 3) for l in range(3)]
            k = g.long_end
            for i in range(g.short_start, 13):
                ln = bstab[i]
                for l in range(3):
                    v0 = gains[l] - (int(g.scale_factors[k]) << shift)
                    k += 1
                    exps[p:p + ln] = v0
                    p += ln
        return exps

    @staticmethod
    def _unscale(value, exponent):
        return float(value) ** (4.0 / 3.0) * 2.0 ** (exponent / 4.0)

    def _huffman(self, gb, g, exps, end_pos):
        sb = g.sb_hybrid
        sb[:] = 0.0
        si = 0
        for i in range(3):
            j = g.region_size[i]
            if j == 0:
                continue
            tsel = g.table_select[i]
            l, linbits = T.HUFF_DATA[tsel]
            tid = T.HUFF_INDEX[l]
            if tid == 0:
                si += 2 * j
                continue
            vlc, xsize = _pair_vlc(tid)
            for _ in range(j):
                if gb.bits_read() >= end_pos:
                    break
                try:
                    idx = vlc.read(gb)
                except Exception:
                    break
                x, y = idx // xsize, idx % xsize
                if x == 0 and y == 0:
                    si += 2
                    continue
                e = int(exps[si])
                for off, v in ((0, x), (1, y)):
                    if v == 15 and linbits:
                        v += gb.get_bits(linbits)
                    if v:
                        val = self._unscale(v, e)
                        if gb.get_bits(1):
                            val = -val
                        sb[si + off] = val
                si += 2
        # count1
        use_b = g.count1table_select
        vlc = None if use_b else _quad_vlc_a()
        last_rollback = None
        while si <= 572:
            pos = gb.bits_read()
            if pos >= end_pos:
                break
            try:
                if use_b:
                    code = 15 - gb.get_bits(4)   # table B: v = 15 - raw
                else:
                    code = vlc.read(gb)
                vals = [0.0, 0.0, 0.0, 0.0]
                for b in range(4):
                    if code & (8 >> b):
                        val = self._unscale(1, int(exps[si + b]))
                        if gb.get_bits(1):
                            val = -val
                        vals[b] = val
            except Exception:
                break
            if gb.bits_read() > end_pos:
                break                          # overshooting quad dropped
            sb[si:si + 4] = vals
            si += 4
        # seek to the granule end
        gb.skip_bits(end_pos - gb.bits_read())

    # -- stereo / antialias / hybrid ---------------------------------------

    def _stereo(self, g0, g1, hdr, sri):
        mode_ext = hdr["mode_ext"]
        if mode_ext & 1:                      # intensity
            if not hdr["lsf"]:
                is_tab = _IS_TABLE
                sf_max = 7
            else:
                is_tab = _IS_TABLE_LSF[g1.scalefac_compress & 1]
                sf_max = 16
            t0, t1 = g0.sb_hybrid, g1.sb_hybrid
            pos = 576
            nz_short = [0, 0, 0]
            k = (13 - g1.short_start) * 3 + g1.long_end - 3
            for i in range(12, g1.short_start - 1, -1):
                if i != 11:
                    k -= 3
                ln = T.BAND_SIZE_SHORT[sri][i]
                for l in (2, 1, 0):
                    pos -= ln
                    if not nz_short[l]:
                        if np.any(t1[pos:pos + ln] != 0):
                            nz_short[l] = 1
                        else:
                            sf = int(g1.scale_factors[k + l])
                            if sf >= sf_max:
                                nz_short[l] = 1
                            else:
                                v1, v2 = is_tab[0][sf], is_tab[1][sf]
                                seg = t0[pos:pos + ln].copy()
                                t0[pos:pos + ln] = seg * v1
                                t1[pos:pos + ln] = seg * v2
                                continue
                    if mode_ext & 2:
                        a = t0[pos:pos + ln].copy()
                        b = t1[pos:pos + ln].copy()
                        t0[pos:pos + ln] = (a + b) * _ISQRT2
                        t1[pos:pos + ln] = (a - b) * _ISQRT2
            nz = any(nz_short)
            for i in range(g1.long_end - 1, -1, -1):
                ln = T.BAND_SIZE_LONG[sri][i]
                pos -= ln
                if not nz:
                    if np.any(t1[pos:pos + ln] != 0):
                        nz = 1
                    else:
                        kk = 20 if i == 21 else i
                        sf = int(g1.scale_factors[kk])
                        if sf >= sf_max:
                            nz = 1
                        else:
                            v1, v2 = is_tab[0][sf], is_tab[1][sf]
                            seg = t0[pos:pos + ln].copy()
                            t0[pos:pos + ln] = seg * v1
                            t1[pos:pos + ln] = seg * v2
                            continue
                if mode_ext & 2:
                    a = t0[pos:pos + ln].copy()
                    b = t1[pos:pos + ln].copy()
                    t0[pos:pos + ln] = (a + b) * _ISQRT2
                    t1[pos:pos + ln] = (a - b) * _ISQRT2
        elif mode_ext & 2:                    # MS only (gain pre-adjusted)
            a = g0.sb_hybrid.copy()
            b = g1.sb_hybrid.copy()
            g0.sb_hybrid[:] = a + b
            g1.sb_hybrid[:] = a - b

    def _reorder(self, g, sri):
        if g.block_type != 2:
            return
        start = 0
        if g.switch_point:
            start = 36 if sri != 8 else 72
        sb = g.sb_hybrid
        p = start
        for i in range(g.short_start, 13):
            ln = T.BAND_SIZE_SHORT[sri][i]
            seg = sb[p:p + 3 * ln].reshape(3, ln)
            sb[p:p + 3 * ln] = seg.T.reshape(-1)
            p += 3 * ln

    def _antialias(self, g):
        if g.block_type == 2:
            if not g.switch_point:
                return
            n = 1
        else:
            n = _SBLIMIT - 1
        sb = g.sb_hybrid
        for b in range(n):
            base = 18 * (b + 1)
            lo = sb[base - 8:base][::-1].copy()   # ptr[-1-j] j=0..7
            hi = sb[base:base + 8].copy()
            sb[base - 8:base] = (lo * _CS - hi * _CA)[::-1]
            sb[base:base + 8] = lo * _CA + hi * _CS

    def _imdct(self, g, overlap):
        """Hybrid synthesis: 18 output slots x 32 subbands, with
        inter-granule overlap (compute_imdct semantics, direct spec
        transforms)."""
        out = np.zeros((18, 32))
        sb = g.sb_hybrid
        for b in range(32):
            X = sb[18 * b:18 * b + 18]
            is_short = g.block_type == 2 and \
                (not g.switch_point or b >= 2)
            if is_short:
                z = np.zeros(36)
                Xs = X.reshape(6, 3)
                for w in range(3):
                    y = _M12 @ Xs[:, w]
                    z[6 + 6 * w:18 + 6 * w] += y * _WIN[2]
            else:
                if g.block_type != 2 and not (g.switch_point and b < 2):
                    wt = g.block_type
                else:
                    wt = 0
                z = (_M36 @ X) * _WIN[wt]
            out[:, b] = z[:18] + overlap[b]
            overlap[b] = z[18:]
        # frequency inversion: odd subbands, odd time slots
        out[1::2, 1::2] = -out[1::2, 1::2]
        return out

    # -- main ---------------------------------------------------------------

    def decode(self, gb: GetBits, hdr, frame: bytes):
        """gb positioned after header(+crc) inside `frame`; returns
        per-channel (n_slots, 32) subband sample arrays or None."""
        nch = hdr["channels"]
        sri = self._sri(hdr)
        main_data_begin, nb_granules, grans = self._read_side(gb, hdr)
        # main data = reservoir tail + this frame's payload
        rest = frame[4 + (2 if hdr["protection"] else 0) +
                     (gb.bits_read() // 8):]
        have = min(main_data_begin, len(self._store))
        data = (self._store[len(self._store) - have:] if have else b"") \
            + rest
        self._store = (self._store + rest)[-511:]
        out = [np.zeros((18 * nb_granules, 32)) for _ in range(nch)]
        if have < main_data_begin:
            # reservoir not primed: decode zero spectra for continuity
            for gr in range(nb_granules):
                for ch in range(nch):
                    g = grans[ch][gr]
                    g.sb_hybrid[:] = 0
                    out[ch][18 * gr:18 * gr + 18] = \
                        self._imdct(g, self._overlap[ch])
            return out
        mgb = GetBits(data)
        for gr in range(nb_granules):
            for ch in range(nch):
                g = grans[ch][gr]
                bits_pos = mgb.bits_read()
                g0 = self._prev_granules[ch] if gr == 0 else \
                    grans[ch][0]
                self._read_scale_factors(mgb, g, grans[ch][0] if gr else
                                         g0, hdr, ch)
                exps = self._exponents(g, sri)
                self._huffman(mgb, g, exps, bits_pos + g.part2_3_length)
            if hdr["mode"] == 1:              # joint stereo
                self._stereo(grans[0][gr], grans[1][gr], hdr, sri)
            for ch in range(nch):
                g = grans[ch][gr]
                self._reorder(g, sri)
                self._antialias(g)
                out[ch][18 * gr:18 * gr + 18] = \
                    self._imdct(g, self._overlap[ch])
        for ch in range(nch):
            self._prev_granules[ch] = grans[ch][nb_granules - 1]
        return out
