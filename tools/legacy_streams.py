"""Stream writers for the legacy video codecs that the repository decodes
but does not encode: H.263 baseline (raw .263), Sorenson H.263 (FLV1) and
the Microsoft MPEG-4 variants MSMPEG4 v2, v3 and WMV1 (msmpeg4 v4).

Each writer emits the syntax that the decoders parse (the JAX package's
`codecs/h263dec.py` and `codecs/msmpeg4dec.py`, and the port's copies)
from a seed and a sequence of source frames: the intra DC of every block
follows the source's block means, and everything else (macroblock types,
coded-block patterns, DQUANT, vectors, coefficients and the escape forms)
is drawn from the seed. The decoded pictures are blocky pictures of the
source with noise where coefficients were drawn; they exercise the
parsers and the reconstruction, not a rate-distortion search.

What each writer covers:
  H.263   the standard PTYPE header with source formats sub-QCIF to 16CIF
          and the PLUSPTYPE header (UFEP 1 with a standard or custom
          format, custom PCF, an extended PAR; UFEP 0 after it; the
          rounding type of P pictures), PQUANT, PEI bytes, COD, MCBPC
          (intra, inter, each with and without DQUANT), CBPY, DQUANT,
          median-predicted MVDs (vectors reaching outside the picture
          included), TCOEF with the 22-bit escape and its 11-bit level
          extension, and INTRADC;
  FLV1    the FLV picture header with the 8-bit, 16-bit and fixed size
          codes, disposable P pictures, and both escape formats (the
          H.263 one and the Sorenson 7/11-bit one), picture by picture;
  MSMPEG4 the v3 and WMV1 picture headers (slice codes, RL table indices,
          DC and MV table selection, the v3 extension header with flip-flop
          rounding, WMV1's inline one with per-MB RL selection), I-picture
          coded-block prediction, the P macroblock VLC with skips, the MV
          pair tables with their escape, the DC tables with the
          divide-style predictor, AC prediction flags, and the three escape
          modes of the RL tables (WMV1's ESC3 with its signalled widths);
          v2's MB type, CBPC/CBPY, H.263 vectors and its unified DC book.

GOB headers are written only on request (`H263Writer.gob_headers`):
neither package's H.263 decoder reads them, so such a picture is
concealed.

Only numpy and the port's bit writer, tables and prediction helper are
imported (no jax), so the tests and `tools/gen_torch_smoke_stream.py
legacy` share the writers:

    from tools.legacy_streams import h263_stream, flv1_stream, msmpeg4_stream
    packets = h263_stream(frames, seed=1, fmt=2)
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs import msmpeg4_tables as M
from libav_tpu_torch.codecs.mpeg4 import tables as T
from libav_tpu_torch.codecs.mpeg4.dec import _VopPred
from libav_tpu_torch.ops.quant import mpeg4_dc_scaler

# H.263 source formats (ff_h263_format) and FLV's fixed size codes
H263_FORMATS = {1: (128, 96), 2: (176, 144), 3: (352, 288),
                4: (704, 576), 5: (1408, 1152)}
FLV_SIZES = {2: (352, 288), 3: (176, 144), 4: (128, 96),
             5: (320, 240), 6: (160, 120)}

Planes = Sequence[np.ndarray]


def _block_means(planes: Planes, mb_w: int, mb_h: int) -> np.ndarray:
    """(nmb, 6) mean of each 8x8 block of the source, edge-padded to whole
    macroblocks."""
    out = []
    for p, s in zip(planes[:3], (16, 8, 8)):
        p = np.asarray(p, np.float64)
        h, w = mb_h * s, mb_w * s
        p = np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])),
                   mode="edge")
        m = p.reshape(h // 8, 8, w // 8, 8).mean(axis=(1, 3))
        out.append(m)
    y = out[0].reshape(mb_h, 2, mb_w, 2).transpose(0, 2, 1, 3) \
        .reshape(mb_h * mb_w, 4)
    return np.concatenate([y, out[1].reshape(-1, 1), out[2].reshape(-1, 1)],
                          axis=1)


def _coefficients(rng, start: int, big: float, max_level: int,
                  count: int = 4) -> List[Tuple[int, int]]:
    """A coded block's nonzero coefficients: 1..count (position, level)
    pairs in scan order from start, low frequencies likelier in four
    blocks of five (long runs in the fifth), mostly +-1..3; a `big` share
    of them large (up to max_level, so that the escapes are needed)."""
    n = int(rng.integers(1, count + 1))
    w = 0.85 ** np.arange(64 - start) if rng.random() < 0.8 else \
        np.ones(64 - start)
    pos = np.sort(rng.choice(np.arange(start, 64), n, replace=False,
                             p=w / w.sum()))
    out = []
    for k in pos:
        if rng.random() < big:
            a = int(rng.integers(13, max_level + 1))
        else:
            a = int(rng.choice([1, 1, 1, 2, 2, 3]))
        out.append((int(k), a if rng.random() < 0.5 else -a))
    return out


def _runs(coeffs, start: int):
    """(last, run, level) of each coefficient."""
    out, prev = [], start - 1
    for i, (k, lvl) in enumerate(coeffs):
        out.append((1 if i == len(coeffs) - 1 else 0, k - prev - 1, lvl))
        prev = k
    return out


def _put012(pb: PutBits, v: int):
    """decode012's code: 0 -> '0', 1 -> '10', 2 -> '11'."""
    if v == 0:
        pb.put_bits(1, 0)
    else:
        pb.put_bits(2, 2 + (v - 1))


# ---------------------------------------------------------------------- #
# H.263 and FLV1


class H263Writer:
    """H.263 baseline / Sorenson H.263 pictures over a fixed geometry.

    header: 'std' (PTYPE with source format fmt), 'plus' (PLUSPTYPE: the
    first picture UFEP 1, the others UFEP 0; fmt 6 is the custom format
    with the writer's width and height) or 'flv' (the FLV picture header;
    esc picks the escape format per picture: 0 H.263, 1 Sorenson)."""

    def __init__(self, width: int, height: int, seed: int,
                 header: str = "std", fmt: Optional[int] = None,
                 custom_pcf: bool = False, par15: bool = False):
        self.width, self.height = width, height
        self.mb_w, self.mb_h = (width + 15) >> 4, (height + 15) >> 4
        self.rng = np.random.default_rng(seed)
        self.header, self.fmt = header, fmt
        self.custom_pcf, self.par15 = custom_pcf, par15
        self.tr = 0
        self.esc = 0
        self._first = True
        self.used = collections.Counter()     # syntax forms written
        self.gob_headers = False              # a GOB header per MB row

    # -- picture headers ------------------------------------------------ #

    def _std_header(self, pb, pict_type: int, qscale: int):
        pb.put_bits(22, 0x20)
        pb.put_bits(8, self.tr & 0xFF)
        pb.put_bits(1, 1)
        pb.put_bits(1, 0)
        pb.put_bits(3, 0)                     # split / camera / freeze
        if self.header == "plus":
            self._plus_header(pb, pict_type, qscale)
            return
        pb.put_bits(3, self.fmt)
        pb.put_bits(1, pict_type)
        pb.put_bits(4, 0)                     # UMV, SAC, AP, PB off
        pb.put_bits(5, qscale)
        pb.put_bits(1, 0)                     # CPM
        self._pei(pb)

    def _plus_header(self, pb, pict_type: int, qscale: int):
        pb.put_bits(3, 7)                     # PLUSPTYPE
        ufep = 1 if self._first else 0
        pb.put_bits(3, ufep)
        if ufep:
            pb.put_bits(3, self.fmt)
            pb.put_bits(1, int(self.custom_pcf))
            pb.put_bits(10, 0)                # no optional coding modes
            pb.put_bits(4, 0b1000)            # marker + reserved
        pb.put_bits(3, pict_type)             # MPPTYPE: 0 I, 1 P
        pb.put_bits(2, 0)                     # RPR, RRU
        pb.put_bits(1, int(self.rng.integers(0, 2)) if pict_type else 0)
        pb.put_bits(4, 0b0001)
        if ufep:
            if self.fmt == 6:                 # CPFMT
                pb.put_bits(4, 15 if self.par15 else 2)
                pb.put_bits(9, self.width // 4 - 1)
                pb.put_bits(1, 1)
                pb.put_bits(9, self.height // 4)
                if self.par15:
                    pb.put_bits(8, 12)
                    pb.put_bits(8, 11)
            if self.custom_pcf:
                pb.put_bits(1, 0)             # clock conversion code
                pb.put_bits(7, 60)            # clock divisor
        if self.custom_pcf:
            pb.put_bits(2, 0)                 # ETR
        pb.put_bits(5, qscale)
        self._pei(pb)

    def _flv_header(self, pb, pict_type: int, qscale: int):
        pb.put_bits(17, 1)
        pb.put_bits(5, self.esc)
        pb.put_bits(8, self.tr & 0xFF)
        sz = {v: k for k, v in FLV_SIZES.items()}.get(
            (self.width, self.height))
        if sz is None or self.fmt is not None:
            sz = self.fmt if self.fmt is not None else \
                (0 if max(self.width, self.height) < 256 else 1)
        pb.put_bits(3, sz)
        if sz == 0:
            pb.put_bits(8, self.width)
            pb.put_bits(8, self.height)
        elif sz == 1:
            pb.put_bits(16, self.width)
            pb.put_bits(16, self.height)
        # P pictures alternate between plain and disposable
        pb.put_bits(2, 0 if not pict_type else 1 + (self.tr & 1))
        pb.put_bits(1, 0)                     # deblocking flag
        pb.put_bits(5, qscale)
        self._pei(pb)

    def _pei(self, pb):
        if self.rng.random() < 0.3:           # a PEI byte, then none
            pb.put_bits(1, 1)
            pb.put_bits(8, int(self.rng.integers(0, 256)))
        pb.put_bits(1, 0)

    # -- macroblocks ----------------------------------------------------- #

    def _escape(self, pb, last: int, run: int, level: int):
        ec, eb = T.INTER_VLC[T.ESC_INDEX]
        pb.put_bits(eb, ec)
        if self.header == "flv" and self.esc == 1:
            is11 = int(not -64 < level < 64)
            self.used["flv escape %d-bit" % (11 if is11 else 7)] += 1
            pb.put_bits(1, is11)
            pb.put_bits(1, last)
            pb.put_bits(6, run)
            pb.put_sbits(11 if is11 else 7, level)
            return
        pb.put_bits(1, last)
        pb.put_bits(6, run)
        if -128 < level < 128:
            self.used["escape"] += 1
            pb.put_sbits(8, level)
        else:                                 # the 11-bit extension
            self.used["escape 11-bit"] += 1
            pb.put_bits(8, 0x80)
            pb.put_bits(5, level & 31)
            pb.put_sbits(6, level >> 5)

    def _tcoef(self, pb, coeffs, start: int):
        m = T.rl_encode_map(False)
        for last, run, level in _runs(coeffs, start):
            key = (last, run, abs(level))
            if key in m and self.rng.random() > 0.03:
                code, bits = m[key]
                pb.put_bits(bits, code)
                pb.put_bits(1, 1 if level < 0 else 0)
            else:
                self._escape(pb, last, run, level)

    def _max_level(self) -> int:
        if self.header == "flv":
            return 1023 if self.esc == 1 else 127
        return 900

    def picture(self, planes: Planes, pict_type: int, qscale: int,
                pan: Tuple[int, int] = (0, 0)) -> bytes:
        """One coded picture (0 I, 1 P) of planes: the bytes of a packet.
        P macroblocks move by about pan (half-pel) with jitter; those on
        the picture's edges point outside it."""
        rng = self.rng
        pb = PutBits()
        if self.header == "flv":
            self._flv_header(pb, pict_type, qscale)
        else:
            self._std_header(pb, pict_type, qscale)
        self._first = False
        mw, mh = self.mb_w, self.mb_h
        means = _block_means(planes, mw, mh)
        pred = _VopPred(mw, mh)
        q = qscale
        for mb_y in range(mh):
            if mb_y and self.gob_headers:
                pb.align(pad_bit=0)
                pb.put_bits(17, 1)                      # GBSC
                pb.put_bits(5, mb_y)                    # GN
                pb.put_bits(2, 0)                       # GFID
                pb.put_bits(5, q)                       # GQUANT
            for mb_x in range(mw):
                idx = mb_y * mw + mb_x
                r = rng.random()
                if pict_type and r < 0.45:              # COD: skipped
                    self.used["skip"] += 1
                    pb.put_bits(1, 1)
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, 0, 0)
                    continue
                intra = not pict_type or r > 0.88
                has_q = rng.random() < 0.12
                cbp = int(rng.integers(0, 64)) & int(rng.integers(0, 64))
                cbpc, cbpy = cbp & 3, cbp >> 2
                if pict_type:
                    pb.put_bits(1, 0)                   # COD
                    group = (T.MBT_INTRAQ if has_q else T.MBT_INTRA) \
                        if intra else (T.MBT_INTERQ if has_q
                                       else T.MBT_INTER)
                    i = group * 4 + cbpc
                    pb.put_bits(T.INTER_MCBPC_BITS[i], T.INTER_MCBPC_CODE[i])
                else:
                    i = (4 if has_q else 0) + cbpc
                    pb.put_bits(T.INTRA_MCBPC[1][i], T.INTRA_MCBPC[0][i])
                code, bits = T.CBPY[cbpy if intra else 15 - cbpy]
                pb.put_bits(bits, code)
                self.used["intra" if intra else "inter"] += 1
                if has_q:
                    self.used["dquant"] += 1
                    dq = int(rng.integers(0, 4))
                    pb.put_bits(2, dq)
                    q = max(1, min(31, q + (-1, -2, 1, 2)[dq]))
                if intra:
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, 0, 0)
                else:
                    px, py = pred.grid_pred(mb_x, mb_y, 0)
                    v = [pan[0] + int(rng.integers(-3, 4)),
                         pan[1] + int(rng.integers(-3, 4))]
                    if mb_x in (0, mw - 1):
                        v[0] = -32 if mb_x == 0 else 31
                    if mb_y in (0, mh - 1) and rng.random() < 0.5:
                        v[1] = -32 if mb_y == 0 else 31
                    v = [max(-32, min(31, c)) for c in v]
                    for c, p in zip(v, (px, py)):
                        d = (c - p + 32) % 64 - 32
                        code, bits = T.MVTAB[abs(d)]
                        pb.put_bits(bits, code)
                        if d:
                            pb.put_bits(1, 1 if d < 0 else 0)
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, v[0], v[1])
                for b in range(6):
                    coded = cbp & (0x20 >> b)
                    if intra:
                        dc = int(np.clip(round(means[idx, b]), 1, 254))
                        pb.put_bits(8, 255 if dc == 128 else dc)
                    if coded:
                        self._tcoef(pb, _coefficients(
                            rng, 1 if intra else 0, 0.05,
                            self._max_level()), 1 if intra else 0)
        pb.align(pad_bit=0)
        self.tr += 1
        return pb.flush()


def _psc_free(data: bytes) -> bool:
    """No byte-aligned picture start code past the first (the raw H.263
    demuxer splits there)."""
    i = data.find(b"\x00\x00", 1)
    while 0 <= i < len(data) - 2:
        if (data[i + 2] & 0xFC) == 0x80:
            return False
        i = data.find(b"\x00\x00", i + 1)
    return True


def h263_stream(frames: Sequence[Planes], seed: int, fmt: int = 2,
                header: str = "std", width: int = 0, height: int = 0,
                qscale: int = 8, gop: int = 0, used=None,
                **kw) -> List[bytes]:
    """H.263 packets of frames: I then P pictures (an I every gop
    pictures if gop). fmt 1-5 are the standard sizes; with header 'plus',
    fmt 6 is the custom width x height (multiples of 4). A picture that
    would hold a start code by chance is drawn again. used (a Counter)
    receives the counts of the syntax forms written."""
    if fmt in H263_FORMATS:
        width, height = H263_FORMATS[fmt]
    w = H263Writer(width, height, seed, header, fmt, **kw)
    out = []
    for t, planes in enumerate(frames):
        ptype = 0 if t == 0 or (gop and t % gop == 0) else 1
        while True:
            state = (w.rng.bit_generator.state, w.tr, w._first)
            data = w.picture(planes, ptype, qscale, pan=(2 * t, -t))
            if _psc_free(data):
                break
            w.rng.bit_generator.state, w.tr, w._first = state
            w.rng.random()
        out.append(data)
    if used is not None:
        used.update(w.used)
    return out


def flv1_stream(frames: Sequence[Planes], seed: int, width: int,
                height: int, qscale: int = 8, size_code: Optional[int] = None,
                escapes: Sequence[int] = (0, 1), used=None) -> List[bytes]:
    """FLV1 packets of frames: I then P pictures; picture t uses the escape
    format escapes[t % len(escapes)]; size_code forces the header's size
    code (0 8-bit, 1 16-bit, 2-6 the fixed sizes)."""
    w = H263Writer(width, height, seed, "flv", size_code)
    out = []
    for t, planes in enumerate(frames):
        w.esc = escapes[t % len(escapes)]
        out.append(w.picture(planes, 0 if t == 0 else 1, qscale,
                             pan=(2 * t, -t)))
    if used is not None:
        used.update(w.used)
    return out


# ---------------------------------------------------------------------- #
# MSMPEG4 v2 / v3 / WMV1


@functools.lru_cache(maxsize=None)
def _rl_code(idx: int):
    """-> (encode map (last, run, level > 0) -> (code, bits), the escape's
    (code, bits), lmax, rmax) of ff_rl_table[idx], as the decoders index
    it."""
    n, last_split, src = M.RL_META[idx]
    if src in ("MPEG4_INTRA", "H263_INTER"):
        intra = src == "MPEG4_INTRA"
        pairs = T.INTRA_VLC if intra else T.INTER_VLC
        tuples = T.rl_decode_tuple(intra)
        esc = T.ESC_INDEX
    else:
        pairs = getattr(M, src + "_VLC")
        runs = getattr(M, src + "_RUN")
        lvls = getattr(M, src + "_LEVEL")
        tuples = [(1 if i >= last_split else 0, runs[i], lvls[i])
                  for i in range(n)]
        esc = n
    enc: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
    lmax: Dict[Tuple[int, int], int] = {}
    rmax: Dict[Tuple[int, int], int] = {}
    for i, (last, run, lvl) in enumerate(tuples):
        enc.setdefault((last, run, lvl), pairs[i])
        lmax[(last, run)] = max(lmax.get((last, run), 0), lvl)
        rmax[(last, lvl)] = max(rmax.get((last, lvl), 0), run)
    return enc, pairs[esc], lmax, rmax


@functools.lru_cache(maxsize=None)
def _mv_code(idx: int):
    """(mvx, mvy) -> (code, bits) of MV table idx, and the escape's."""
    code = getattr(M, f"TABLE{idx}_MV_CODE")
    bits = getattr(M, f"TABLE{idx}_MV_BITS")
    mvx = getattr(M, f"TABLE{idx}_MVX")
    mvy = getattr(M, f"TABLE{idx}_MVY")
    m = {}
    for i, xy in enumerate(zip(mvx, mvy)):
        m.setdefault(xy, (code[i], bits[i]))
    return m, (code[len(mvx)], bits[len(mvx)])


# ff_v2_mb_type / ff_v2_intra_cbpc (msmpeg4data.c)
V2_MB_TYPE = [(1, 1), (0, 2), (3, 3), (9, 5), (5, 4), (0x21, 7),
              (0x20, 7), (0x11, 6)]
V2_INTRA_CBPC = [(1, 1), (0, 3), (1, 3), (1, 2)]


def _v2_dc_code(level: int, luma: bool) -> Tuple[int, int]:
    """The v1/v2 unified DC code of level (-256..255), built as
    msmpeg4.c init_h263_dc_for_msmpeg4 builds it."""
    v = abs(level)
    size = v.bit_length()
    mant = (-level) ^ ((1 << size) - 1) if level < 0 else level
    code, ln = (T.DC_LUM if luma else T.DC_CHROM)[size]
    code ^= (1 << ln) - 1
    if size > 0:
        code = (code << size) | mant
        ln += size
        if size > 8:
            code = (code << 1) | 1
            ln += 1
    return code, ln


class MSMPEG4Writer:
    """MSMPEG4 pictures over a fixed geometry. version 2, 3 or 4 (WMV1).
    bitrate is the header's kbit/s field (WMV1 reads per-MB RL selection
    above 50, and refuses inter-intra prediction below 128 kbit/s at
    sizes under 320x240); slices the I pictures' slice count."""

    def __init__(self, width: int, height: int, seed: int, version: int,
                 bitrate: int = 400, slices: int = 1,
                 per_mb_rl: bool = False):
        self.width, self.height = width, height
        self.mb_w, self.mb_h = (width + 15) >> 4, (height + 15) >> 4
        self.rng = np.random.default_rng(seed)
        self.version = version
        self.bitrate, self.slices = bitrate, slices
        self.per_mb_rl = per_mb_rl and bitrate > 50
        self.flipflop = 1
        self.rl = self.rl_chroma = self.mb_rl = 0
        self.used = collections.Counter()     # syntax forms written
        # with per-MB RL selection, MB 0 codes a luma block, which sets
        # the first RL index; False leaves MB 0 uncoded instead
        self.first_rl = True

    # -- headers ------------------------------------------------------- #

    def _header(self, pb, pict_type: int, qscale: int):
        rng = self.rng
        pb.put_bits(2, pict_type)              # 0 I, 1 P
        pb.put_bits(5, qscale)
        if self.version == 2:
            self.rl = self.rl_chroma = 2
        self.esc3 = None
        self.use_skip = 0
        if pict_type == 0:
            pb.put_bits(5, 0x16 + self.slices)
            self.slice_height = self.mb_h // self.slices
            if self.version == 2:
                return
            if self.version == 4:
                pb.put_bits(5, 25)             # fps
                pb.put_bits(11, self.bitrate)
                pb.put_bits(1, self.flipflop)
                self.mb_rl = 0
                if self.bitrate > 50:
                    self.mb_rl = int(self.per_mb_rl)
                    pb.put_bits(1, self.mb_rl)
            else:
                self.mb_rl = 0
            if not self.mb_rl:
                self.rl_chroma = int(rng.integers(0, 3))
                self.rl = int(rng.integers(0, 3))
                _put012(pb, self.rl_chroma)
                _put012(pb, self.rl)
            self.dc_idx = int(rng.integers(0, 2))
            pb.put_bits(1, self.dc_idx)
            return
        self.slice_height = self.mb_h
        self.use_skip = int(rng.random() < 0.8)
        pb.put_bits(1, self.use_skip)
        if self.version == 2:
            return
        if self.version == 4 and self.bitrate > 50:
            self.mb_rl = int(self.per_mb_rl and rng.random() < 0.5)
            pb.put_bits(1, self.mb_rl)
        else:
            self.mb_rl = 0
        if not self.mb_rl:
            self.rl = int(rng.integers(0, 3))
            _put012(pb, self.rl)
            self.rl_chroma = self.rl
        self.dc_idx = int(rng.integers(0, 2))
        pb.put_bits(1, self.dc_idx)
        self.mv_idx = int(rng.integers(0, 2))
        pb.put_bits(1, self.mv_idx)

    # -- blocks ---------------------------------------------------------- #

    def _dc(self, pb, b: int, mb_x: int, mb_y: int, qscale: int,
            first_line: bool, want: float):
        """Code the block's DC level nearest want (in pixels) against the
        decoders' predictor, and store it in the DC grid as they do."""
        luma = b < 4
        if self.version == 2:
            scale = 8
        elif self.version == 4:
            tab = M.WMV1_Y_DC_SCALE if luma else M.WMV1_C_DC_SCALE
            scale = tab[min(max(qscale, 1), 31)]
        else:
            scale = mpeg4_dc_scaler(qscale, luma)
        if luma:
            bx, by = 2 * mb_x + (b & 1) + 1, 2 * mb_y + (b >> 1) + 1
            grid = self.dcg[0]
        else:
            bx, by = mb_x + 1, mb_y + 1
            grid = self.dcg[1 if b == 4 else 2]
        a, bb, c = (int(grid[by, bx - 1]), int(grid[by - 1, bx - 1]),
                    int(grid[by - 1, bx]))
        if self.version != 4 and first_line and (b & 2) == 0:
            bb = c = 1024
        a, bb, c = ((x + (scale >> 1)) // scale for x in (a, bb, c))
        if self.version == 4:
            pred = c if abs(a - bb) < abs(bb - c) else a
        else:
            pred = c if abs(a - bb) <= abs(bb - c) else a
        lo = max(0, pred - (256 if self.version == 2 else 255))
        level = min(max(int(round(want * 8 / scale)), lo), pred + 255)
        if self.rng.random() < 0.02:           # an escape-sized step
            level = pred + 150
        diff = level - pred
        if self.version == 2:
            code, ln = _v2_dc_code(diff, luma)
            pb.put_bits(ln, code)
        else:
            pairs = getattr(M, "TABLE%d_DC_%s" % (
                self.dc_idx, "LUM" if luma else "CHROMA"))
            a = abs(diff)
            if a >= 119:
                self.used["dc escape"] += 1
                code, ln = pairs[119]
                pb.put_bits(ln, code)
                pb.put_bits(8, a)
                pb.put_bits(1, 1 if diff < 0 else 0)
            else:
                code, ln = pairs[a]
                pb.put_bits(ln, code)
                if a:
                    pb.put_bits(1, 1 if diff < 0 else 0)
        grid[by, bx] = level * scale

    def _ac(self, pb, coeffs, start: int, rl_idx: int, qscale: int):
        enc, esc, lmax, rmax = _rl_code(rl_idx)
        run_diff = 1 if self.version == 4 else \
            (0 if start or self.version == 2 else 1)
        for last, run, level in _runs(coeffs, start):
            a, sign = abs(level), 1 if level < 0 else 0
            key = (last, run, a)
            forms = []
            if key in enc:
                forms.append("vlc")
            l1 = a - lmax.get((last, run), 0)
            if (last, run) in lmax and l1 > 0 and (last, run, l1) in enc:
                forms.append("esc1")
            r2 = run - rmax.get((last, a), 0) - run_diff
            if (last, a) in rmax and r2 >= 0 and (last, r2, a) in enc:
                forms.append("esc2")
            if self.version == 4 or a < 128:
                forms.append("esc3")
            form = forms[0] if forms[0] == "vlc" and \
                self.rng.random() < 0.9 else \
                forms[int(self.rng.integers(0, len(forms)))]
            self.used[form] += 1
            if form == "vlc":
                code, bits = enc[key]
                pb.put_bits(bits, code)
                pb.put_bits(1, sign)
                continue
            pb.put_bits(esc[1], esc[0])
            if form == "esc1":
                pb.put_bits(1, 1)
                code, bits = enc[(last, run, l1)]
                pb.put_bits(bits, code)
                pb.put_bits(1, sign)
            elif form == "esc2":
                pb.put_bits(2, 0b01)
                code, bits = enc[(last, r2, a)]
                pb.put_bits(bits, code)
                pb.put_bits(1, sign)
            else:
                pb.put_bits(2, 0b00)
                pb.put_bits(1, last)
                if self.version != 4:
                    pb.put_bits(6, run)
                    pb.put_sbits(8, level)
                    continue
                if self.esc3 is None:
                    # level width 8, run width 6, signalled once a picture
                    if qscale < 8:
                        pb.put_bits(3, 0)
                        pb.put_bits(1, 0)
                    else:
                        pb.put_bits(6, 0)
                    pb.put_bits(2, 3)
                    self.esc3 = (8, 6)
                pb.put_bits(self.esc3[1], run)
                pb.put_bits(1, sign)
                pb.put_bits(self.esc3[0], a)

    # -- macroblocks ----------------------------------------------------- #

    def _motion(self, pb, px: int, py: int, pan):
        rng = self.rng
        v = []
        for p, c in zip((px, py), pan):
            d = max(-31, min(31, c + int(rng.integers(-3, 4)) - p))
            d = max(-63 - p, min(63 - p, d))
            v.append(p + d)
        if self.version == 2:
            for c, p in zip(v, (px, py)):
                d = c - p
                code, bits = T.MVTAB[abs(d)]
                pb.put_bits(bits, code)
                if d:
                    pb.put_bits(1, 1 if d < 0 else 0)
            return v
        m, esc = _mv_code(self.mv_idx)
        raw = (v[0] - px + 32, v[1] - py + 32)
        if raw in m and rng.random() < 0.9:
            pb.put_bits(m[raw][1], m[raw][0])
        else:
            self.used["mv escape"] += 1
            pb.put_bits(esc[1], esc[0])
            pb.put_bits(6, raw[0])
            pb.put_bits(6, raw[1])
        return v

    def picture(self, planes: Planes, pict_type: int, qscale: int,
                pan: Tuple[int, int] = (0, 0)) -> bytes:
        rng = self.rng
        pb = PutBits()
        self._header(pb, pict_type, qscale)
        mw, mh = self.mb_w, self.mb_h
        means = _block_means(planes, mw, mh)
        pred = _VopPred(mw, mh)
        self.dcg = (pred.dc_y, pred.dc_u, pred.dc_v)
        cbg = np.zeros((2 * mh + 1, 2 * mw + 1), np.int8)
        for mb_y in range(mh):
            if mb_y and mb_y % self.slice_height == 0:
                pred.resync(0, mb_y)
            for mb_x in range(mw):
                idx = mb_y * mw + mb_x
                r = rng.random()
                if pict_type and self.use_skip and r < 0.4:
                    self.used["skip"] += 1
                    pb.put_bits(1, 1)
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, 0, 0)
                    continue
                if pict_type and self.use_skip:
                    pb.put_bits(1, 0)
                intra = not pict_type or r > 0.9
                cbp = int(rng.integers(0, 64)) & int(rng.integers(0, 64))
                if self.mb_rl and idx == 0:
                    cbp = cbp | 0x20 if self.first_rl else 0
                self.used["intra" if intra else "inter"] += 1
                self._mb_type(pb, pict_type, intra, cbp, mb_x, mb_y, cbg)
                if not intra:
                    if self.version == 2:
                        px, py = pred.grid_pred(mb_x, mb_y, 0)
                        v = self._motion(pb, px, py, pan)
                    else:
                        if self.mb_rl and cbp:
                            self.rl = int(rng.integers(0, 3))
                            self.rl_chroma = self.rl
                            _put012(pb, self.rl)
                        px, py = pred.grid_pred(mb_x, mb_y, 0)
                        v = self._motion(pb, px, py, pan)
                    for k in range(4):
                        pred.grid_put(mb_x, mb_y, k, v[0], v[1])
                else:
                    if pict_type:
                        for k in range(4):
                            pred.grid_put(mb_x, mb_y, k, 0, 0)
                    if self.version != 2:
                        pb.put_bits(1, int(rng.random() < 0.3))  # ac_pred
                        if self.mb_rl and cbp:
                            self.rl = int(rng.integers(0, 3))
                            self.rl_chroma = self.rl
                            _put012(pb, self.rl)
                first_line = pred.first_line(mb_x, mb_y)
                for b in range(6):
                    coded = (cbp >> (5 - b)) & 1
                    if intra:
                        self._dc(pb, b, mb_x, mb_y, qscale, first_line,
                                 means[idx, b])
                        rl_idx = self.rl if b < 4 else 3 + self.rl_chroma
                        start = 1
                    else:
                        rl_idx = 3 + (self.rl_chroma if self.version == 2
                                      else self.rl)
                        start = 0
                    if coded:
                        self._ac(pb, _coefficients(
                            rng, start, 0.05,
                            255 if self.version == 4 else 127),
                            start, rl_idx, qscale)
        if pict_type == 0 and self.version in (2, 3):
            pb.put_bits(5, 25)                 # extension header: fps
            pb.put_bits(11, self.bitrate)
            if self.version == 3:
                pb.put_bits(1, self.flipflop)
        pb.align(pad_bit=0)
        return pb.flush()

    def _mb_type(self, pb, pict_type, intra, cbp, mb_x, mb_y, cbg):
        if self.version == 2:
            cbpc, cbpy = cbp & 3, cbp >> 2
            if pict_type:
                code, bits = V2_MB_TYPE[(4 if intra else 0) + cbpc]
            else:
                code, bits = V2_INTRA_CBPC[cbpc]
            pb.put_bits(bits, code)
            if intra:
                pb.put_bits(1, int(self.rng.random() < 0.3))  # ac_pred
                code, bits = T.CBPY[cbpy]
            else:
                code, bits = T.CBPY[cbpy if cbpc == 3 else cbpy ^ 0xF]
            pb.put_bits(bits, code)
            return
        if pict_type:
            code, bits = M.MB_NON_INTRA[(0 if intra else 0x40) | cbp]
            pb.put_bits(bits, code)
            return
        sym = 0
        for i in range(6):
            val = (cbp >> (5 - i)) & 1
            if i < 4:
                bx = 2 * mb_x + (i & 1) + 1
                by = 2 * mb_y + (i >> 1) + 1
                a, b, c = cbg[by, bx - 1], cbg[by - 1, bx - 1], \
                    cbg[by - 1, bx]
                cbg[by, bx] = val
                val ^= int(a if b == c else c)
            sym |= val << (5 - i)
        code, bits = M.MB_I[sym]
        pb.put_bits(bits, code)


def msmpeg4_stream(frames: Sequence[Planes], seed: int, version: int,
                   width: int, height: int, qscale: int = 8,
                   gop: int = 0, used=None, **kw) -> List[bytes]:
    """MSMPEG4 v2/v3/WMV1 packets of frames: I then P pictures (an I every
    gop pictures if gop); used as for h263_stream."""
    w = MSMPEG4Writer(width, height, seed, version, **kw)
    out = [w.picture(planes, 0 if t == 0 or (gop and t % gop == 0) else 1,
                     qscale, pan=(2 * t, -t))
           for t, planes in enumerate(frames)]
    if used is not None:
        used.update(w.used)
    return out
