"""AC-3 decoder (reference: libavcodec/ac3dec.c ac3_decode_frame ->
decode_audio_block -> do_imdct :641 — SURVEY.md §3.4).

Full A/52 block decode: channel coupling (coupling_strategy /
coupling_coordinates / calc_transform_coeffs_cpl), stereo rematrixing,
block switching (dual 256-point transforms), zero-bap dither with the
reference's lagged-Fibonacci PRNG, delta bit allocation, and bsid 9/10
half/quarter sample rates.  Mantissas are reconstructed in the
reference's 1.24 fixed-point convention (symmetric_dequant with integer
truncation, coefficients = mantissa >> exponent) so the float output
tracks the reference decoder to rounding error.

Counterpart of `libav_tpu/codecs/ac3/dec.py`, copied: the whole decode,
its float64 IMDCT (`ops/fftmdct.imdct_host`) included, runs on the host
in both packages, so the port's output equals the JAX package's. The
decoder takes a device like every decoder of the port and keeps its
frames (float planes, numpy) on the host."""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np

from libav_tpu_torch.avutil import hwdevice, log
from libav_tpu_torch.avutil.error import AVError, INVALIDDATA
from libav_tpu_torch.avutil.frame import Frame, Packet
from libav_tpu_torch.avutil.samplefmt import default_channel_layout
from libav_tpu_torch.bitstream import GetBits
from libav_tpu_torch.codecs.api import Decoder, MediaType, register_codec
from libav_tpu_torch.codecs.ac3 import bitalloc, eac3, tables as T
from libav_tpu_torch.codecs.ac3 import eac3_tables as E

EXP_REUSE, EXP_D15, EXP_D25, EXP_D45 = 0, 1, 2, 3
DBA_NONE, DBA_REUSE, DBA_NEW, DBA_RESERVED = 0, 1, 2, 3
CPL = -1          # coupling-channel key

# A/52 §7.5.2 rematrixing band edges (ff_ac3_rematrix_band_tab)
REMATRIX_BANDS = [13, 25, 37, 61, 253]


class LFG:
    """av_lfg lagged-Fibonacci PRNG (libavutil/lfg.c): 64-word state
    seeded via MD5, state[i] = state[i-24] + state[i-55] mod 2^32.
    Bit-exact replication is required for zero-bap dither parity."""

    def __init__(self, seed: int = 0):
        self.state = [0] * 64
        tmp = bytearray(16)          # REUSED across iterations: each MD5
        for i in range(8, 64, 4):    # input is the previous digest with
            tmp[0:4] = int(seed).to_bytes(4, "little")   # seed+i patched
            tmp[4] = i
            tmp[:] = hashlib.md5(bytes(tmp)).digest()
            for k in range(4):
                self.state[i + k] = int.from_bytes(
                    tmp[4 * k:4 * k + 4], "little")
        self.index = 0

    def get(self) -> int:
        i = self.index
        v = (self.state[(i - 24) & 63] + self.state[(i - 55) & 63]) \
            & 0xFFFFFFFF
        self.state[i & 63] = v
        self.index += 1
        return v


def _sym(code: int, levels: int) -> float:
    """A/52 symmetric quantizer reconstruction level (float, spec
    convention) — used by the encoder's quantizer decisions."""
    return (2 * code - (levels - 1)) / levels


def _symmetric_dequant(code: int, levels: int) -> int:
    """reference: ac3dec.c:112 — 1.24 fixed point, C int division
    (truncation toward zero)."""
    num = (code - (levels >> 1)) << 24
    q = abs(num) // levels
    return -q if num < 0 else q


def _build_mant_tables():
    b1 = np.zeros((32, 3), dtype=np.int64)
    for i in range(32):
        b1[i] = [_symmetric_dequant(i // 9, 3),
                 _symmetric_dequant((i % 9) // 3, 3),
                 _symmetric_dequant(i % 3, 3)]
    b2 = np.zeros((128, 3), dtype=np.int64)
    for i in range(128):
        b2[i] = [_symmetric_dequant(i // 25, 5),
                 _symmetric_dequant((i % 25) // 5, 5),
                 _symmetric_dequant(i % 5, 5)]
    # invalid-code behavior must track the reference exactly: its init
    # (ac3dec.c:152-158) fills only the 7/15 valid b3/b5 codes (the rest
    # decode as 0) but computes b4 for all 128 group codes (codes >= 121
    # extrapolate via symmetric_dequant(11, 11)).
    b3 = np.zeros(8, dtype=np.int64)
    b3[:7] = [_symmetric_dequant(i, 7) for i in range(7)]
    b4 = np.zeros((128, 2), dtype=np.int64)
    for i in range(128):
        b4[i] = [_symmetric_dequant(i // 11, 11),
                 _symmetric_dequant(i % 11, 11)]
    b5 = np.zeros(16, dtype=np.int64)
    b5[:15] = [_symmetric_dequant(i, 15) for i in range(15)]
    return b1, b2, b3, b4, b5


_B1, _B2, _B3, _B4, _B5 = _build_mant_tables()


def decode_exponents(gb: GetBits, strategy: int, absexp: int,
                     ngrps: int) -> np.ndarray:
    """A/52 §7.1.3 grouped differential exponents: returns the chain of
    3*group_size*ngrps exponents following the absolute predictor."""
    group_size = {EXP_D15: 1, EXP_D25: 2, EXP_D45: 4}[strategy]
    out = np.zeros(ngrps * 3 * group_size, dtype=np.int32)
    prev = absexp
    pos = 0
    for _ in range(ngrps):
        code = gb.get_bits(7)
        if code >= 125:
            raise AVError(INVALIDDATA, "bad exponent group")
        for d in (code // 25, (code % 25) // 5, code % 5):
            prev += d - 2
            if prev < 0 or prev > 24:
                raise AVError(INVALIDDATA, "exponent out-of-range")
            out[pos:pos + group_size] = prev
            pos += group_size
    return out


class _MantState:
    def __init__(self):
        self.b1 = self.b2 = self.b4 = 0
        self.b1_mant = [0, 0]
        self.b2_mant = [0, 0]
        self.b4_mant = 0


@register_codec
class AC3Decoder(Decoder):
    NAME = "ac3"
    TYPE = MediaType.AUDIO
    LONG_NAME = "ATSC A/52 AC-3 (host IMDCT)"

    def __init__(self, params=None, options=None, *, device):
        super().__init__(params, options)
        self.device = hwdevice.device(device)

    def _init(self):
        self._delay = None                 # (nch, 128) raw half overlap
        self._dith = LFG(0)

    def _flush(self):
        self._delay = None
        self._dith = LFG(0)

    def _decode(self, pkt: Packet) -> List[Frame]:
        frames = []
        data = pkt.data
        pos = 0
        while pos + 8 <= len(data):
            sync = data.find(b"\x0b\x77", pos)
            if sync < 0:
                break
            f = self._decode_syncframe(data[sync:])
            if f is None:
                break
            frame, consumed = f
            if frame is not None:       # None = skipped E-AC-3 substream
                frame.pts = pkt.pts if not frames else frame.pts
                frame.time_base = pkt.time_base
                frames.append(frame)
            pos = sync + consumed
        return frames

    # ------------------------------------------------------------------ #

    def _decode_syncframe(self, data: bytes):
        gb = GetBits(data)
        if gb.get_bits(16) != 0x0B77:
            raise AVError(INVALIDDATA, "bad AC-3 sync word")
        bsid_peek = (data[5] >> 3) & 0x1F
        if bsid_peek > 16:
            raise AVError(INVALIDDATA, f"invalid bsid {bsid_peek}")
        num_blocks = 6
        e = None                    # E-AC-3 per-frame syntax state
        if bsid_peek <= 10:
            gb.get_bits(16)         # crc1 (not verified)
            fscod = gb.get_bits(2)
            frmsizecod = gb.get_bits(6)
            if fscod == 3 or frmsizecod >= 38:
                raise AVError(INVALIDDATA, "bad fscod/frmsizecod")
            frame_bytes = int(T.FRAME_SIZE[frmsizecod][fscod]) * 2
            if len(data) < frame_bytes:
                return None

            bsid = gb.get_bits(5)
            sr_shift = max(bsid - 8, 0)
            sample_rate = int(T.SAMPLE_RATES[fscod]) >> sr_shift
            gb.get_bits(3)          # bsmod
            acmod = gb.get_bits(3)
            nfchans = int(T.CHANNELS[acmod])
            if acmod & 1 and acmod != 1:
                gb.get_bits(2)      # cmixlev
            if acmod & 4:
                gb.get_bits(2)      # surmixlev
            if acmod == 2:
                gb.get_bits(2)      # dsurmod
            lfeon = gb.get_bits(1)
            gb.get_bits(5)          # dialnorm
            if gb.get_bits(1):
                gb.get_bits(8)      # compr
            if gb.get_bits(1):
                gb.get_bits(8)      # langcod
            if gb.get_bits(1):
                gb.get_bits(7)      # mixlevel + roomtyp
            if acmod == 0:
                gb.get_bits(5)
                if gb.get_bits(1):
                    gb.get_bits(8)
                if gb.get_bits(1):
                    gb.get_bits(8)
                if gb.get_bits(1):
                    gb.get_bits(7)
            gb.get_bits(2)          # copyrightb + origbs
            if gb.get_bits(1):
                gb.get_bits(14)     # timecod1
            if gb.get_bits(1):
                gb.get_bits(14)     # timecod2
            if gb.get_bits(1):      # addbsie
                n = gb.get_bits(6)
                gb.skip_bits((n + 1) * 8)
            frame_type = eac3.FRAME_TYPE_AC3_CONVERT
        else:
            # E-AC-3 BSI (reference: ac3_parser.c :112, eac3dec.c
            # ff_eac3_parse_header)
            frame_type = gb.get_bits(2)
            if frame_type == eac3.FRAME_TYPE_RESERVED:
                raise AVError(INVALIDDATA, "reserved E-AC-3 frame type")
            substreamid = gb.get_bits(3)
            frame_bytes = (gb.get_bits(11) + 1) * 2
            if len(data) < frame_bytes:
                return None
            fscod = gb.get_bits(2)
            if fscod == 3:
                raise AVError(INVALIDDATA,
                              "E-AC-3 reduced sampling rates not supported")
            num_blocks = eac3.EAC3_BLOCKS[gb.get_bits(2)]
            sample_rate = int(T.SAMPLE_RATES[fscod])
            sr_shift = 0
            acmod = gb.get_bits(3)
            lfeon = gb.get_bits(1)
            gb.get_bits(5)          # bsid (peeked already)
            nfchans = int(T.CHANNELS[acmod])
            if frame_type == eac3.FRAME_TYPE_DEPENDENT or substreamid:
                # only independent substream 0 is decoded (like reference)
                return None, frame_bytes
            e = eac3.parse_frame_header(
                gb, acmod, lfeon, num_blocks, frame_type, fscod,
                nfchans, nfchans, frame_bytes)

        lfe_ch = nfchans            # row index of LFE when present
        nrows = nfchans + (1 if lfeon else 0)

        # persistent per-frame channel state (CPL rides under key CPL)
        st = {
            "exps": {ch: np.zeros(256, dtype=np.int32)
                     for ch in list(range(nrows)) + [CPL]},
            "start": {ch: 0 for ch in range(nrows)},
            "end": {ch: (7 if lfeon and ch == lfe_ch else 253)
                    for ch in range(nrows)},
            "exp_strategy": {},
            "snr_offset": {ch: 0 for ch in list(range(nrows)) + [CPL]},
            "fast_gain": {ch: int(T.FAST_GAIN[4])
                          for ch in list(range(nrows)) + [CPL]},
            "ba": dict(sdcycod=2, fdcycod=1, sgaincod=1, dbpbcod=2,
                       floorcod=7),
            "cpl_in_use": False,
            "chincpl": [False] * nfchans,
            "phsflginu": False,
            "num_cpl_bands": 0,
            "cpl_band_sizes": [],
            "cpl_coords": np.zeros((nfchans, 18), dtype=np.int64),
            "phase_flags": [0] * 18,
            "cpl_leak": (0, 0),
            "dba_mode": {ch: DBA_NONE
                         for ch in list(range(nrows)) + [CPL]},
            "dba": {},
            "dynrng": 1.0,
            # E-AC-3 syntax state (AC-3 defaults per ac3dec.c :311)
            "e": e,
            "frame_type": frame_type,
            "blksw": [0] * nfchans,
            "dith": [1] * nfchans,
            "block_switch_syntax": True if e is None
                                   else bool(e["block_switch_syntax"]),
            "dither_flag_syntax": True if e is None
                                  else bool(e["dither_flag_syntax"]),
            "bit_allocation_syntax": True if e is None
                                     else bool(e["bit_allocation_syntax"]),
            "fast_gain_syntax": False if e is None
                                else bool(e["fast_gain_syntax"]),
            "dba_syntax": True if e is None else bool(e["dba_syntax"]),
            "skip_syntax": True if e is None else bool(e["skip_syntax"]),
            "snr_offset_strategy": 2 if e is None
                                   else e["snr_offset_strategy"],
            "first_cpl_leak": e is not None,
            "first_cpl_coords": [True] * nfchans,
            "spx_in_use": False,
            "chinspx": [False] * nfchans,
            "first_spx_coords": [True] * nfchans,
            "spx_noise_blend": np.zeros((nfchans, 18), dtype=np.float32),
            "spx_signal_blend": np.zeros((nfchans, 18), dtype=np.float32),
            "aht": {} if e is None else e["aht"],
            "pre_mant": {},
        }
        st["start"][CPL] = 0
        st["end"][CPL] = 0
        if e is not None and e["frame_snr_offset"] is not None:
            for ch in list(range(nrows)) + [CPL]:
                st["snr_offset"][ch] = e["frame_snr_offset"]

        out = np.zeros((nrows, 256 * num_blocks), dtype=np.float64)
        if self._delay is None or self._delay.shape[0] != nrows:
            self._delay = np.zeros((nrows, 128), dtype=np.float64)

        for blk in range(num_blocks):
            self._decode_block(gb, blk, st, nfchans, nrows, lfeon, lfe_ch,
                               acmod, fscod, sr_shift,
                               out[:, blk * 256:(blk + 1) * 256])

        # AC-3 channel order -> default layout order (FL FR FC LFE BL BR)
        if acmod == 7:
            order = [0, 2, 1] + ([lfe_ch] if lfeon else []) + [3, 4]
        elif lfeon:
            order = list(range(nfchans)) + [lfe_ch]
        else:
            order = list(range(nfchans))
        frame = Frame(nb_samples=256 * num_blocks, sample_rate=sample_rate,
                      format="fltp", channels=nrows,
                      channel_layout=default_channel_layout(nrows))
        frame.planes = [out[c].astype(np.float32) for c in order]
        return frame, frame_bytes

    # ------------------------------------------------------------------ #

    def _decode_block(self, gb, blk, st, nfchans, nrows, lfeon, lfe_ch,
                      acmod, fscod, sr_shift, out):
        """reference: ac3dec.c decode_audio_block (s->eac3 branches
        included — eac3dec.c ff_eac3_parse_header feeds st["e"])"""
        fh = st["e"]                # E-AC-3 frame header state, or None
        eac3_mode = fh is not None
        if st["block_switch_syntax"]:
            st["blksw"] = [gb.get_bits(1) for _ in range(nfchans)]
        blksw = st["blksw"]
        if st["dither_flag_syntax"]:
            st["dith"] = [gb.get_bits(1) for _ in range(nfchans)]
        dith = st["dith"]
        i = 1 if acmod == 0 else 0
        while True:
            if gb.get_bits(1):
                v = gb.get_bits(8)
                e = (v >> 5) - ((v >> 7) << 3) - 5
                st["dynrng"] = (2.0 ** e) * ((v & 0x1F) | 0x20)
            elif blk == 0:
                st["dynrng"] = 1.0
            if i == 0:
                break
            i -= 1

        # ---- spectral extension strategy + coordinates (E-AC-3) ----
        if eac3_mode and (blk == 0 or gb.get_bits(1)):
            st["spx_in_use"] = bool(gb.get_bits(1))
            if st["spx_in_use"]:
                eac3.spx_strategy(gb, blk, acmod, nfchans, st)
            else:
                st["chinspx"] = [False] * nfchans
                st["first_spx_coords"] = [True] * nfchans
        if st["spx_in_use"]:
            eac3.spx_coordinates(gb, nfchans, st)

        # ---- coupling strategy ----
        if (fh["cpl_strategy_exists"][blk] if eac3_mode
                else gb.get_bits(1)):
            if eac3_mode:
                st["cpl_in_use"] = fh["cpl_in_use_frame"][blk]
            else:
                st["cpl_in_use"] = bool(gb.get_bits(1))
            if st["cpl_in_use"]:
                if acmod < 2:
                    raise AVError(INVALIDDATA, "coupling in mono")
                if eac3_mode and gb.get_bits(1):
                    raise AVError(INVALIDDATA,
                                  "enhanced coupling not supported")
                if eac3_mode and acmod == 2:
                    st["chincpl"] = [True, True]
                else:
                    st["chincpl"] = [bool(gb.get_bits(1))
                                     for _ in range(nfchans)]
                if acmod == 2:
                    st["phsflginu"] = bool(gb.get_bits(1))
                cplbegf = gb.get_bits(4)
                if st["spx_in_use"]:
                    cplendf = (st["spx_src_start"] - 37) // 12
                else:
                    cplendf = gb.get_bits(4) + 3
                if cplbegf >= cplendf:
                    raise AVError(INVALIDDATA, "bad coupling range")
                st["start"][CPL] = cplbegf * 12 + 37
                st["end"][CPL] = cplendf * 12 + 37
                prev = (st["num_cpl_bands"], st["cpl_band_sizes"])
                st["num_cpl_bands"], st["cpl_band_sizes"] = \
                    eac3.band_structure(gb, blk, eac3_mode, cplbegf,
                                        cplendf,
                                        E.DEFAULT_CPL_BAND_STRUCT, prev)
            else:
                st["chincpl"] = [False] * nfchans
                st["first_cpl_coords"] = [True] * nfchans
                st["first_cpl_leak"] = eac3_mode
                st["phsflginu"] = False
        elif not eac3_mode:
            if blk == 0:
                raise AVError(INVALIDDATA,
                              "coupling strategy must be present in block 0")
        cpl_in_use = st["cpl_in_use"]

        # ---- coupling coordinates ----
        if cpl_in_use:
            coords_exist = False
            for ch in range(nfchans):
                if not st["chincpl"][ch]:
                    st["first_cpl_coords"][ch] = True
                    continue
                if (eac3_mode and st["first_cpl_coords"][ch]) \
                        or gb.get_bits(1):   # cplcoe
                    st["first_cpl_coords"][ch] = False
                    coords_exist = True
                    mstr = 3 * gb.get_bits(2)
                    for bnd in range(st["num_cpl_bands"]):
                        cexp = gb.get_bits(4)
                        cmant = gb.get_bits(4)
                        if cexp == 15:
                            v = cmant << 22
                        else:
                            v = (cmant + 16) << 21
                        st["cpl_coords"][ch][bnd] = v >> (cexp + mstr)
                elif blk == 0:
                    raise AVError(INVALIDDATA,
                                  "coupling coords missing in block 0")
            if acmod == 2 and coords_exist:
                for bnd in range(st["num_cpl_bands"]):
                    st["phase_flags"][bnd] = \
                        gb.get_bits(1) if st["phsflginu"] else 0

        # ---- rematrixing ----
        if acmod == 2:
            if (eac3_mode and blk == 0) or gb.get_bits(1):  # rematstr
                nbnd = 4
                if cpl_in_use and st["start"][CPL] <= 61:
                    nbnd -= 1 + (st["start"][CPL] == 37)
                elif st["spx_in_use"] and st["spx_src_start"] <= 61:
                    nbnd -= 1
                st["num_remat"] = nbnd
                st["remat_flags"] = [gb.get_bits(1) for _ in range(nbnd)]
            elif blk == 0:
                st["num_remat"] = 0
                st["remat_flags"] = []

        # ---- exponent strategies ----
        chans = ([CPL] if cpl_in_use else []) + list(range(nrows))
        estrat = {}
        for ch in chans:
            if eac3_mode:
                estrat[ch] = fh["exp_strategy"][blk].get(ch, EXP_REUSE)
            else:
                bits = 1 if (lfeon and ch == lfe_ch) else 2
                estrat[ch] = gb.get_bits(bits)

        # ---- channel bandwidth ----
        for ch in range(nfchans):
            if estrat[ch] != EXP_REUSE:
                if st["chincpl"][ch]:
                    st["end"][ch] = st["start"][CPL]
                elif st["chinspx"][ch]:
                    st["end"][ch] = st["spx_src_start"]
                else:
                    bwcod = gb.get_bits(6)
                    if bwcod > 60:
                        raise AVError(INVALIDDATA, "bandwidth code > 60")
                    st["end"][ch] = bwcod * 3 + 73

        # ---- exponents ----
        for ch in chans:
            if estrat[ch] == EXP_REUSE:
                continue
            gs = 3 << (estrat[ch] - 1)
            if ch == CPL:
                absexp = gb.get_bits(4) << 1
                ngrps = (st["end"][CPL] - st["start"][CPL]) // gs
                st["exps"][CPL][st["start"][CPL]:st["start"][CPL] +
                                ngrps * gs] = decode_exponents(
                    gb, estrat[ch], absexp, ngrps)[:ngrps * gs]
            else:
                end = st["end"][ch]
                absexp = gb.get_bits(4)
                ngrps = (end + gs - 4) // gs
                chain = decode_exponents(gb, estrat[ch], absexp, ngrps)
                st["exps"][ch][0] = absexp
                st["exps"][ch][1:end] = chain[:end - 1]
                if ch != lfe_ch or not lfeon:
                    gb.get_bits(2)  # gainrng
        st["exp_strategy"] = estrat

        # ---- bit allocation info ----
        if st["bit_allocation_syntax"]:
            if gb.get_bits(1):
                st["ba"] = dict(sdcycod=gb.get_bits(2),
                                fdcycod=gb.get_bits(2),
                                sgaincod=gb.get_bits(2),
                                dbpbcod=gb.get_bits(2),
                                floorcod=gb.get_bits(3))
            elif blk == 0:
                raise AVError(INVALIDDATA,
                              "bit allocation info missing in block 0")

        # ---- snr offsets (+ fast gains for plain AC-3) ----
        if not eac3_mode or blk == 0:
            if st["snr_offset_strategy"] and gb.get_bits(1):
                csnr = (gb.get_bits(6) - 15) << 4
                snr = 0
                first = chans[0]
                for ch in chans:
                    if ch == first or st["snr_offset_strategy"] == 2:
                        snr = (csnr + gb.get_bits(4)) << 2
                    st["snr_offset"][ch] = snr
                    if not eac3_mode:
                        st["fast_gain"][ch] = \
                            int(T.FAST_GAIN[gb.get_bits(3)])
            elif not eac3_mode and blk == 0:
                raise AVError(INVALIDDATA,
                              "snr offsets missing in block 0")

        # ---- fast gain (E-AC-3) ----
        if st["fast_gain_syntax"] and gb.get_bits(1):
            for ch in chans:
                st["fast_gain"][ch] = int(T.FAST_GAIN[gb.get_bits(3)])
        elif eac3_mode and blk == 0:
            for ch in chans:
                st["fast_gain"][ch] = int(T.FAST_GAIN[4])

        # ---- E-AC-3 to AC-3 converter SNR offset ----
        if st["frame_type"] == eac3.FRAME_TYPE_INDEPENDENT \
                and gb.get_bits(1):
            gb.skip_bits(10)

        # ---- coupling leak ----
        if cpl_in_use:
            if st["first_cpl_leak"] or gb.get_bits(1):
                st["cpl_leak"] = (gb.get_bits(3), gb.get_bits(3))
            elif not eac3_mode and blk == 0:
                raise AVError(INVALIDDATA,
                              "coupling leak missing in block 0")
            st["first_cpl_leak"] = False

        # ---- delta bit allocation ----
        if st["dba_syntax"] and gb.get_bits(1):     # deltbaie
            dchans = ([CPL] if cpl_in_use else []) + list(range(nfchans))
            for ch in dchans:
                st["dba_mode"][ch] = gb.get_bits(2)
                if st["dba_mode"][ch] == DBA_RESERVED:
                    raise AVError(INVALIDDATA, "reserved dba strategy")
            for ch in dchans:
                if st["dba_mode"][ch] == DBA_NEW:
                    nseg = gb.get_bits(3) + 1
                    segs = []
                    for _ in range(nseg):
                        segs.append((gb.get_bits(5), gb.get_bits(4),
                                     gb.get_bits(3)))
                    st["dba"][ch] = segs
        elif blk == 0:
            for ch in list(range(nrows)) + [CPL]:
                st["dba_mode"][ch] = DBA_NONE

        # ---- bit allocation ----
        bap = {}
        for ch in chans:
            dba = st["dba"].get(ch) \
                if st["dba_mode"][ch] in (DBA_REUSE, DBA_NEW) else None
            bap[ch] = bitalloc.run_bit_alloc(
                st["exps"][ch], st["start"].get(ch, 0), st["end"][ch],
                fscod, fgaincod=None,
                fast_gain=st["fast_gain"][ch],
                snr_offset=st["snr_offset"][ch],
                is_lfe=(lfeon and ch == lfe_ch),
                cpl_leak=st["cpl_leak"] if ch == CPL else None,
                dba=dba, sr_shift=sr_shift,
                bap_tab=(E.HEBAP_TAB if st["aht"].get(ch) else None),
                **st["ba"])

        # ---- skip field ----
        if st["skip_syntax"] and gb.get_bits(1):
            skipl = gb.get_bits(9)
            gb.skip_bits(skipl * 8)

        # ---- transform coefficients (1.24 fixed) ----
        fixed = np.zeros((nrows, 256), dtype=np.int64)
        cpl_fixed = np.zeros(256, dtype=np.int64)
        cpl_bap = bap.get(CPL)
        m = _MantState()
        got_cpl = False

        def coeffs_ch(ch, dither):
            """reference: ac3dec.c decode_transform_coeffs_ch — AHT
            channels decode all 6 blocks of pre-mantissas at block 0."""
            s0, s1 = st["start"][ch], st["end"][ch]
            if st["aht"].get(ch):
                if blk == 0:
                    st["pre_mant"][ch] = eac3.decode_aht_ch(
                        gb, bap[ch], s0, s1, self._dith)
                pre = st["pre_mant"][ch]
                return pre[s0:s1, blk] >> st["exps"][ch][s0:s1]
            return self._decode_mants(gb, bap[ch], st["exps"][ch],
                                      s0, s1, dither, m)

        for ch in range(nrows):
            is_lfe_ch = lfeon and ch == lfe_ch
            dither = (not is_lfe_ch) and ch < nfchans and dith[ch]
            fixed[ch, st["start"][ch]:st["end"][ch]] = coeffs_ch(ch, dither)
            if ch < nfchans and st["chincpl"][ch]:
                if not got_cpl:
                    cpl_fixed[st["start"][CPL]:st["end"][CPL]] = \
                        coeffs_ch(CPL, True)
                    got_cpl = True
                # uncouple this channel
                bin0 = st["start"][CPL]
                for bnd in range(st["num_cpl_bands"]):
                    bend = bin0 + st["cpl_band_sizes"][bnd]
                    coord = int(st["cpl_coords"][ch][bnd]) << 5
                    seg = cpl_fixed[bin0:bend]
                    vals = ((seg << 4) * coord) >> 32
                    if ch == 1 and acmod == 2 and st["phase_flags"][bnd]:
                        vals = -vals
                    fixed[ch, bin0:bend] = vals
                    bin0 = bend

        # remove dithering from coupled channels that don't dither
        for ch in range(nfchans):
            if st["chincpl"][ch] and not dith[ch]:
                rng = slice(st["start"][CPL], st["end"][CPL])
                z = cpl_bap[st["start"][CPL]:st["end"][CPL]] == 0
                seg = fixed[ch, rng]
                seg[z] = 0
                fixed[ch, rng] = seg

        # ---- rematrixing ----
        if acmod == 2:
            end = min(st["end"][0], st["end"][1])
            for bnd in range(st.get("num_remat", 0)):
                if st.get("remat_flags", [])[bnd]:
                    b0 = REMATRIX_BANDS[bnd]
                    b1 = min(end, REMATRIX_BANDS[bnd + 1])
                    t = fixed[0, b0:b1].copy()
                    fixed[0, b0:b1] = t + fixed[1, b0:b1]
                    fixed[1, b0:b1] = t - fixed[1, b0:b1]

        # ---- scale to float, spectral extension, IMDCT ----
        gain = st["dynrng"] / 4194304.0
        coeffs = fixed.astype(np.float64) * gain
        if st["spx_in_use"]:
            eac3.apply_spectral_extension(st, coeffs, nfchans,
                                          fh["spx_atten_code"], self._dith)
        self._imdct_block(coeffs, blksw + [0] * (nrows - nfchans), out)

    # ------------------------------------------------------------------ #

    def _decode_mants(self, gb, bap, exps, start, end, dither,
                      m: _MantState) -> np.ndarray:
        """reference: ac3dec.c ac3_decode_transform_coeffs_ch (1.24
        fixed mantissa >> exponent)."""
        n = end - start
        out = np.zeros(n, dtype=np.int64)
        for k in range(n):
            freq = start + k
            b = int(bap[freq])
            if b == 0:
                if dither:
                    mant = (self._dith.get() // 362) - 5932275
                else:
                    mant = 0
            elif b == 1:
                if m.b1:
                    m.b1 -= 1
                    mant = m.b1_mant[m.b1]
                else:
                    bits = gb.get_bits(5)
                    mant = int(_B1[bits][0])
                    m.b1_mant = [int(_B1[bits][2]), int(_B1[bits][1])]
                    m.b1 = 2
            elif b == 2:
                if m.b2:
                    m.b2 -= 1
                    mant = m.b2_mant[m.b2]
                else:
                    bits = gb.get_bits(7)
                    mant = int(_B2[bits][0])
                    m.b2_mant = [int(_B2[bits][2]), int(_B2[bits][1])]
                    m.b2 = 2
            elif b == 3:
                mant = int(_B3[gb.get_bits(3)])
            elif b == 4:
                if m.b4:
                    m.b4 = 0
                    mant = m.b4_mant
                else:
                    bits = gb.get_bits(7)
                    mant = int(_B4[bits][0])
                    m.b4_mant = int(_B4[bits][1])
                    m.b4 = 1
            elif b == 5:
                mant = int(_B5[gb.get_bits(4)])
            else:
                nbits = int(T.BAP_BITS[b])
                raw = gb.get_sbits(nbits)
                mant = raw << (24 - nbits)
            out[k] = mant >> int(exps[freq])
        return out

    def _imdct_block(self, coeffs: np.ndarray, blksw, out):
        """One 256-sample block: IMDCT + KBD window TDAC butterfly
        against the 128-sample raw-half delay (reference: ac3dec.c
        do_imdct, float_dsp vector_fmul_window — restructured to full
        transforms; the half outputs are the middle half of the full
        IMDCT, see mdct_template.c ff_imdct_calc_c)."""
        from libav_tpu_torch.ops import fftmdct as F
        nch = coeffs.shape[0]
        w = F.kbd_window(512, alpha=5.0)[:256]     # 256-tap KBD half
        for ch in range(nch):
            # -64/-128 = (N/2)x(-1/2): ops/fftmdct's imdct carries 2/N
            # and the opposite sign of the reference's imdct_half
            if blksw[ch]:
                even = coeffs[ch, 0::2]
                odd = coeffs[ch, 1::2]
                g1 = F.imdct_host((even * -64.0)[None, :])[0]
                g2 = F.imdct_host((odd * -64.0)[None, :])[0]
                cur = g1[64:192]
                nxt = g2[64:192]
            else:
                g = F.imdct_host((coeffs[ch] * -128.0)[None, :])[0]
                cur = g[128:256]
                nxt = g[256:384]
            d = self._delay[ch]
            a = np.arange(128)
            out[ch, :128] = d * w[255 - a] - cur[127 - a] * w[a]
            out[ch, 128:] = d[127 - a] * w[127 - a] + cur * w[128 + a]
            self._delay[ch] = nxt


@register_codec
class EAC3Decoder(AC3Decoder):
    """E-AC-3 (ATSC A/52B Annex E) rides the unified AC-3 block decoder
    — the bsid>10 path of _decode_syncframe (reference: eac3dec.c is
    compiled into ac3dec.c the same way)."""
    NAME = "eac3"
    LONG_NAME = "ATSC A/52B E-AC-3 (host IMDCT)"
