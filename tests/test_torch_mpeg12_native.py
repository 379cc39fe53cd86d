"""The native MPEG-1/2 slice decoder (native/mpeg12_slice.c) against its
Python twin, MPEG1Decoder._decode_slice_py.

Slice by slice, from the same MBData start state (what the slices before
it left), both engines must leave byte-identical arrays and the same
outcome: success, or the same error at the same macroblock. The slices
come from the decoder's own header walk over real streams (the decode
tests' STREAMS, the two committed 1080-line streams, the hand-packed
field-DCT frame pictures), from those streams cut short or with bits
flipped (fixed seeds), and from a writer of random but well-formed slice
syntax that reaches every macroblock mode of both standards: frame, field
and dual-prime MC in frame pictures, whole-field, 16x8 and dual-prime MC
in field pictures, concealment vectors, escapes, MPEG-1 full_pel and D
pictures. The twin also decodes a field stream end to end against the JAX
decoder with the native library switched off.
"""

import copy
import zlib

import numpy as np
import pytest
import torch

from libav_tpu_torch import testdata
from libav_tpu_torch.avutil import timer
from libav_tpu_torch.avutil.error import AVError
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.bitstream import PutBits
from libav_tpu_torch.codecs.mpeg12 import tables as T
from libav_tpu_torch.codecs.mpeg12.dec import (MBData, MPEG2Decoder,
                                               PicContext, SeqContext)
from libav_tpu_torch.native import mpeg12_slice
from test_torch_mpeg12_decode import STREAMS
from tools.gen_torch_smoke_stream import encode

native = pytest.mark.skipif(not mpeg12_slice.available(),
                            reason="the native library did not build")
ARRAYS = [a[0] for a in mpeg12_slice.ARRAYS]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------- #
# pictures and slices of a stream
# ---------------------------------------------------------------------- #

_PACKETS = {}


def packets(name):
    """A stream's packets: STREAMS encoded once per process, the committed
    1080-line streams, or the hand-packed field-DCT P pictures after
    their reference I picture."""
    if name not in _PACKETS:
        if name in STREAMS:
            codec, w, h, n, settings = STREAMS[name]
            _PACKETS[name] = encode(w, h, n, codec, settings)
        elif name in testdata.MPEG2_SMOKE:
            _PACKETS[name] = testdata.read_packets(
                testdata.stream_paths(name)[0])
        else:
            from test_mpeg12 import TestInterlacedTools
            t = TestInterlacedTools()
            _PACKETS[name] = [t._ref_stream(), t._intra_p_stream(0),
                              t._intra_p_stream(1)]
    return _PACKETS[name]


def pictures(datas):
    """[(seq, pic, mb_h, [(code, seg), ...])] of every coded picture, from
    the decoder's own start-code walk and header parsers (its slice decode
    and reconstruction left out)."""
    dec = MPEG2Decoder(device="cpu")
    dec._init()
    out = []

    def finish(slices):
        out.append((copy.deepcopy(dec.seq), copy.deepcopy(dec.pic),
                    dec._cur_mb_h(), list(slices)))
        return []
    dec._finish_picture = finish
    for d in datas:
        dec._decode(Packet(data=d))
    return out


def twin(seq, pic):
    dec = MPEG2Decoder.__new__(MPEG2Decoder)
    dec.seq, dec.pic = seq, pic
    return dec


def outcome(fn):
    try:
        fn()
    except (AVError, OverflowError) as e:
        return type(e).__name__, str(e)
    return None


def copy_mb(mb):
    out = MBData(len(mb.ok))
    for name in ARRAYS:
        np.copyto(getattr(out, name), getattr(mb, name))
    return out


def check_slice(seq, pic, mb_h, code, seg, start):
    """Both engines on one slice from copies of `start`: the same arrays
    and the same outcome. Returns (the twin's MBData, outcome)."""
    py, nat = copy_mb(start), copy_mb(start)
    want = outcome(lambda: twin(seq, pic)._decode_slice_py(code, seg, py))
    got = outcome(lambda: mpeg12_slice.decode_slice(seg, nat, seq, pic,
                                                    mb_h, code - 1))
    assert got == want, (code, len(seg))
    for name in ARRAYS:
        a, b = getattr(py, name), getattr(nat, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), (code, name)
    return py, want


def check_pictures(pics, corrupt=None):
    """Every slice of every picture through both engines, each from the
    state the twin left after the picture's earlier (intact) slices;
    corrupt(seg) -> [variants] adds damaged copies of each slice.
    Returns the outcomes."""
    seen = []
    for seq, pic, mb_h, slices in pics:
        mb = MBData(seq.mb_width * mb_h)
        for code, seg in slices:
            for bad in (corrupt(seg) if corrupt else []):
                seen.append(check_slice(seq, pic, mb_h, code, bad, mb)[1])
            mb, res = check_slice(seq, pic, mb_h, code, seg, mb)
            seen.append(res)
    return seen


STREAM_NAMES = list(STREAMS) + list(testdata.MPEG2_SMOKE) + \
    ["interlaced_field_dct"]


@native
@pytest.mark.parametrize("name", STREAM_NAMES)
def test_stream_slices_match_twin(name):
    pics = pictures(packets(name))
    assert pics
    seen = check_pictures(pics)
    assert seen and all(r is None for r in seen)


def _damage(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))

    def corrupt(seg):
        out = [seg[:int(rng.integers(1, len(seg)))] for _ in range(2)]
        for _ in range(3):
            b = bytearray(seg)
            for pos in rng.integers(0, 8 * len(seg), int(rng.integers(1, 4))):
                b[pos >> 3] ^= 0x80 >> (pos & 7)
            out.append(bytes(b))
        return out
    return corrupt


@native
@pytest.mark.parametrize("name", list(STREAMS))
def test_damaged_slices_match_twin(name):
    """Truncated slices and flipped bits: both engines fail at the same
    MB with the same arrays, or both get through."""
    seen = check_pictures(pictures(packets(name)), _damage(name))
    assert any(r is not None for r in seen)


# ---------------------------------------------------------------------- #
# well-formed random slices
# ---------------------------------------------------------------------- #

def _put(pb, table, i):
    codes, lengths = table
    pb.put_bits(lengths[i], codes[i])


class SliceWriter:
    """Writes random slice syntax that the twin parses through: every
    choice the twin's parser makes is drawn here and written as the
    twin reads it."""

    def __init__(self, rng, seq, pic):
        self.rng, self.seq, self.pic = rng, seq, pic
        self.field = seq.mpeg2 and pic.picture_structure != 3

    def chance(self, p):
        return self.rng.random() < p

    def motion(self, pb, fcode):
        code = int(self.rng.choice(17, p=_MOTION_P))
        _put(pb, T.MOTION_CODE, code)
        if code:
            pb.put_bits(1, int(self.rng.integers(2)))
            if fcode > 1:
                pb.put_bits(fcode - 1, int(self.rng.integers(1 << (fcode - 1))))

    def dmv(self, pb):
        pb.put_bits(*[(1, 0), (2, 2), (2, 3)][int(self.rng.integers(3))])

    def vectors(self, pb, d, mt):
        fx, fy = self.pic.f_code[d]
        if self.field:
            if mt == 3:
                self.motion(pb, fx), self.dmv(pb)
                self.motion(pb, fy), self.dmv(pb)
                return
            for _ in range(1 if mt == 1 else 2):
                pb.put_bits(1, int(self.rng.integers(2)))
                self.motion(pb, fx), self.motion(pb, fy)
            return
        if mt == 3 and d == 0:
            self.motion(pb, fx), self.dmv(pb)
            self.motion(pb, fy), self.dmv(pb)
        elif self.seq.mpeg2 and mt == 1:
            for _ in range(2):
                pb.put_bits(1, int(self.rng.integers(2)))
                self.motion(pb, fx), self.motion(pb, fy)
        else:
            self.motion(pb, fx), self.motion(pb, fy)

    def coefficients(self, pb, first, b15, start):
        tab = T.DCT_VLC_MPEG2 if b15 else T.DCT_VLC_MPEG1
        i = start
        n = int(self.rng.integers(0 if start else 1, 12))
        for k in range(n):
            if self.chance(0.1):
                run = int(self.rng.integers(0, 4))
                if i + run > 63:
                    break
                pb.put_bits(*tab[T.ESCAPE_INDEX][::-1])
                pb.put_bits(6, run)
                if self.seq.mpeg2:
                    pb.put_sbits(12, int(self.rng.integers(-2047, 2048)))
                else:
                    level = int(self.rng.integers(-255, 256)) or 1
                    if -128 < level < 128:
                        pb.put_sbits(8, level)
                    else:
                        pb.put_bits(8, 0x80 if level < 0 else 0)
                        pb.put_bits(8, level & 0xFF)
                i += run + 1
                continue
            v = int(self.rng.integers(0, 111)) if self.chance(0.3) else \
                int(self.rng.integers(0, 6))
            run, level = T.RUN_LEVEL[0][v], T.RUN_LEVEL[1][v]
            if i + run > 63:
                break
            if first and k == 0 and v == 0:
                pb.put_bits(1, 1)               # the first coefficient's '1s'
            else:
                code, bits = tab[v]
                pb.put_bits(bits, code)
            pb.put_bits(1, int(self.rng.integers(2)))
            i += run + 1
        code, bits = tab[T.EOB_INDEX]
        if first and i == 0:                    # a coded block holds one
            pb.put_bits(2, 0b10)
        pb.put_bits(bits, code)

    def intra_block(self, pb, blk):
        table = T.DC_LUM if blk < 4 else T.DC_CHROMA
        size = int(self.rng.integers(0, 12 if self.chance(0.02) else 6))
        _put(pb, table, size)
        if size:
            pb.put_bits(size, int(self.rng.integers(1 << size)))
        self.coefficients(pb, False,
                          self.seq.mpeg2 and self.pic.intra_vlc_format, 1)

    def macroblock(self, pb):
        pic, seq = self.pic, self.seq
        if pic.pict_type == 1:
            flags = T.MB_INTRA if self.chance(0.6) else \
                T.MB_QUANT | T.MB_INTRA
            pb.put_bits(*((1, 1) if flags == T.MB_INTRA else (2, 1)))
        else:
            tab = T.MB_PTYPE if pic.pict_type == 2 else T.MB_BTYPE
            i = int(self.rng.integers(len(tab[0])))
            pb.put_bits(tab[1][i], tab[0][i])
            flags = tab[2][i]
        moving = flags & (T.MB_FOR | T.MB_BACK)
        mt = 2
        if self.field:
            if moving:
                mt = 2 if pic.frame_pred_frame_dct else \
                    int(self.rng.choice([1, 2, 3] if pic.pict_type == 2
                                        else [1, 2]))
                if not pic.frame_pred_frame_dct:
                    pb.put_bits(2, mt)
        elif seq.mpeg2 and not pic.frame_pred_frame_dct:
            if moving:
                mt = int(self.rng.choice([1, 2, 3] if pic.pict_type == 2
                                         else [1, 2]))
                pb.put_bits(2, mt)
            if flags & (T.MB_PAT | T.MB_INTRA):
                pb.put_bits(1, int(self.rng.integers(2)))
        if flags & T.MB_QUANT:
            pb.put_bits(5, int(self.rng.integers(1, 32)))
        if flags & T.MB_INTRA and pic.concealment_mvs:
            self.vectors(pb, 0, 1 if self.field else 2)
            pb.put_bits(1, 1)
        if flags & T.MB_FOR:
            self.vectors(pb, 0, mt)
        if flags & T.MB_BACK:
            self.vectors(pb, 1, mt)
        cbp = 0x3F if flags & T.MB_INTRA else 0
        if flags & T.MB_PAT:
            cbp = int(self.rng.integers(0 if seq.mpeg2 else 1, 64))
            code, bits = T.MB_PAT_CODES[cbp]
            pb.put_bits(bits, code)
        for blk in range(6):
            if cbp & (0x20 >> blk):
                if flags & T.MB_INTRA:
                    self.intra_block(pb, blk)
                else:
                    self.coefficients(pb, True, False, 0)

    def increment(self, pb, inc):
        if self.chance(0.05):
            _put(pb, T.MB_ADDR_INC, T.MB_ADDR_STUFFING)
        while inc > 33:
            _put(pb, T.MB_ADDR_INC, T.MB_ADDR_ESCAPE)
            inc -= 33
        _put(pb, T.MB_ADDR_INC, inc - 1)

    def slice(self, mb_w, mb_h, mb_y):
        pb = PutBits()
        pb.put_bits(5, int(self.rng.integers(1, 32)))
        if self.chance(0.2):
            pb.put_bits(9, 0x100 | int(self.rng.integers(256)))
        pb.put_bits(1, 0)
        addr, end = mb_y * mb_w - 1, mb_w * mb_h
        first = True
        while True:
            if first:
                inc = int(self.rng.integers(1, mb_w + 1))
            elif self.chance(0.02):
                inc = 34 + int(self.rng.integers(4))
            else:
                inc = 1 if self.chance(0.7) else int(self.rng.integers(2, 5))
            if addr + inc >= end and not (first or inc > 33):
                break
            self.increment(pb, inc)
            self.macroblock(pb)
            addr += inc
            if first:
                first = False
            elif inc > 33 or self.chance(0.1):
                break
        pb.align(0)
        return pb.flush()


_MOTION_P = np.array([8, 6, 4, 3, 2, 2, 1, 1, 1, 1, 1, .5, .5, .5, .5, .5,
                      .5])
_MOTION_P /= _MOTION_P.sum()


def synthetic_pictures(kind, seed, n=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mb_w, mb_h = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        mpeg2 = kind != "mpeg1"
        seq = SeqContext(width=16 * mb_w, mb_width=mb_w, mpeg2=mpeg2,
                         height=16 * mb_h * (1 if kind != "field" else 2),
                         mb_height=mb_h * (1 if kind != "field" else 2))
        pic = PicContext()
        pic.pict_type = int(rng.choice([1, 2, 3] if mpeg2 else [1, 2, 3, 4]))
        if mpeg2:
            pic.f_code = tuple(tuple(int(f) for f in rng.integers(1, 10, 2))
                               for _ in range(2))
            pic.picture_structure = 3 if kind == "frame" else \
                int(rng.choice([1, 2]))
            pic.frame_pred_frame_dct = int(rng.random() < 0.25)
            pic.intra_dc_precision = int(rng.integers(4))
            pic.top_field_first = int(rng.integers(2))
            pic.q_scale_type = int(rng.integers(2))
            pic.intra_vlc_format = int(rng.integers(2))
        else:
            fc = [int(rng.integers(1, 8)) for _ in range(2)]
            pic.f_code = ((fc[0], fc[0]), (fc[1], fc[1]))
            pic.full_pel = tuple(int(f) for f in rng.integers(0, 2, 2))
        pic.concealment_mvs = int(rng.random() < 0.3)
        writer = SliceWriter(rng, seq, pic)
        slices = []
        for _ in range(int(rng.integers(1, mb_h + 2))):
            mb_y = int(rng.integers(0, mb_h))
            slices.append((mb_y + 1, writer.slice(mb_w, mb_h, mb_y)))
        out.append((seq, pic, mb_h, slices))
    return out


@native
@pytest.mark.parametrize("kind", ["mpeg1", "frame", "field"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_synthetic_slices_match_twin(kind, seed):
    seen = check_pictures(synthetic_pictures(kind, 1000 * seed + len(kind)))
    # most slices decode whole; a few leave the picture (escapes) or
    # overflow a DC, and fail alike in both engines
    assert sum(r is None for r in seen) > len(seen) // 2


@native
def test_synthetic_slices_reach_every_mode():
    """The writer's slices take the twin through every MB mode that the
    native decoder has a branch for."""
    modes = set()
    for kind in ("mpeg1", "frame", "field"):
        for seq, pic, mb_h, slices in synthetic_pictures(kind, 7):
            mb = MBData(seq.mb_width * mb_h)
            for code, seg in slices:
                outcome(lambda: twin(seq, pic)._decode_slice_py(code, seg,
                                                                 mb))
            ok = mb.ok
            modes.add((kind, "dual") if mb.dp[ok].any() else None)
            modes.add((kind, "field_mc") if mb.field_mc[ok].any() else None)
            modes.add((kind, "dct_field") if mb.dct_field[ok].any()
                      else None)
            modes.add((kind, "bwd") if mb.use_bwd[ok].any() else None)
            modes.add((kind, "intra") if mb.intra[ok].any() else None)
    assert {("frame", "dual"), ("frame", "field_mc"), ("frame", "dct_field"),
            ("field", "dual"), ("field", "bwd"), ("mpeg1", "bwd"),
            ("mpeg1", "intra")} <= modes


@native
def test_dc_outside_int16_raises_as_twin():
    """Intra DCs that walk past int16: numpy refuses the twin's store, and
    the native decoder raises the same OverflowError at the same block."""
    seq = SeqContext(width=64, height=16, mb_width=4, mb_height=1,
                     mpeg2=True)
    pic = PicContext()                  # I, frame, intra_dc_precision 0
    pb = PutBits()
    pb.put_bits(5, 4)
    pb.put_bits(1, 0)
    for mb in range(4):
        _put(pb, T.MB_ADDR_INC, 0)
        pb.put_bits(1, 1)               # intra
        for blk in range(6):
            table = T.DC_LUM if blk < 4 else T.DC_CHROMA
            _put(pb, table, 11)
            pb.put_bits(11, 2047)        # +2047 << 3 a block
            code, bits = T.DCT_VLC_MPEG1[T.EOB_INDEX]
            pb.put_bits(bits, code)
    pb.align(0)
    seg = pb.flush()
    _, res = check_slice(seq, pic, 1, 1, seg, MBData(4))
    assert res is not None and res[0] == "OverflowError"


# ---------------------------------------------------------------------- #
# the chooser
# ---------------------------------------------------------------------- #

def test_twin_decode_matches_jax(monkeypatch):
    """With the native library switched off the decoder runs the twin,
    slice for slice, and still decodes a field stream as the JAX
    decoder does."""
    import test_torch_mpeg12_decode as decode_tests
    monkeypatch.setenv("LIBAV_TPU_NO_NATIVE", "1")
    before = timer.counters()
    decode_tests.test_decode_matches_jax("field_full")
    after = timer.counters()
    ran = {k: after.get(k, 0) - before.get(k, 0)
           for k in ("mpeg2.slice.python", "mpeg2.slice.native")}
    assert ran["mpeg2.slice.python"] > 0 and ran["mpeg2.slice.native"] == 0


@native
def test_chooser_counts_the_native_engine(monkeypatch):
    """With the library built, every slice runs native and is counted as
    such; the decoded arrays are the twin's."""
    seen = {}
    decode_py = MPEG2Decoder._decode_slice_py

    def spy(self, code, seg, mb):
        seen["python"] = True
        return decode_py(self, code, seg, mb)
    monkeypatch.setattr(MPEG2Decoder, "_decode_slice_py", spy)
    seq, pic, mb_h, slices = pictures(packets("field_h16"))[0]
    dec = twin(seq, pic)
    mb = MBData(seq.mb_width * mb_h)
    before = timer.counters().get("mpeg2.slice.native", 0)
    for code, seg in slices:
        dec._decode_slice(code, seg, mb)
    assert timer.counters()["mpeg2.slice.native"] - before == len(slices)
    assert not seen
