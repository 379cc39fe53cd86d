"""FFV1 shared coding layer (reference: libavcodec/ffv1.h fold/predict/
get_context/update_vlc_state, ffv1enc.c put_symbol, ffv1dec.c
get_symbol/get_vlc_symbol, golomb.h get/set_sr_golomb).

Everything here is per-sample host-serial — the adaptive contexts make
each symbol depend on the previous one, exactly why the reference also
keeps this scalar.  32-entry state blocks are Python lists of ints
(one block per context), mutated in place like the reference's
uint8_t state[CONTEXT_SIZE]."""

from __future__ import annotations

from typing import List

from libav_tpu_torch.codecs.ffv1.rangecoder import RangeDecoder, RangeEncoder
from libav_tpu_torch.codecs.ffv1.tables import LOG2_RUN

CONTEXT_SIZE = 32


def fold(diff: int, bits: int) -> int:
    """reference: ffv1.h:124 — wrap a prediction difference into the
    signed `bits`-wide residual range."""
    if bits == 8:
        diff = ((diff + 128) & 0xFF) - 128
    else:
        diff &= (1 << bits) - 1
        diff -= 1 << (bits - 1)
    return diff


def predict(l: int, t: int, lt: int) -> int:
    """median(L, L+T-LT, T) — ffv1.h:137 (mid_pred)."""
    g = l + t - lt
    if l > t:
        l, t = t, l
    return max(l, min(g, t))


# ---------------------------------------------------------------------- #
# Range-coder symbol layer
# ---------------------------------------------------------------------- #

def put_symbol(c: RangeEncoder, state: List[int], v: int, is_signed: bool):
    """reference: ffv1enc.c:82 put_symbol_inline — unary exponent
    (states 1..10), mantissa MSB-first (states 22..31), sign (11..21)."""
    if v:
        a = abs(v)
        e = a.bit_length() - 1
        c.put(state, 0, 0)
        if e <= 9:
            for i in range(e):
                c.put(state, 1 + i, 1)
            c.put(state, 1 + e, 0)
            for i in range(e - 1, -1, -1):
                c.put(state, 22 + i, (a >> i) & 1)
            if is_signed:
                c.put(state, 11 + e, 1 if v < 0 else 0)
        else:
            for i in range(e):
                c.put(state, 1 + min(i, 9), 1)
            c.put(state, 1 + 9, 0)
            for i in range(e - 1, -1, -1):
                c.put(state, 22 + min(i, 9), (a >> i) & 1)
            if is_signed:
                c.put(state, 11 + 10, 1 if v < 0 else 0)
    else:
        c.put(state, 0, 1)


def get_symbol(c: RangeDecoder, state: List[int], is_signed: bool) -> int:
    """reference: ffv1dec.c:44 get_symbol_inline."""
    if c.get(state, 0):
        return 0
    e = 0
    while c.get(state, 1 + min(e, 9)):
        e += 1
        if e > 31:          # corrupt stream guard (matches practical cap)
            break
    a = 1
    for i in range(e - 1, -1, -1):
        a += a + c.get(state, 22 + min(i, 9))
    if is_signed and c.get(state, 11 + min(e, 10)):
        return -a
    return a


# ---------------------------------------------------------------------- #
# Golomb-Rice (coder_type 0) symbol layer
# ---------------------------------------------------------------------- #

class VlcState:
    """reference: ffv1.h:52 VlcState + update_vlc_state — adaptive
    Rice parameter via drift/error_sum/bias with halving at count 128."""

    __slots__ = ("drift", "error_sum", "bias", "count")

    def __init__(self):
        self.drift = 0
        self.error_sum = 4
        self.bias = 0
        self.count = 1

    def k(self) -> int:
        k = 0
        i = self.count
        while i < self.error_sum:
            k += 1
            i += i
        return k

    def update(self, v: int):
        drift = self.drift
        count = self.count
        self.error_sum += abs(v)
        drift += v
        if count == 128:
            count >>= 1
            drift >>= 1
            self.error_sum >>= 1
        count += 1
        if drift <= -count:
            if self.bias > -128:
                self.bias -= 1
            drift += count
            if drift <= -count:
                drift = -count + 1
        elif drift > 0:
            if self.bias < 127:
                self.bias += 1
            drift -= count
            if drift > 0:
                drift = 0
        self.drift = drift
        self.count = count


def set_ur_golomb(pb, i: int, k: int, limit: int, esc_len: int):
    """reference: golomb.h:452 — unary quotient + k remainder bits,
    escape to esc_len raw bits past `limit` quotient zeros."""
    e = i >> k
    if e < limit:
        pb.put_bits(e + k + 1, (1 << k) + (i & ((1 << k) - 1)))
    else:
        pb.put_bits(limit + esc_len, i - limit + 1)


def set_sr_golomb(pb, i: int, k: int, limit: int, esc_len: int):
    """reference: golomb.h:500 — zig-zag (v = 2i / -2i-1) then rice."""
    v = 2 * i if i >= 0 else -2 * i - 1
    set_ur_golomb(pb, v, k, limit, esc_len)


def get_ur_golomb(gb, k: int, limit: int, esc_len: int) -> int:
    """reference: golomb.h:248 (ffv1 variant)."""
    # count quotient zeros up to limit
    zeros = 0
    while zeros < limit:
        if gb.get_bit():
            val = gb.get_bits(k) if k else 0
            return (zeros << k) + val
        zeros += 1
    return gb.get_bits(esc_len) + limit - 1


def get_sr_golomb(gb, k: int, limit: int, esc_len: int) -> int:
    v = get_ur_golomb(gb, k, limit, esc_len)
    v += 1
    if v & 1:
        return v >> 1
    return -(v >> 1)


def put_vlc_symbol(pb, state: VlcState, v: int, bits: int):
    """reference: ffv1enc.c:139 put_vlc_symbol."""
    v = fold(v - state.bias, bits)
    k = state.k()
    # code = v ^ ((2*drift + count) >> 31): bitwise-negate when the
    # running drift is negative (sign-extension trick)
    code = v ^ -1 if (2 * state.drift + state.count) < 0 else v
    set_sr_golomb(pb, code, k, 12, bits)
    state.update(v)


def get_vlc_symbol(gb, state: VlcState, bits: int) -> int:
    """reference: ffv1dec.c:69 get_vlc_symbol."""
    k = state.k()
    v = get_sr_golomb(gb, k, 12, bits)
    if (2 * state.drift + state.count) < 0:
        v ^= -1
    ret = fold(v + state.bias, bits)
    state.update(v)
    return ret


# ---------------------------------------------------------------------- #
# Quant-table serialization (version < 2 in-band header)
# ---------------------------------------------------------------------- #

def write_quant_table(c: RangeEncoder, quant_table: List[int]):
    """reference: ffv1enc.c:352 — run lengths of equal levels over
    indices 1..127."""
    state = [128] * CONTEXT_SIZE
    last = 0
    for i in range(1, 128):
        if quant_table[i] != quant_table[i - 1]:
            put_symbol(c, state, i - last - 1, False)
            last = i
    put_symbol(c, state, 128 - last - 1, False)


def read_quant_table(c: RangeDecoder, scale: int):
    """reference: ffv1dec.c:399 — run-length decode of the level
    staircase; returns (table, 2*levels-1) or (None, -1) on overrun."""
    state = [128] * CONTEXT_SIZE
    table = [0] * 256
    i = 0
    v = 0
    while i < 128:
        ln = get_symbol(c, state, False) + 1
        if ln > 128 - i:
            return None, -1
        for _ in range(ln):
            table[i] = scale * v
            i += 1
        v += 1
    for i in range(1, 128):
        table[256 - i] = -table[i]
    table[128] = -table[127]
    return table, 2 * v - 1


def read_quant_tables(c: RangeDecoder):
    """reference: ffv1dec.c:443 — 5 tables, composite context count."""
    tables = []
    context_count = 1
    for _ in range(5):
        t, n = read_quant_table(c, context_count)
        if t is None or n <= 0:
            return None, -1
        tables.append(t)
        context_count *= n
        if context_count > 32768:
            return None, -1
    return tables, (context_count + 1) // 2


def get_context(qt, sample_cur, sample_up, sample_up2, x: int,
                five: bool) -> int:
    """reference: ffv1.h:146 — 3- or 5-gradient quantized context.
    sample_* are padded rows indexed with +OFF."""
    OFF = 3
    L = sample_cur[x - 1 + OFF]
    LT = sample_up[x - 1 + OFF]
    T = sample_up[x + OFF]
    RT = sample_up[x + 1 + OFF]
    if five:
        TT = sample_up2[x + OFF]
        LL = sample_cur[x - 2 + OFF]
        return (qt[0][(L - LT) & 0xFF] + qt[1][(LT - T) & 0xFF] +
                qt[2][(T - RT) & 0xFF] + qt[3][(LL - L) & 0xFF] +
                qt[4][(TT - T) & 0xFF])
    return (qt[0][(L - LT) & 0xFF] + qt[1][(LT - T) & 0xFF] +
            qt[2][(T - RT) & 0xFF])
