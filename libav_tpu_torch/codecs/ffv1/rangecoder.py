"""FFV1 range coder (reference: libavcodec/rangecoder.c/h — the
G. N. N. Martin / IBM 1979 carry-less range coder with 8-bit
probability states).

Host-serial by nature (every bit updates the adaptive state the next
bit's subdivision depends on), so it lives on the host like the
reference's scalar C: the batched work of an FFV1 frame is the
per-plane prediction/transform, not the coder.

Bit-exactness contract: byte-identical output to ff_init_range_encoder
/ put_rac / ff_rac_terminate and value-identical decode to get_rac —
asserted by the cross tests that decode reference-encoded streams and
feed our streams to the reference binary.
"""

from __future__ import annotations

from typing import List


def build_rac_states(factor: int, max_p: int):
    """reference: rangecoder.c:62 ff_build_rac_states — derive the
    (zero_state, one_state) adaptation tables from a geometric
    probability-drift model.  factor is a 0.32 fixed-point fraction
    (FFV1 uses 0.05 * 2^32), max_p caps the probability (256-8)."""
    one = 1 << 32
    zero_state = [0] * 256
    one_state = [0] * 256

    last_p8 = 0
    p = one // 2
    for _ in range(128):
        p8 = (256 * p + one // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((one - p) * factor + one // 2) >> 32
        last_p8 = p8

    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * one + 128) >> 8
        p += ((one - p) * factor + one // 2) >> 32
        p8 = (256 * p + one // 2) >> 32
        if p8 <= i:
            p8 = i + 1
        if p8 > max_p:
            p8 = max_p
        one_state[i] = p8

    for i in range(1, 255):
        zero_state[i] = 256 - one_state[256 - i]
    return zero_state, one_state


# the default FFV1 adaptation (both codecs build it with these args)
DEFAULT_ZERO_STATE, DEFAULT_ONE_STATE = build_rac_states(
    int(0.05 * (1 << 32)), 256 - 8)


class RangeEncoder:
    """reference: rangecoder.h renorm_encoder / put_rac."""

    def __init__(self):
        self.low = 0
        self.range = 0xFF00
        self.outstanding_count = 0
        self.outstanding_byte = -1
        self.out: List[int] = []
        self.zero_state = list(DEFAULT_ZERO_STATE)
        self.one_state = list(DEFAULT_ONE_STATE)

    def set_transition(self, one_state_tab):
        """AC_RANGE_CUSTOM_TAB: install a custom one_state (the
        zero_state mirror is derived like ffv1enc.c:959)."""
        for i in range(1, 256):
            self.one_state[i] = one_state_tab[i]
            self.zero_state[256 - i] = 256 - one_state_tab[i]

    def _renorm(self):
        out = self.out
        while self.range < 0x100:
            if self.outstanding_byte < 0:
                self.outstanding_byte = self.low >> 8
            elif self.low <= 0xFF00:
                out.append(self.outstanding_byte)
                out.extend([0xFF] * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = self.low >> 8
            elif self.low >= 0x10000:
                out.append((self.outstanding_byte + 1) & 0xFF)
                out.extend([0x00] * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) & 0xFF
            else:
                self.outstanding_count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def put(self, state: list, idx: int, bit: int):
        """put_rac with the state byte held in state[idx] (mirrors the
        reference's uint8_t* into a 32-byte context block)."""
        s = state[idx]
        range1 = (self.range * s) >> 8
        if bit:
            self.low += self.range - range1
            self.range = range1
            state[idx] = self.one_state[s]
        else:
            self.range -= range1
            state[idx] = self.zero_state[s]
        if self.range < 0x100:
            self._renorm()

    def terminate(self) -> bytes:
        """reference: rangecoder.c:104 ff_rac_terminate."""
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        assert self.low == 0
        return bytes(self.out)


class RangeDecoder:
    """reference: rangecoder.h get_rac/refill (decode side of the same
    coder; reads past the end return the buffer as-is — the encoder's
    terminate guarantees enough bytes)."""

    def __init__(self, data: bytes):
        self.d = data
        self.n = len(data)
        self.low = (data[0] << 8 | data[1]) if self.n >= 2 else 0
        self.pos = 2
        self.range = 0xFF00
        self.zero_state = list(DEFAULT_ZERO_STATE)
        self.one_state = list(DEFAULT_ONE_STATE)

    def set_transition(self, one_state_tab):
        for i in range(1, 256):
            self.one_state[i] = one_state_tab[i]
            self.zero_state[256 - i] = 256 - one_state_tab[i]

    def _refill(self):
        if self.range < 0x100:
            self.range <<= 8
            self.low <<= 8
            if self.pos < self.n:
                self.low += self.d[self.pos]
            self.pos += 1

    def get(self, state: list, idx: int) -> int:
        s = state[idx]
        range1 = (self.range * s) >> 8
        self.range -= range1
        if self.low < self.range:
            state[idx] = self.zero_state[s]
            self._refill()
            return 0
        self.low -= self.range
        state[idx] = self.one_state[s]
        self.range = range1
        self._refill()
        return 1

    def bytes_consumed(self) -> int:
        """Bytes the decoder has pulled from the buffer (the
        reference's `bytestream - bytestream_start`)."""
        return self.pos
