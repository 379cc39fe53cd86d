"""FFV1 normative constant tables (reference: libavcodec/ffv1.c:36-129,
libavcodec/bitstream.c:37 ff_log2_run; all are fixed by the FFV1
specification — RFC 9043 carries the same tables).

The gradient-quantization tables are generated from their level
thresholds (each table is a symmetric staircase: level k for
|d| >= thresholds[k-1], negated on the wrap-around side exactly like
read_quant_table's mirror rule quant[256-i] = -quant[i],
quant[128] = -quant[127])."""

from __future__ import annotations


def _staircase(thresholds):
    t = [0] * 256
    lev = 0
    for i in range(1, 128):
        if lev < len(thresholds) and i >= thresholds[lev]:
            lev += 1
        t[i] = lev
    for i in range(1, 128):
        t[256 - i] = -t[i]
    t[128] = -t[127]
    return t


QUANT5 = _staircase([1, 4])            # ffv1_quant5
QUANT11 = _staircase([1, 2, 5, 12, 35])  # ffv1_quant11
QUANT5_10BIT = _staircase([11, 50])      # ffv1_quant5_10bit
QUANT9_10BIT = _staircase([5, 13, 27, 56])  # ffv1_quant9_10bit

# run-length order schedule for the Golomb-Rice run mode
# (bitstream.c ff_log2_run): 4x each of 0..3, 2x each of 4..7, then +1
LOG2_RUN = ([0] * 4 + [1] * 4 + [2] * 4 + [3] * 4 +
            [4, 4, 5, 5, 6, 6, 7, 7] + list(range(8, 25)))
assert len(LOG2_RUN) == 41

# version-2 default state-transition table (ffv1.c ffv1_ver2_state;
# RFC 9043 "default_state_transition") — used by AC_RANGE_CUSTOM_TAB
# when no per-stream custom table overrides it
VER2_STATE = [
    0, 10, 10, 10, 10, 16, 16, 16, 28, 16, 16, 29, 42, 49, 20, 49,
    59, 25, 26, 26, 27, 31, 33, 33, 33, 34, 34, 37, 67, 38, 39, 39,
    40, 40, 41, 79, 43, 44, 45, 45, 48, 48, 64, 50, 51, 52, 88, 52,
    53, 74, 55, 57, 58, 58, 74, 60, 101, 61, 62, 84, 66, 66, 68, 69,
    87, 82, 71, 97, 73, 73, 82, 75, 111, 77, 94, 78, 87, 81, 83, 97,
    85, 83, 94, 86, 99, 89, 90, 99, 111, 92, 93, 134, 95, 98, 105, 98,
    105, 110, 102, 108, 102, 118, 103, 106, 106, 113, 109, 112, 114, 112,
    116, 125,
    115, 116, 117, 117, 126, 119, 125, 121, 121, 123, 145, 124, 126, 131,
    127, 129,
    165, 130, 132, 138, 133, 135, 145, 136, 137, 139, 146, 141, 143, 142,
    144, 148,
    147, 155, 151, 149, 151, 150, 152, 157, 153, 154, 156, 168, 158, 162,
    161, 160,
    172, 163, 169, 164, 166, 184, 167, 170, 177, 174, 171, 173, 182, 176,
    180, 178,
    175, 189, 179, 181, 186, 183, 192, 185, 200, 187, 191, 188, 190, 197,
    193, 196,
    197, 194, 195, 196, 198, 202, 199, 201, 210, 203, 207, 204, 205, 206,
    208, 214,
    209, 211, 221, 212, 213, 215, 224, 216, 217, 218, 219, 220, 222, 228,
    223, 225,
    226, 224, 227, 229, 240, 230, 231, 232, 233, 234, 235, 236, 238, 239,
    237, 242,
    241, 243, 242, 244, 245, 246, 247, 248, 249, 250, 251, 252, 252, 253,
    254, 255,
]
assert len(VER2_STATE) == 256


def build_quant_tables(bits_per_raw_sample: int):
    """The two built-in context models (ffv1enc.c:683-703): model 0 =
    3-gradient (11x11x11), model 1 = 5-gradient (11x11x5x5x5).
    Returns (quant_tables[2][5][256], context_count[2])."""
    if bits_per_raw_sample <= 8:
        q_a, q_b = QUANT11, QUANT5
    else:
        q_a, q_b = QUANT9_10BIT, QUANT5_10BIT
    t0 = [[q_a[i] for i in range(256)],
          [q_a[i] * 11 for i in range(256)],
          [q_a[i] * 11 * 11 for i in range(256)],
          [0] * 256,
          [0] * 256]
    t1 = [[q_a[i] for i in range(256)],
          [q_a[i] * 11 for i in range(256)],
          [q_b[i] * 11 * 11 for i in range(256)],
          [q_b[i] * 5 * 11 * 11 for i in range(256)],
          [q_b[i] * 5 * 5 * 11 * 11 for i in range(256)]]
    counts = [(11 * 11 * 11 + 1) // 2, (11 * 11 * 5 * 5 * 5 + 1) // 2]
    return [t0, t1], counts
