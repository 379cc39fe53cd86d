/* MPEG-1/2 slice decoder: the host-serial hot loop of MPEG-1/2 decode
 * (reference mpeg12dec.c mpeg_decode_slice :1642, mpeg_decode_mb :659,
 * mpeg_decode_motion, mpeg1/2_decode_block_*), writing one slice's
 * macroblocks straight into the picture's MBData arrays.
 *
 * Must stay byte-identical to MPEG1Decoder._decode_slice_py
 * (libav_tpu_torch/codecs/mpeg12/dec.py), the Python twin: the same
 * arrays written in the same order, and a failure (nonzero return) at the
 * same point, with whatever the twin had written before it raised. Its
 * bit rules are those of bitstream/getbits.py: a read past the end fails,
 * a peek pads with zeros, a VLC may consume padding (the slice loop then
 * ends on bits_left).
 *
 * Tables come from the Python side (native/mpeg12_slice.py `tables`):
 * the flattened VLCs of codecs/mpeg12/tables.py, RUN_LEVEL and
 * NON_LINEAR_QSCALE, so both engines decode from one copy of Annex B. */

#include <setjmp.h>
#include <stdint.h>
#include "bitreader.h"

/* params[] (native/mpeg12_slice.py `_params`) */
enum {
    P_MB_W, P_MB_H, P_MB_Y, P_MPEG2, P_PICT_TYPE, P_STRUCTURE,
    P_FRAME_PRED_FRAME_DCT, P_CONCEALMENT_MVS, P_Q_SCALE_TYPE,
    P_INTRA_VLC_FORMAT, P_INTRA_DC_PRECISION, P_TOP_FIELD_FIRST,
    P_FULL_PEL_F, P_FULL_PEL_B, P_F_CODE /* [dir][xy]: 4 ints */
};

/* tables[]: a header of (offset, root bits) per VLC, then the offsets of
 * RUN, LEVEL and NON_LINEAR_QSCALE; each VLC is (value, length) pairs in
 * the layout of bitstream/vlc.py _flatten */
enum {
    V_ADDR, V_PTYPE, V_BTYPE, V_CBP, V_MOTION, V_DC_LUM, V_DC_CHROMA,
    V_B14, V_B15, N_VLC
};
enum { T_RUN = 2 * N_VLC, T_LEVEL, T_QSCALE };

/* return codes (native/mpeg12_slice.py `ERRORS`) */
enum {
    E_OVERREAD = 1, E_VLC, E_ADDR, E_I_TYPE, E_CBP0, E_MOTION_TYPE0,
    E_AC, E_DC_RANGE
};

enum { PICT_I = 1, PICT_P = 2, PICT_B = 3 };
enum { MB_QUANT = 0x10, MB_FOR = 0x08, MB_BACK = 0x04, MB_PAT = 0x02,
       MB_INTRA = 0x01 };
enum { ADDR_ESCAPE = 33, ADDR_STUFFING = 34, ESCAPE_INDEX = 111,
       EOB_INDEX = 112 };

typedef struct {
    BitReader br;
    int64_t size_bits;
    jmp_buf fail;
    volatile int err;       /* the return code, set just before the jump */
    const int *tab;
    /* picture */
    int mb_w, mb_h, mpeg2, pict, structure, fpfd, conceal, qst, ivf,
        dcprec, tff, full_pel[2], f_code[2][2];
    /* MBData */
    short *coeffs;
    int *qscale;
    unsigned char *intra, *use_fwd, *use_bwd, *coded, *ok, *field_mc,
        *dct_field, *dp;
    int *mv_fwd, *mv_bwd, *mv_fwd2, *mv_bwd2, *sel_fwd, *sel_bwd,
        *mv_dp2, *sel_dp;
    int *info;
    /* slice state */
    int q, dc[3];
    int pmv[2][2][2];
    int has_prev, prev_uf, prev_ub, prev_mvf[4], prev_mvb[4],
        prev_sf[2], prev_sb[2];
} Slice;

static void fail(Slice *s, int code)
{
    s->err = code;
    longjmp(s->fail, 1);
}

static inline int64_t bit_pos(const Slice *s)
{
    return s->br.byte_pos * 8 - s->br.bits_in_cache;
}

/* getbits.py get_bits, n in 1..32 */
static inline int get_bits(Slice *s, int n)
{
    if (bit_pos(s) + n > s->size_bits)
        fail(s, E_OVERREAD);
    return (int)br_get(&s->br, n);
}

static inline int get_sbits(Slice *s, int n)
{
    int v = get_bits(s, n);
    return v >= (1 << (n - 1)) ? v - (1 << n) : v;
}

/* vlc.py VLC.read over the flattened table, to any depth */
static int vlc(Slice *s, int which)
{
    const int *base = s->tab + s->tab[2 * which];
    const int *t = base;
    int bits = s->tab[2 * which + 1];
    for (;;) {
        uint32_t idx = br_peek(&s->br, bits);
        int v = t[2 * idx], l = t[2 * idx + 1];
        if (l > 0) {
            br_skip(&s->br, l);
            return v;
        }
        if (l == 0)
            fail(s, E_VLC);
        br_skip(&s->br, bits);
        t = base + 2 * v;
        bits = -l;
    }
}

static int qscale_of(const Slice *s, int code)
{
    if (s->mpeg2)
        return s->qst ? s->tab[s->tab[T_QSCALE] + code] : code << 1;
    return code;
}

static void dc_reset(Slice *s)
{
    int p = s->mpeg2 ? 1024 : 128;
    s->dc[0] = s->dc[1] = s->dc[2] = p;
}

static void pmv_zero(Slice *s)
{
    int *p = &s->pmv[0][0][0];
    int i;
    for (i = 0; i < 8; i++)
        p[i] = 0;
}

/* mpeg_decode_motion (ISO 11172-2 2.4.4.2): pred + the coded delta,
 * wrapped once into the f_code's range */
static int decode_motion(Slice *s, int fcode, int pred)
{
    int code = vlc(s, V_MOTION), sign, shift, delta, val, lim;
    if (code == 0)
        return pred;
    sign = get_bits(s, 1);
    shift = fcode - 1;
    if (shift > 0) {
        int residual = get_bits(s, shift);
        delta = ((code - 1) << shift) + residual + 1;
    } else {
        delta = code;
    }
    if (sign)
        delta = -delta;
    val = pred + delta;
    lim = 1 << (shift + 4);
    if (val < -lim)
        val += 2 * lim;
    else if (val >= lim)
        val -= 2 * lim;
    return val;
}

/* dmvector (Table B-11) */
static int read_dmv(Slice *s)
{
    if (get_bits(s, 1))
        return get_bits(s, 1) ? -1 : 1;
    return 0;
}

/* Run-level loop over B.14 / B.15 */
static void decode_ac(Slice *s, short *out, int first, int b15, int start)
{
    int which = b15 ? V_B15 : V_B14;
    const int *run_t = s->tab + s->tab[T_RUN];
    const int *level_t = s->tab + s->tab[T_LEVEL];
    int i = start;
    if (first && br_peek(&s->br, 1) == 1) {
        /* the first coefficient's '1s' is (0, +-1) */
        br_skip(&s->br, 1);
        out[0] = get_bits(s, 1) == 0 ? 1 : -1;
        i = 1;
    }
    for (;;) {
        int v = vlc(s, which), run, level;
        if (v == EOB_INDEX)
            break;
        if (v == ESCAPE_INDEX) {
            run = get_bits(s, 6);
            if (s->mpeg2) {
                level = get_sbits(s, 12);
            } else {
                level = get_sbits(s, 8);
                if (level == -128)
                    level = get_bits(s, 8) - 256;
                else if (level == 0)
                    level = get_bits(s, 8);
            }
        } else {
            run = run_t[v];
            level = level_t[v];
            if (get_bits(s, 1))
                level = -level;
        }
        i += run;
        if (i > 63)
            fail(s, E_AC);
        out[i] = (short)level;
        i += 1;
    }
}

static void decode_intra_block(Slice *s, short *out, int idx, int blk)
{
    int comp = blk < 4 ? 0 : (blk == 4 ? 1 : 2);
    int size = vlc(s, blk < 4 ? V_DC_LUM : V_DC_CHROMA);
    int diff = 0, dc;
    if (size > 0) {
        diff = get_bits(s, size);
        if (diff < (1 << (size - 1)))
            diff -= (1 << size) - 1;
    }
    s->dc[comp] += s->mpeg2 ? diff * (1 << (3 - s->dcprec)) : diff;
    dc = s->dc[comp];
    if (dc < -32768 || dc > 32767) {
        /* numpy refuses it in the twin's int16 store */
        s->info[0] = idx;
        s->info[1] = blk;
        s->info[2] = dc;
        fail(s, E_DC_RANGE);
    }
    out[0] = (short)dc;
    decode_ac(s, out, 0, s->mpeg2 && s->ivf, 1);
}

static void decode_blocks(Slice *s, int idx, int flags, int cbp)
{
    int blk;
    for (blk = 0; blk < 6; blk++) {
        short *out = s->coeffs + ((int64_t)idx * 6 + blk) * 64;
        if (!(cbp & (0x20 >> blk)))
            continue;
        if (flags & MB_INTRA)
            decode_intra_block(s, out, idx, blk);
        else
            decode_ac(s, out, 1, 0, 0);
    }
}

static int mb_type(Slice *s)
{
    if (s->pict == PICT_I) {
        if (get_bits(s, 1))
            return MB_INTRA;
        if (!get_bits(s, 1))
            fail(s, E_I_TYPE);
        return MB_QUANT | MB_INTRA;
    }
    return vlc(s, s->pict == PICT_P ? V_PTYPE : V_BTYPE);
}

/* _read_mv_pair: frame MC updates both PMV rows; field MC in a frame
 * picture reads two field vectors, the vertical one predicted from
 * PMV >> 1 and stored back doubled. Returns 1 for field MC, with the
 * vectors in mv2[v][xy] and the selects in sel[v]. */
static int read_mv_pair(Slice *s, int d, int motion_type, int mv2[2][2],
                        int sel[2])
{
    int v, xy;
    if (s->mpeg2 && motion_type == 1 && s->structure == 3) {
        for (v = 0; v < 2; v++) {
            int x, y;
            sel[v] = get_bits(s, 1);
            x = decode_motion(s, s->f_code[d][0], s->pmv[d][v][0]);
            s->pmv[d][v][0] = x;
            y = decode_motion(s, s->f_code[d][1], s->pmv[d][v][1] >> 1);
            s->pmv[d][v][1] = 2 * y;
            mv2[v][0] = x;
            mv2[v][1] = y;
        }
        return 1;
    }
    for (xy = 0; xy < 2; xy++) {
        int val = decode_motion(s, s->f_code[d][xy], s->pmv[d][0][xy]);
        s->pmv[d][0][xy] = val;
        s->pmv[d][1][xy] = val;
    }
    return 0;
}

static inline void set2(int *p, int a, int b)
{
    p[0] = a;
    p[1] = b;
}

/* one direction's vectors of a frame-picture MB (not dual prime) */
static void frame_direction(Slice *s, int idx, int d, int motion_type)
{
    int mv2[2][2], sel[2];
    int *mv = (d ? s->mv_bwd : s->mv_fwd) + idx * 2;
    int field = read_mv_pair(s, d, motion_type, mv2, sel);
    (d ? s->use_bwd : s->use_fwd)[idx] = 1;
    if (field) {
        int *out2 = (d ? s->mv_bwd2 : s->mv_fwd2) + idx * 4;
        s->field_mc[idx] = 1;
        set2(out2, mv2[0][0], mv2[0][1]);
        set2(out2 + 2, mv2[1][0], mv2[1][1]);
        set2((d ? s->sel_bwd : s->sel_fwd) + idx * 2, sel[0], sel[1]);
        set2(mv, mv2[0][0], 2 * mv2[0][1]);
    } else {
        /* MPEG-1 full_pel: the coded vector is in full pels */
        int k = s->full_pel[d] ? 2 : 1;
        set2(mv, s->pmv[d][0][0] * k, s->pmv[d][0][1] * k);
    }
}

/* _decode_mb: a macroblock of a frame picture (MPEG-1, or MPEG-2 with
 * picture_structure 3) */
static void decode_mb_frame(Slice *s, int idx)
{
    int flags = mb_type(s), motion_type = 2, cbp = 0;
    if (s->mpeg2 && s->structure == 3 && !s->fpfd) {
        if (flags & (MB_FOR | MB_BACK))
            motion_type = get_bits(s, 2);
        if (flags & (MB_PAT | MB_INTRA))
            s->dct_field[idx] = get_bits(s, 1) ? 1 : 0;
    }
    if (flags & MB_QUANT)
        s->q = qscale_of(s, get_bits(s, 5));
    s->qscale[idx] = s->q > 1 ? s->q : 1;

    if (flags & MB_INTRA) {
        s->intra[idx] = 1;
        pmv_zero(s);
        if (s->conceal) {
            int mv2[2][2], sel[2];
            read_mv_pair(s, 0, 2, mv2, sel);
            get_bits(s, 1);         /* marker */
        }
    } else {
        dc_reset(s);
    }

    if (motion_type == 3 && (flags & MB_FOR)) {
        /* frame-picture dual prime (13818-2 7.6.3.6) */
        int mx, my, dmx, dmy, m;
        mx = decode_motion(s, s->f_code[0][0], s->pmv[0][0][0]);
        dmx = read_dmv(s);
        my = decode_motion(s, s->f_code[0][1], s->pmv[0][0][1] >> 1);
        dmy = read_dmv(s);
        s->pmv[0][0][0] = s->pmv[0][1][0] = mx;
        s->pmv[0][0][1] = s->pmv[0][1][1] = my * 2;
        s->use_fwd[idx] = 1;
        s->field_mc[idx] = 1;
        set2(s->mv_fwd2 + idx * 4, mx, my);
        set2(s->mv_fwd2 + idx * 4 + 2, mx, my);
        set2(s->sel_fwd + idx * 2, 0, 1);
        set2(s->mv_fwd + idx * 2, mx, 2 * my);
        m = s->tff ? 1 : 3;
        s->dp[idx] = 1;
        set2(s->mv_dp2 + idx * 4,
             ((mx * m + (mx > 0)) >> 1) + dmx,
             ((my * m + (my > 0)) >> 1) + dmy - 1);
        m = 4 - m;
        set2(s->mv_dp2 + idx * 4 + 2,
             ((mx * m + (mx > 0)) >> 1) + dmx,
             ((my * m + (my > 0)) >> 1) + dmy + 1);
        set2(s->sel_dp + idx * 2, 1, 0);
    } else if (flags & MB_FOR) {
        frame_direction(s, idx, 0, motion_type);
    }
    if (flags & MB_BACK)
        frame_direction(s, idx, 1, motion_type);
    if (s->field_mc[idx] && (flags & (MB_FOR | MB_BACK)) &&
            !(flags & MB_FOR)) {
        /* backward-only field MB: the forward side must not contribute */
        set2(s->mv_fwd2 + idx * 4, 0, 0);
        set2(s->mv_fwd2 + idx * 4 + 2, 0, 0);
    }
    if (s->pict == PICT_P && !(flags & (MB_FOR | MB_INTRA))) {
        /* no-MV P macroblock: zero forward vector */
        pmv_zero(s);
        s->use_fwd[idx] = 1;
        set2(s->mv_fwd + idx * 2, 0, 0);
    }

    if (flags & MB_PAT) {
        cbp = vlc(s, V_CBP);
        if (cbp == 0 && !s->mpeg2)
            fail(s, E_CBP0);
    } else if (flags & MB_INTRA) {
        cbp = 0x3F;
    }
    if (cbp || (flags & MB_INTRA)) {
        decode_blocks(s, idx, flags, cbp);
        s->coded[idx] = 1;
    }

    s->has_prev = 1;
    s->prev_uf = s->use_fwd[idx];
    s->prev_ub = s->use_bwd[idx];
    set2(s->prev_mvf, s->mv_fwd[idx * 2], s->mv_fwd[idx * 2 + 1]);
    set2(s->prev_mvb, s->mv_bwd[idx * 2], s->mv_bwd[idx * 2 + 1]);
}

/* _read_field_mv: one direction's vectors in a field picture */
static void read_field_mv(Slice *s, int idx, int d, int motion_type,
                          int parity)
{
    int fx = s->f_code[d][0], fy = s->f_code[d][1];
    int *mv2 = (d ? s->mv_bwd2 : s->mv_fwd2) + idx * 4;
    int *sel = (d ? s->sel_bwd : s->sel_fwd) + idx * 2;
    if (motion_type == 1) {             /* whole-field MC, one vector */
        int sf = get_bits(s, 1), x, y;
        x = decode_motion(s, fx, s->pmv[d][0][0]);
        y = decode_motion(s, fy, s->pmv[d][0][1]);
        s->pmv[d][0][0] = s->pmv[d][1][0] = x;
        s->pmv[d][0][1] = s->pmv[d][1][1] = y;
        set2(mv2, x, y);
        set2(mv2 + 2, x, y);
        set2(sel, sf, sf);
    } else if (motion_type == 2) {      /* 16x8: upper and lower halves */
        int j;
        for (j = 0; j < 2; j++) {
            int sf = get_bits(s, 1), x, y;
            x = decode_motion(s, fx, s->pmv[d][j][0]);
            y = decode_motion(s, fy, s->pmv[d][j][1]);
            s->pmv[d][j][0] = x;
            s->pmv[d][j][1] = y;
            set2(mv2 + 2 * j, x, y);
            sel[j] = sf;
        }
    } else if (motion_type == 3) {      /* dual prime (P only) */
        int x, y, dmx, dmy, ox, oy;
        x = decode_motion(s, fx, s->pmv[d][0][0]);
        dmx = read_dmv(s);
        y = decode_motion(s, fy, s->pmv[d][0][1]);
        dmy = read_dmv(s);
        s->pmv[d][0][0] = s->pmv[d][1][0] = x;
        s->pmv[d][0][1] = s->pmv[d][1][1] = y;
        set2(mv2, x, y);                /* same-parity prediction */
        set2(mv2 + 2, x, y);
        set2(sel, parity, parity);
        /* opposite-parity prediction (7.6.3.6, m = 1 for fields) */
        ox = ((x + (x > 0)) >> 1) + dmx;
        oy = ((y + (y > 0)) >> 1) + dmy;
        oy += parity == 0 ? -1 : 1;
        s->dp[idx] = 1;
        set2(s->mv_dp2 + idx * 4, ox, oy);
        set2(s->mv_dp2 + idx * 4 + 2, ox, oy);
        set2(s->sel_dp + idx * 2, 1 - parity, 1 - parity);
    } else {
        fail(s, E_MOTION_TYPE0);
    }
}

/* _decode_mb_field: a macroblock of an MPEG-2 field picture */
static void decode_mb_field(Slice *s, int idx)
{
    int parity = s->structure - 1, flags = mb_type(s), motion_type = 0;
    int cbp = 0, d;
    if (flags & (MB_FOR | MB_BACK))
        motion_type = s->fpfd ? 2 : get_bits(s, 2);
    if (flags & MB_QUANT)
        s->q = qscale_of(s, get_bits(s, 5));
    s->qscale[idx] = s->q > 1 ? s->q : 1;

    if (flags & MB_INTRA) {
        s->intra[idx] = 1;
        pmv_zero(s);
        if (s->conceal) {
            read_field_mv(s, idx, 0, 1, parity);
            get_bits(s, 1);
            s->use_fwd[idx] = 0;
        }
        s->coded[idx] = 1;
    } else {
        dc_reset(s);
    }

    for (d = 0; d < 2; d++) {
        if (flags & (d ? MB_BACK : MB_FOR)) {
            read_field_mv(s, idx, d, motion_type, parity);
            (d ? s->use_bwd : s->use_fwd)[idx] = 1;
        }
    }
    if (s->pict == PICT_P && !(flags & (MB_FOR | MB_INTRA))) {
        /* no-MV P macroblock: same-parity field, zero vector */
        pmv_zero(s);
        s->use_fwd[idx] = 1;
        set2(s->mv_fwd2 + idx * 4, 0, 0);
        set2(s->mv_fwd2 + idx * 4 + 2, 0, 0);
        set2(s->sel_fwd + idx * 2, parity, parity);
    }

    if (flags & MB_PAT)
        cbp = vlc(s, V_CBP);
    else if (flags & MB_INTRA)
        cbp = 0x3F;
    if (cbp || (flags & MB_INTRA)) {
        decode_blocks(s, idx, flags, cbp);
        s->coded[idx] = 1;
    }

    s->has_prev = 1;
    s->prev_uf = s->use_fwd[idx];
    s->prev_ub = s->use_bwd[idx];
    for (d = 0; d < 4; d++) {
        s->prev_mvf[d] = s->mv_fwd2[idx * 4 + d];
        s->prev_mvb[d] = s->mv_bwd2[idx * 4 + d];
    }
    set2(s->prev_sf, s->sel_fwd[idx * 2], s->sel_fwd[idx * 2 + 1]);
    set2(s->prev_sb, s->sel_bwd[idx * 2], s->sel_bwd[idx * 2 + 1]);
}

/* _skipped_mb / _skipped_mb_field: P predicts with a zero vector (a
 * field picture from its own parity), B repeats the previous MB */
static void skipped_mb(Slice *s, int field, int idx)
{
    int k;
    if (s->pict == PICT_P) {
        s->use_fwd[idx] = 1;
        if (field) {
            int parity = s->structure - 1;
            for (k = 0; k < 4; k++)
                s->mv_fwd2[idx * 4 + k] = 0;
            set2(s->sel_fwd + idx * 2, parity, parity);
        } else {
            set2(s->mv_fwd + idx * 2, 0, 0);
        }
    } else if (s->pict == PICT_B && s->has_prev) {
        s->use_fwd[idx] = (unsigned char)s->prev_uf;
        s->use_bwd[idx] = (unsigned char)s->prev_ub;
        if (field) {
            for (k = 0; k < 4; k++) {
                s->mv_fwd2[idx * 4 + k] = s->prev_mvf[k];
                s->mv_bwd2[idx * 4 + k] = s->prev_mvb[k];
            }
            set2(s->sel_fwd + idx * 2, s->prev_sf[0], s->prev_sf[1]);
            set2(s->sel_bwd + idx * 2, s->prev_sb[0], s->prev_sb[1]);
        } else {
            set2(s->mv_fwd + idx * 2, s->prev_mvf[0], s->prev_mvf[1]);
            set2(s->mv_bwd + idx * 2, s->prev_mvb[0], s->prev_mvb[1]);
        }
    }
}

static void decode_slice(Slice *s, int64_t mb_y)
{
    int field = s->mpeg2 && s->structure != 3;
    int first = 1;
    int64_t mb_x = -1;

    s->q = qscale_of(s, get_bits(s, 5));
    while (get_bits(s, 1))      /* extra_bit_slice */
        get_bits(s, 8);
    dc_reset(s);
    pmv_zero(s);
    s->has_prev = 0;

    while (bit_pos(s) < s->size_bits && br_peek(&s->br, 23) != 0) {
        int64_t inc = 0, k;
        int idx;
        for (;;) {              /* macroblock_address_increment */
            int v = vlc(s, V_ADDR);
            if (v == ADDR_ESCAPE) {
                inc += 33;
                continue;
            }
            if (v == ADDR_STUFFING)
                continue;
            inc += v + 1;
            break;
        }
        if (first) {
            mb_x = inc - 1;
            first = 0;
            if (mb_x >= s->mb_w || mb_y >= s->mb_h)
                fail(s, E_ADDR);
        } else {
            /* skipped MBs, then this one; an MPEG-1 slice may wrap onto
             * the next row */
            for (k = 0; k < inc; k++) {
                if (++mb_x >= s->mb_w) {
                    mb_x = 0;
                    mb_y++;
                }
                if (mb_y >= s->mb_h)
                    fail(s, E_ADDR);
                if (k < inc - 1) {
                    idx = (int)(mb_y * s->mb_w + mb_x);
                    skipped_mb(s, field, idx);
                    s->ok[idx] = 1;
                }
            }
            if (inc > 1) {
                dc_reset(s);
                if (s->pict == PICT_P)
                    pmv_zero(s);
            }
        }
        idx = (int)(mb_y * s->mb_w + mb_x);
        if (field)
            decode_mb_field(s, idx);
        else
            decode_mb_frame(s, idx);
        s->ok[idx] = 1;
    }
}

int mpeg12_decode_slice(
    const unsigned char *buf, long long buf_size,
    const int *params, const int *tables,
    short *coeffs, int *qscale, unsigned char *intra,
    unsigned char *use_fwd, unsigned char *use_bwd,
    int *mv_fwd, int *mv_bwd, unsigned char *coded, unsigned char *ok,
    unsigned char *field_mc, unsigned char *dct_field,
    int *mv_fwd2, int *mv_bwd2, int *sel_fwd, int *sel_bwd,
    unsigned char *dp, int *mv_dp2, int *sel_dp, int *info)
{
    Slice s;
    br_init(&s.br, buf, buf_size);
    s.size_bits = (int64_t)buf_size * 8;
    s.tab = tables;
    s.mb_w = params[P_MB_W];
    s.mb_h = params[P_MB_H];
    s.mpeg2 = params[P_MPEG2];
    s.pict = params[P_PICT_TYPE];
    s.structure = params[P_STRUCTURE];
    s.fpfd = params[P_FRAME_PRED_FRAME_DCT];
    s.conceal = params[P_CONCEALMENT_MVS];
    s.qst = params[P_Q_SCALE_TYPE];
    s.ivf = params[P_INTRA_VLC_FORMAT];
    s.dcprec = params[P_INTRA_DC_PRECISION];
    s.tff = params[P_TOP_FIELD_FIRST];
    s.full_pel[0] = params[P_FULL_PEL_F];
    s.full_pel[1] = params[P_FULL_PEL_B];
    s.f_code[0][0] = params[P_F_CODE];
    s.f_code[0][1] = params[P_F_CODE + 1];
    s.f_code[1][0] = params[P_F_CODE + 2];
    s.f_code[1][1] = params[P_F_CODE + 3];
    s.coeffs = coeffs;
    s.qscale = qscale;
    s.intra = intra;
    s.use_fwd = use_fwd;
    s.use_bwd = use_bwd;
    s.mv_fwd = mv_fwd;
    s.mv_bwd = mv_bwd;
    s.coded = coded;
    s.ok = ok;
    s.field_mc = field_mc;
    s.dct_field = dct_field;
    s.mv_fwd2 = mv_fwd2;
    s.mv_bwd2 = mv_bwd2;
    s.sel_fwd = sel_fwd;
    s.sel_bwd = sel_bwd;
    s.dp = dp;
    s.mv_dp2 = mv_dp2;
    s.sel_dp = sel_dp;
    s.info = info;
    s.err = 0;
    if (setjmp(s.fail) == 0)
        decode_slice(&s, params[P_MB_Y]);
    return s.err;
}
