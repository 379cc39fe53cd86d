/* JPEG scan packer — host-serial Huffman bit packing for the MJPEG encoder
 * (role of reference mjpegenc.c encode_block, tensorized: input is the
 * per-component (blocks, 64) int16 zigzag-order quantized levels produced
 * by the TPU FDCT/quant pipeline in one batch).
 *
 * Must stay bit-identical to MJPEGEncoder._encode_scan_py. Output is
 * UNstuffed; the caller applies FF->FF00 stuffing. */

#include <stdint.h>
#include "bitwriter.h"

#define MAX_COMPS 4

static inline int csize(int v)
{
    int a = v < 0 ? -v : v;
    int n = 0;
    while (a) {
        n++;
        a >>= 1;
    }
    return n;
}

static void put_block(BitWriter *bw, const short *blk, int *dc_pred,
                      const unsigned int *dc_codes, const unsigned char *dc_sizes,
                      const unsigned int *ac_codes, const unsigned char *ac_sizes)
{
    int dc = blk[0];
    int diff = dc - *dc_pred;
    int sz = csize(diff);
    int run, k;
    bw_put(bw, dc_sizes[sz], dc_codes[sz]);
    if (sz)
        bw_put(bw, sz, diff >= 0 ? (uint32_t)diff
                                 : (uint32_t)(diff + (1 << sz) - 1));
    run = 0;
    for (k = 1; k < 64; k++) {
        int val = blk[k];
        if (val == 0) {
            run++;
            continue;
        }
        while (run > 15) {
            bw_put(bw, ac_sizes[0xF0], ac_codes[0xF0]);
            run -= 16;
        }
        sz = csize(val);
        {
            int sym = (run << 4) | sz;
            bw_put(bw, ac_sizes[sym], ac_codes[sym]);
            bw_put(bw, sz, val >= 0 ? (uint32_t)val
                                    : (uint32_t)(val + (1 << sz) - 1));
        }
        run = 0;
    }
    if (run)
        bw_put(bw, ac_sizes[0], ac_codes[0]);
    *dc_pred = dc;
}

int jpeg_encode_scan(
    const short **levels, const int *comp_meta, int n_comp,
    const unsigned int **dc_codes, const unsigned char **dc_sizes,
    const unsigned int **ac_codes, const unsigned char **ac_sizes,
    int mcus_x, int mcus_y,
    unsigned char *out_buf, long long out_cap, long long *out_len)
{
    BitWriter bw;
    int dc_pred[MAX_COMPS] = {0, 0, 0, 0};
    int mx, my, ci, bv, bh_i;

    if (n_comp < 1 || n_comp > MAX_COMPS)
        return -1;
    bw_init(&bw, out_buf, out_cap);

    for (my = 0; my < mcus_y; my++) {
        for (mx = 0; mx < mcus_x; mx++) {
            for (ci = 0; ci < n_comp; ci++) {
                int h = comp_meta[ci * 4 + 0];
                int v = comp_meta[ci * 4 + 1];
                int bw_c = comp_meta[ci * 4 + 2];
                for (bv = 0; bv < v; bv++) {
                    for (bh_i = 0; bh_i < h; bh_i++) {
                        long long bx = (long long)mx * h + bh_i;
                        long long by = (long long)my * v + bv;
                        const short *blk = levels[ci] + (by * bw_c + bx) * 64;
                        put_block(&bw, blk, &dc_pred[ci],
                                  dc_codes[ci], dc_sizes[ci],
                                  ac_codes[ci], ac_sizes[ci]);
                    }
                }
            }
        }
    }
    bw_align(&bw, 1);
    if (bw.overflow)
        return -2;
    *out_len = bw.pos;
    return 0;
}
