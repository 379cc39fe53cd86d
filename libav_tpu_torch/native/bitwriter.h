/* MSB-first bit writer — C twin of libav_tpu_torch/bitstream/putbits.py
 * (design per reference put_bits.h PutBitContext). */
#ifndef LIBAV_TPU_BITWRITER_H
#define LIBAV_TPU_BITWRITER_H

#include <stdint.h>

typedef struct {
    uint8_t *buf;
    int64_t cap;
    int64_t pos;         /* bytes written */
    uint64_t cache;      /* bits accumulate from LSB side of the count */
    int bits_in_cache;
    int overflow;
} BitWriter;

static inline void bw_init(BitWriter *bw, uint8_t *buf, int64_t cap)
{
    bw->buf = buf;
    bw->cap = cap;
    bw->pos = 0;
    bw->cache = 0;
    bw->bits_in_cache = 0;
    bw->overflow = 0;
}

static inline void bw_put(BitWriter *bw, int n, uint32_t value)
{
    bw->cache = (bw->cache << n) | (uint64_t)(value & ((n < 32) ? ((1u << n) - 1) : 0xFFFFFFFFu));
    bw->bits_in_cache += n;
    while (bw->bits_in_cache >= 8) {
        bw->bits_in_cache -= 8;
        if (bw->pos < bw->cap)
            bw->buf[bw->pos++] = (uint8_t)(bw->cache >> bw->bits_in_cache);
        else
            bw->overflow = 1;
    }
    bw->cache &= (1ULL << bw->bits_in_cache) - 1;
}

/* pad to byte boundary with the given bit */
static inline void bw_align(BitWriter *bw, int pad_bit)
{
    while (bw->bits_in_cache & 7)
        bw_put(bw, 1, (uint32_t)pad_bit);
}

#endif
