/* Standalone gprof harness for the native CABAC slice decoder (the
 * JAX package's libav_tpu/tools/cabac_prof.c, over the port's own copy of
 * native/cabac.c).
 *
 * Build:  gcc -O3 -pg -fno-strict-aliasing -I libav_tpu_torch/native \
 *             libav_tpu_torch/tools/cabac_prof.c -o build/cabac_prof
 * Run:    build/cabac_prof .bench_cache/calls.bin 50 && \
 *             gprof build/cabac_prof
 *
 * Reads the call dump written by replay_entropy.py --dump and replays
 * the slice decodes in a loop. Includes cabac.c directly so gprof sees
 * its static functions.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "../native/cabac.c"

typedef struct {
    int params[14];
    int has_sctx;
    long long dlen;
    unsigned char *data;
    long long collen;
    int *col;
} Call;

/* mirror of h264_cabac_host.reset_arena over the raw arena (layout as
 * in h264_cabac_decode_slice / h264_cabac_host.views) */
static void reset_arena_c(int *arena, int nmb)
{
    int *a = arena, i;
    int *intra = a;      a += 10 * nmb;     /* intra..cbp zeroed */
    int *mcslice = a;    a += nmb;
    int *mv = a;         a += 4 * nmb;      /* mv, ref_idx, sel */
    int *i4_modes = a;   a += 16 * nmb;
    int *luma_dc = a;    a += 48 * nmb;     /* luma_dc,chroma_dc,nnz_* */
    int *bref = a;       a += 32 * nmb;
    int *bmv = a;        a += 144 * nmb;    /* bmv, bmvd, bdirect */
    int *gslice = a;     a += nmb;
    int *i4grid = a;     a += 16 * nmb;
    int *t8 = a;         a += nmb;
    int *flags = a;      a += 4;
    int *sctx = a;

    memset(intra, 0, (size_t)(10 * nmb) * 4);
    memset(mv, 0, (size_t)(4 * nmb) * 4);
    memset(luma_dc, 0, (size_t)(48 * nmb) * 4);
    memset(bmv, 0, (size_t)(144 * nmb) * 4);
    for (i = 0; i < nmb; i++) mcslice[i] = -1;
    for (i = 0; i < 16 * nmb; i++) i4_modes[i] = 2;
    for (i = 0; i < 32 * nmb; i++) bref[i] = -2;
    for (i = 0; i < nmb; i++) gslice[i] = -1;
    for (i = 0; i < 16 * nmb; i++) i4grid[i] = -1;
    memset(t8, 0, (size_t)nmb * 4);
    flags[0] = 0;
    sctx[0] = sctx[1] = 0;
}

int main(int argc, char **argv)
{
    FILE *f = fopen(argc > 1 ? argv[1] : ".bench_cache/calls.bin", "rb");
    int reps = argc > 2 ? atoi(argv[2]) : 50;
    int ncalls, k, r, nmb = 0;
    Call *calls;
    int *arena;
    short *coeffs;
    int *psctx;
    struct timespec t0, t1;
    double dt;

    if (!f) { perror("open"); return 1; }
    if (fread(&ncalls, 4, 1, f) != 1) return 1;
    calls = calloc(ncalls, sizeof(Call));
    for (k = 0; k < ncalls; k++) {
        Call *c = &calls[k];
        if (fread(c->params, 4, 14, f) != 14) return 1;
        if (fread(&c->has_sctx, 4, 1, f) != 1) return 1;
        if (fread(&c->dlen, 8, 1, f) != 1) return 1;
        c->data = malloc(c->dlen + 8);
        if (fread(c->data, 1, c->dlen, f) != (size_t)c->dlen) return 1;
        if (fread(&c->collen, 8, 1, f) != 1) return 1;
        if (c->collen) {
            c->col = malloc(c->collen * 4);
            if (fread(c->col, 4, c->collen, f) != (size_t)c->collen)
                return 1;
        }
        if (c->params[0] * c->params[1] > nmb)
            nmb = c->params[0] * c->params[1];
    }
    fclose(f);

    arena = malloc(((size_t)nmb * 297 + 6) * 4);
    coeffs = malloc((size_t)nmb * 24 * 16 * 2);
    psctx = malloc((2 + (size_t)nmb * 24) * 4);

    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (r = 0; r < reps; r++) {
        for (k = 0; k < ncalls; k++) {
            Call *c = &calls[k];
            int rc;
            if (c->params[8] == 0)
                reset_arena_c(arena, c->params[0] * c->params[1]);
            rc = h264_cabac_decode_slice(
                c->data, c->dlen, c->params, c->col, coeffs, arena,
                0, c->has_sctx ? psctx : 0);
            if (rc) { fprintf(stderr, "rc=%d call %d\n", rc, k); return 1; }
        }
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    dt = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
    printf("%d calls x %d reps: %.3f ms/call, %.2f ms/frame(8f)\n",
           ncalls, reps, dt * 1000 / (reps * ncalls),
           dt * 1000 / (reps * 8));
    return 0;
}
