// H.264 in-loop deblocking edge filter for Hopper (sm_90a): kernel K1 of
// the port.
//
// Replaces the JAX package's Pallas kernel
// libav_tpu/ops/h264deblock.py:_edge_kernel (launched by
// _filter_edge_qp_pallas), which filters a batch of luma edge lines laid
// out position-major over 512 lanes, with the alpha/beta/tc0 lookups and
// every gather/scatter around it done in XLA, 16 calls per deblock wave.
//
// One __device__ function filters one line [p3 p2 p1 p0 q0 q1 q2 q3]
// (spec 8.7.2.3 / 8.7.2.4, luma or chroma, bS 0..4), and one filters
// every edge of a macroblock held in shared memory: the 4 vertical then
// 4 horizontal luma edges (threads 0-15, one line each) and the 2 + 2
// chroma edges of U (threads 16-23) and V (24-31) in spec order, with a
// barrier between edges. Entry points:
//
//   h264_edge_filter_lines  K1's contract: (B, 8) int32 lines, per-line qp
//                           and bS, out of place. See below.
//   h264_deblock_frame      the whole frame deblock in one launch, in place
//                           on the 4-padded int32 planes: the decoder's
//                           path. See below.
//   h264_deblock_wave       one x+2y macroblock wave of the frame deblock
//                           (254 launches per 1080p frame): one block per
//                           wave slot loads its MB's 20x20 luma and two
//                           12x12 chroma patches, filters them and writes
//                           them back. Kept as the yardstick of the frame
//                           kernel; slots past the wave's end return.
//
// h264_deblock_frame is a persistent wavefront. MB (x, y) reads pixels
// that only (x-1, y), (x, y-1) and (x+1, y-1) change before it, and it
// changes pixels that only later MBs read, so the x+2y schedule's result
// is reached by any order that keeps those three before it. Each block of
// one warp takes whole MB rows in order from an atomic ticket (so it only
// ever waits on rows whose blocks already run: no residency assumption)
// and walks its row left to right. Before MB x of row y one thread spins
// until row y-1 has published x+2 MBs (acquire, __nanosleep back-off);
// after it, the block writes its patch back, fences, and publishes x+1
// (release). Per MB, the block
//   - prefetches the next MB's 16x16 interior and its 8 x 4 x 4 grid
//     entries with 16-byte cp.async before it waits: only the MB itself
//     changes its interior before its turn, so the prefetch reads final
//     data, and no filter step waits on a global load (the
//     alpha/beta/tc0 table sits in shared memory too);
//   - keeps the 4 columns left of the MB in shared memory: they are the
//     previous MB's right columns, just filtered by this block (double
//     buffered patches, the carry copied from one buffer to the other);
//   - reads the 4 rows above, which row y-1's block wrote, after the
//     acquire and through L2 (ld.global.cg: L1 is not coherent across
//     SMs), 16 bytes per thread;
//   - writes back the interior, the left columns and the rows above with
//     16-byte stores (the above-left corner is neither read nor changed).
// The output equals the wave kernel's and the plain version's.
//
// What bounds it on the card: not bytes. A 1080p frame's padded planes
// and grids are 29.4 MB, 8.8 us at 3.35 TB/s. The frame kernel is bound
// by its dependency chain, mb_w + 2 (mb_h - 1) = 254 MB steps at 1080p,
// each an L2 round trip for the above rows, 8 barrier-separated edge
// steps, the write-back, a fence and the publish. The wave kernel pays a
// launch per step of that chain instead.
//
// h264_edge_filter_lines is bound by bytes: 32 bytes in and out per line
// and 8 of qp and bS, 75.5 MB at 2^20 lines, 22.5 us at 3.35 TB/s. Its
// first design gave a thread one line: eight 4-byte loads and stores 32
// bytes apart, so each warp instruction touched 32 sectors for 4 bytes of
// each, and the table lookups went to global memory (44% of the bound at
// 2^20 lines, 18% at 49,152). Now a warp takes tiles of 32 lines (1 KB):
//   - it reads a tile as two contiguous 512-byte warp loads of 16 bytes
//     per lane, stages it in shared memory (each 16-byte half-line in a
//     slot swizzled so that neither the copy in nor a lane's two 16-byte
//     reads of its own line meets a bank conflict), filters one line per
//     lane with filter_line, and writes the tile back the same way;
//   - the packed alpha/beta/tc0 table sits in shared memory, loaded once
//     per block;
//   - the grid holds 4 blocks of 8 warps per SM at most and each warp
//     walks its tiles grid-stride, loading the next tile before it
//     filters the current one, so loads stay in flight at 2^20 lines.
// The last tile may be partial; the lines must be 16-byte aligned.
//
// A third entry point, h264_edge_filter_pm, is kernel P2: the luma filter
// in the position-major layout, (8, B) int32, row k holding pixel slot k
// (p3..q3) of every line, with alpha and beta both at clip(qp, 0, 51), no
// offsets. It replaces the timing tool's Pallas kernel
// libav_tpu/tools/pallas_probe.py:_build_deblock, which used that layout
// over 512 lanes (so B % 512 == 0) and looked up alpha/beta/tc0 in XLA
// around the call. Bound by bytes: 40 B in and 32 B out per line, 75.5 MB
// at 2^20 lines (22.5 us at 3.35 TB/s), 3.5 MB at 49,152 (1.06 us, about
// what the card holds in flight in one DRAM round trip, so there the
// launch and the round trips set the time). Its first design gave a
// thread one line: ten 4-byte loads, then the alpha/beta and tc0 lookups
// in global memory, two serial round trips per line. Now a block owns
// spans of 256 lines, one line per thread, every grid-th span, with at
// most 4 blocks per SM:
//   - its first span comes straight into registers by coalesced 4-byte
//     loads (for a row, a warp reads 128 contiguous bytes), sent first;
//   - its later spans (B > 256 x 4 blocks x SMs: 135,168 lines on 132
//     SMs) go through a ring of 4 stages in dynamic shared memory (10 KB
//     each, asked for only by such launches, so that a launch of
//     one-span blocks starts as light as a plain kernel): one thread
//     arms a stage's mbarrier with its byte count
//     and starts ten 1-D bulk copies (cp.async.bulk, no tensor map), the
//     8 pixel rows' slices of the span, its qp and its bS, so up to four
//     spans are in flight while one is filtered; a stage is refilled
//     once every thread has read it (a block barrier);
//   - the packed alpha/beta/tc0 table is copied into shared memory while
//     those loads are in flight, so no lookup goes to global memory;
//   - thread i filters line i and stores its 8 slots with coalesced
//     4-byte stores.
// Why not bulk copies for every span: on this card a span's bulk copies
// and bulk stores took longer to come back than the same span's
// per-thread loads, and at 49,152 lines (one span per block) that
// latency is the time; at 2^20 lines the ring and per-thread loads both
// reach ~80% of the bound (PERF.md §6). Bulk copies need 16-byte
// aligned rows: B % 4 == 0 and every pointer 16-byte aligned; otherwise
// the same launch loads every span per thread. Any B >= 1; the last span
// may be partial.
//
// The alpha/beta/tc0 tables arrive as one packed int32 array
// [ALPHA(52) | BETA(52) | TC0(52x3)] built from the JAX package's tables.

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kNQp = 52;

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Filters the line whose q0 is at px[0]; p_i at px[-(i+1)*step],
// q_i at px[i*step].
__device__ __forceinline__ void filter_line(int* px, int step, int qp,
                                            int bs, int a_off, int b_off,
                                            bool chroma, const int* tab) {
  if (bs <= 0) return;
  const int qa = clip3(0, 51, qp + a_off);
  const int qb = clip3(0, 51, qp + b_off);
  const int alpha = tab[qa];
  const int beta = tab[kNQp + qb];
  const int p3 = px[-4 * step], p2 = px[-3 * step];
  const int p1 = px[-2 * step], p0 = px[-step];
  const int q0 = px[0], q1 = px[step];
  const int q2 = px[2 * step], q3 = px[3 * step];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta &&
        abs(q1 - q0) < beta))
    return;
  const bool ap = abs(p2 - p0) < beta;
  const bool aq = abs(q2 - q0) < beta;
  if (bs == 4) {
    const bool strong = abs(p0 - q0) < ((alpha >> 2) + 2);
    if (!chroma && strong && ap) {
      px[-step] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      px[-2 * step] = (p2 + p1 + p0 + q0 + 2) >> 2;
      px[-3 * step] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      px[-step] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (!chroma && strong && aq) {
      px[0] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      px[step] = (q2 + q1 + q0 + p0 + 2) >> 2;
      px[2 * step] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      px[0] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  const int tc0 = tab[2 * kNQp + 3 * qa + clip3(0, 2, bs - 1)];
  const int tc = chroma ? tc0 + 1 : tc0 + (ap ? 1 : 0) + (aq ? 1 : 0);
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  px[-step] = clip3(0, 255, p0 + delta);
  px[0] = clip3(0, 255, q0 - delta);
  if (!chroma) {
    const int hp = (p0 + q0 + 1) >> 1;
    if (ap) px[-2 * step] = p1 + clip3(-tc0, tc0, (p2 + hp - 2 * p1) >> 1);
    if (aq) px[step] = q1 + clip3(-tc0, tc0, (q2 + hp - 2 * q1) >> 1);
  }
}

constexpr int kLineWarps = 8;
constexpr int kLineThreads = 32 * kLineWarps;
constexpr int kTabInts = 5 * kNQp;      // ALPHA | BETA | TC0 (52 x 3)

// One tile of 32 lines as a lane holds it before staging: 16-byte chunks
// lane and 32 + lane of the tile, and the qp and bS of line `lane`.
struct LineTile {
  int4 a, b;
  int qp, bs;
};

// 16-byte chunk c (0..63) of a tile, half c & 1 of line c >> 1, goes to
// slot (c & ~1) | ((c & 1) ^ ((c >> 3) & 1)) in shared memory: eight
// lanes copying eight neighbouring chunks hit eight slots in a row, and
// lanes 8k..8k+7 reading the same half of their own lines hit slots whose
// banks are all different.
__device__ __forceinline__ int chunk_slot(int c) {
  return (c & ~1) | ((c & 1) ^ ((c >> 3) & 1));
}

// lines of the tile that starts at line `first`
__device__ __forceinline__ int tile_lines(int n, long first) {
  return n - first < 32 ? static_cast<int>(n - first) : 32;
}

__device__ __forceinline__ void load_tile(LineTile& t, long tile, int n,
                                          const int* __restrict__ lines,
                                          const int* __restrict__ qp,
                                          const int* __restrict__ bs,
                                          int lane) {
  const long first = 32 * tile;               // first line of the tile
  const int nl = tile_lines(n, first);
  const int4* src = reinterpret_cast<const int4*>(lines) + 2 * first;
  if ((lane >> 1) < nl) t.a = src[lane];
  if (((32 + lane) >> 1) < nl) t.b = src[32 + lane];
  if (lane < nl) {
    t.qp = qp[first + lane];
    t.bs = bs[first + lane];
  }
}

__global__ void __launch_bounds__(kLineThreads)
    edge_filter_lines_kernel(const int* __restrict__ lines,
                             int* __restrict__ out,
                             const int* __restrict__ qp,
                             const int* __restrict__ bs, int n, int a_off,
                             int b_off, int chroma,
                             const int* __restrict__ tab) {
  __shared__ int stab[kTabInts];
  __shared__ int4 stage[kLineWarps][64];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long tiles = (n + 31) / 32;
  const long stride = static_cast<long>(gridDim.x) * kLineWarps;
  long t = static_cast<long>(blockIdx.x) * kLineWarps + wib;
  LineTile cur = {}, nxt = {};
  if (t < tiles) load_tile(cur, t, n, lines, qp, bs, lane);
  for (int i = threadIdx.x; i < kTabInts; i += kLineThreads) stab[i] = tab[i];
  __syncthreads();
  int4* st = stage[wib];
  for (; t < tiles; t += stride) {
    if (t + stride < tiles) load_tile(nxt, t + stride, n, lines, qp, bs, lane);
    const long first = 32 * t;
    const int nl = tile_lines(n, first);
    if ((lane >> 1) < nl) st[chunk_slot(lane)] = cur.a;
    if (((32 + lane) >> 1) < nl) st[chunk_slot(32 + lane)] = cur.b;
    __syncwarp();
    if (lane < nl) {
      const int4 lo = st[chunk_slot(2 * lane)];
      const int4 hi = st[chunk_slot(2 * lane + 1)];
      int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      filter_line(v + 4, 1, cur.qp, cur.bs, a_off, b_off, chroma != 0,
                  stab);
      // only this lane reads or writes its line's two slots
      st[chunk_slot(2 * lane)] = make_int4(v[0], v[1], v[2], v[3]);
      st[chunk_slot(2 * lane + 1)] = make_int4(v[4], v[5], v[6], v[7]);
    }
    __syncwarp();
    int4* dst = reinterpret_cast<int4*>(out) + 2 * first;
    if ((lane >> 1) < nl) dst[lane] = st[chunk_slot(lane)];
    if (((32 + lane) >> 1) < nl) dst[32 + lane] = st[chunk_slot(32 + lane)];
    __syncwarp();
    cur = nxt;
  }
}

// ---------------------------------------------------------------------- //
// P2, h264_edge_filter_pm: spans of lines through a ring of bulk copies
// ---------------------------------------------------------------------- //

constexpr int kPmSpan = 256;        // lines per span = threads per block
constexpr int kPmStages = 4;        // ring depth in spans
constexpr int kPmBlocksPerSm = 4;

// One span as it sits in shared memory: row k holds pixel slot k of the
// span's lines, then their qp and bS; every row is kPmSpan ints.
struct PmStage {
  int x[8][kPmSpan];
  int qp[kPmSpan];
  int bs[kPmSpan];
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global to
// shared, counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One line of a span in registers: its 8 pixel slots, qp and bS.
struct PmLine {
  int v[8];
  int qp, bs;
};

__device__ __forceinline__ void pm_load(PmLine& l, const int* xT,
                                        const int* qp, const int* bs,
                                        long rows, long line) {
#pragma unroll
  for (int k = 0; k < 8; ++k) l.v[k] = xT[k * rows + line];
  l.qp = qp[line];
  l.bs = bs[line];
}

__device__ __forceinline__ void pm_filter_store(PmLine& l, int* out,
                                                long rows, long line,
                                                const int* stab) {
  filter_line(l.v + 4, 1, l.qp, l.bs, 0, 0, false, stab);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k * rows + line] = l.v[k];
}

// Dynamic shared memory of a launch that runs the ring: the stages on a
// 128-byte boundary, then their barriers. A launch without it asks for
// none, and its blocks start as light as a plain kernel's.
constexpr int kPmRingBytes = kPmStages * (sizeof(PmStage) + 8) + 128;

__global__ void __launch_bounds__(kPmSpan, kPmBlocksPerSm)
    edge_filter_pm_kernel(const int* __restrict__ xT, int* __restrict__ out,
                          const int* __restrict__ qp,
                          const int* __restrict__ bs, int n, int ring_on,
                          const int* __restrict__ tab) {
  extern __shared__ unsigned char pm_dyn[];
  __shared__ int stab[kTabInts];
  PmStage* st = reinterpret_cast<PmStage*>(
      (reinterpret_cast<unsigned long long>(pm_dyn) + 127) & ~127ull);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(st + kPmStages);
  const int t = threadIdx.x;
  const long rows = n;                           // one pixel slot
  // the first span straight into registers, before anything else: no
  // copy engine and no index arithmetic in its path
  PmLine l;
  const long line0 = static_cast<long>(blockIdx.x) * kPmSpan + t;
  const bool live = line0 < n;
  if (live) pm_load(l, xT, qp, bs, rows, line0);

  const int grid = gridDim.x;
  const int spans = (n + kPmSpan - 1) / kPmSpan;
  // this block's spans: blockIdx.x + j * grid, j < mine
  const int mine = (spans - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  auto first_of = [&](int j) {
    return static_cast<long>(blockIdx.x + j * grid) * kPmSpan;
  };
  auto lines_of = [&](int j) {
    const long left = n - first_of(j);
    return left < kPmSpan ? static_cast<int>(left) : kPmSpan;
  };
  // span j >= 1 sits in stage (j - 1) % kPmStages; thread 0 alone arms
  // its barrier and starts its ten bulk copies
  const bool ring = ring_on && mine > 1;
  auto load = [&](int j) {
    PmStage& s = st[(j - 1) % kPmStages];
    unsigned long long* bar = &full[(j - 1) % kPmStages];
    const long first = first_of(j);
    const unsigned nb = 4u * lines_of(j);
    mbar_expect_tx(bar, 10 * nb);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      bulk_load(s.x[k], xT + k * rows + first, nb, bar);
    bulk_load(s.qp, qp + first, nb, bar);
    bulk_load(s.bs, bs + first, nb, bar);
  };

  if (ring && t == 0) {
    for (int i = 0; i < kPmStages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 1; j <= kPmStages && j < mine; ++j) load(j);
  }
  for (int i = t; i < kTabInts; i += kPmSpan) stab[i] = tab[i];
  __syncthreads();
  if (live) pm_filter_store(l, out, rows, line0, stab);

  if (!ring) {     // one span, or rows not 16-byte aligned: per thread
    for (int j = 1; j < mine; ++j) {
      const long line = first_of(j) + t;
      if (line >= n) continue;
      pm_load(l, xT, qp, bs, rows, line);
      pm_filter_store(l, out, rows, line, stab);
    }
    return;
  }
  for (int j = 1; j < mine; ++j) {
    PmStage& s = st[(j - 1) % kPmStages];
    mbar_wait(&full[(j - 1) % kPmStages], ((j - 1) / kPmStages) & 1);
    if (t < lines_of(j)) {
#pragma unroll
      for (int k = 0; k < 8; ++k) l.v[k] = s.x[k][t];
      l.qp = s.qp[t];
      l.bs = s.bs[t];
      pm_filter_store(l, out, rows, first_of(j) + t, stab);
    }
    __syncthreads();     // every thread has read the stage: refill it
    if (t == 0 && j + kPmStages < mine) load(j + kPmStages);
  }
}

constexpr int kLumaPatch = 20;    // MB + 4 rows/cols above and left
constexpr int kChromaPatch = 12;
constexpr int kWaveThreads = 32;

// grids: (8, 4*mb_h, 4*mb_w) int32 =
//   bs_v, bs_h, qp_v, qp_h, qpu_v, qpu_h, qpv_v, qpv_h

// Every edge of one MB, in spec order, on its shared-memory patches: L is
// the 20x20 luma patch (MB at rows/cols 4..19), Cu and Cv the 12x12
// chroma patches (MB at 4..11). g is the MB's 4x4 corner of grid plane 0;
// grid plane k, 4x4 row r, column c is at g[k * gplane + r * gstride + c]
// (the frame grids in global memory, or a shared copy of the MB's own
// 8 x 4 x 4). Run by all 32 threads of the block; ends with a barrier.
__device__ void filter_macroblock(int* L, int* Cu, int* Cv, const int* g,
                                  int gstride, int gplane, int a_off,
                                  int b_off, const int* tab) {
  const int t = threadIdx.x;
  for (int e = 0; e < 8; ++e) {
    if (t < 16) {
      int *px, step, g0;
      if (e < 4) {                    // vertical luma edge e, line = row t
        px = &L[(4 + t) * kLumaPatch + 4 + 4 * e];
        step = 1;
        g0 = (t / 4) * gstride + e;
        filter_line(px, step, g[2 * gplane + g0], g[g0], a_off, b_off,
                    false, tab);
      } else {                        // horizontal luma edge, line = col t
        const int k = e - 4;
        px = &L[(4 + 4 * k) * kLumaPatch + 4 + t];
        step = kLumaPatch;
        g0 = k * gstride + t / 4;
        filter_line(px, step, g[3 * gplane + g0], g[gplane + g0], a_off,
                    b_off, false, tab);
      }
    } else if (e < 4) {
      const int plane = (t - 16) >> 3;    // 0 = U, 1 = V
      const int i = (t - 16) & 7;
      int* Cp = plane ? Cv : Cu;
      if (e < 2) {                    // vertical chroma edge at x 4e
        const int g0 = (i / 2) * gstride + 2 * e;
        filter_line(&Cp[(4 + i) * kChromaPatch + 4 + 4 * e], 1,
                    g[(4 + 2 * plane) * gplane + g0], g[g0], a_off, b_off,
                    true, tab);
      } else {                        // horizontal chroma edge at y 4k
        const int k = e - 2;
        const int g0 = (2 * k) * gstride + i / 2;
        filter_line(&Cp[(4 + 4 * k) * kChromaPatch + 4 + i], kChromaPatch,
                    g[(5 + 2 * plane) * gplane + g0], g[gplane + g0], a_off,
                    b_off, true, tab);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kWaveThreads)
deblock_wave_kernel(int* __restrict__ y, int* __restrict__ u,
                    int* __restrict__ v, const int* __restrict__ grids,
                    int mb_w, int mb_h, int wave, int a_off, int b_off,
                    const int* __restrict__ tab) {
  // slot s of wave w holds MB (w - 2*my, my), my = ylo + s
  const int ylo = max(0, (wave - mb_w + 2) / 2);
  const int my = ylo + blockIdx.x;
  const int mx = wave - 2 * my;
  if (my >= mb_h || mx < 0) return;   // uniform per block

  __shared__ int L[kLumaPatch * kLumaPatch];
  __shared__ int C[2][kChromaPatch * kChromaPatch];
  const int ys = 16 * mb_w + 4;       // padded row pitches
  const int cs = 8 * mb_w + 4;
  const int t = threadIdx.x;
  int* yb = y + (16 * my) * ys + 16 * mx;
  int* ub = u + (8 * my) * cs + 8 * mx;
  int* vb = v + (8 * my) * cs + 8 * mx;
  for (int i = t; i < kLumaPatch * kLumaPatch; i += kWaveThreads)
    L[i] = yb[(i / kLumaPatch) * ys + i % kLumaPatch];
  for (int i = t; i < kChromaPatch * kChromaPatch; i += kWaveThreads) {
    const int off = (i / kChromaPatch) * cs + i % kChromaPatch;
    C[0][i] = ub[off];
    C[1][i] = vb[off];
  }
  __syncthreads();

  const int gw = 4 * mb_w;
  filter_macroblock(L, C[0], C[1], grids + (4 * my) * gw + 4 * mx, gw,
                    gw * 4 * mb_h, a_off, b_off, tab);

  for (int i = t; i < kLumaPatch * kLumaPatch; i += kWaveThreads)
    yb[(i / kLumaPatch) * ys + i % kLumaPatch] = L[i];
  for (int i = t; i < kChromaPatch * kChromaPatch; i += kWaveThreads) {
    const int off = (i / kChromaPatch) * cs + i % kChromaPatch;
    ub[off] = C[0][i];
    vb[off] = C[1][i];
  }
}


// ---------------------------------------------------------------------- //
// h264_deblock_frame: the persistent wavefront (see the top of the file)
// ---------------------------------------------------------------------- //

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kTab = 5 * kNQp;   // ALPHA | BETA | TC0 (52 x 3)

// Two buffers of one MB's patches and grid entries; MB x of a row works
// in buffer x & 1. G holds the MB's 4x4 entries of the 8 grid planes.
struct FramePatches {
  int L[2][kLumaPatch * kLumaPatch];
  int C[2][2][kChromaPatch * kChromaPatch];   // [buffer][U, V]
  int G[2][8 * 16];
};

// Where the int4 pieces of MB (mx, my) lie, in the padded planes (global)
// and in a patch buffer (shared). Luma rows are 5 int4 wide (cols -4..15),
// chroma rows 3 (cols -4..7); piece c of a row covers cols 4c-4..4c-1.
struct MBView {
  int *y, *u, *v;
  const int* g;   // the MB's corner of grid plane 0
  int ys, cs;     // padded row pitches in ints
  int gw, gsz;    // grid row pitch and plane size in ints

  __device__ int4* gy(int row, int c4) const {  // row, c4 from the patch
    return reinterpret_cast<int4*>(y + row * ys + 4 * c4);
  }
  __device__ int4* gc(int p, int row, int c4) const {
    return reinterpret_cast<int4*>((p ? v : u) + row * cs + 4 * c4);
  }
};

__device__ __forceinline__ int4* sy(FramePatches& P, int b, int row,
                                    int c4) {
  return reinterpret_cast<int4*>(&P.L[b][row * kLumaPatch + 4 * c4]);
}

__device__ __forceinline__ int4* sc(FramePatches& P, int b, int p, int row,
                                    int c4) {
  return reinterpret_cast<int4*>(&P.C[b][p][row * kChromaPatch + 4 * c4]);
}

// The 16x16 luma and 2 x 8x8 chroma interiors and the grid entries of MB
// v into buffer b, plus (left) the 4 columns left of it: 128 int4 (+32),
// 4 (+1) per thread.
__device__ __forceinline__ void prefetch_mb(FramePatches& P, int b,
                                           const MBView& v, bool left) {
  const int t = threadIdx.x;
  {                                                  // grids 8 x 4 rows
    const int k = t / 4, r = t % 4;
    cp_async16(&P.G[b][k * 16 + r * 4], v.g + k * v.gsz + r * v.gw);
  }
  for (int i = t; i < 64; i += kWaveThreads) {        // luma 16 x 4
    const int r = 4 + i / 4, c4 = 1 + i % 4;
    cp_async16(sy(P, b, r, c4), v.gy(r, c4));
  }
  {                                                  // chroma 2 x 8 x 2
    const int p = t / 16, r = 4 + (t % 16) / 2, c4 = 1 + t % 2;
    cp_async16(sc(P, b, p, r, c4), v.gc(p, r, c4));
  }
  if (left) {                       // rows 0..15 (luma), 0..7 (chroma)
    if (t < 16) {
      cp_async16(sy(P, b, 4 + t, 0), v.gy(4 + t, 0));
    } else {
      const int p = (t - 16) / 8, r = 4 + (t - 16) % 8;
      cp_async16(sc(P, b, p, r, 0), v.gc(p, r, 0));
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kWaveThreads)
deblock_frame_kernel(int* __restrict__ y, int* __restrict__ u,
                     int* __restrict__ v, const int* __restrict__ grids,
                     int mb_w, int mb_h, int a_off, int b_off,
                     const int* __restrict__ tab, int* scratch) {
  // scratch[0]: next row ticket; scratch[1 + r]: MBs of row r published
  __shared__ __align__(16) FramePatches P;
  __shared__ int T[kTab];
  __shared__ int row_s;
  const int t = threadIdx.x;
  const int ys = 16 * mb_w + 4, cs = 8 * mb_w + 4;
  const int gw = 4 * mb_w, gsz = gw * 4 * mb_h;
  int* progress = scratch + 1;
  for (int i = t; i < kTab; i += kWaveThreads) T[i] = tab[i];

  for (;;) {
    if (t == 0) row_s = atomicAdd(scratch, 1);
    __syncthreads();
    const int my = row_s;
    __syncthreads();                    // row_s is rewritten next row
    if (my >= mb_h) return;

    auto view = [&](int mx) {
      return MBView{y + (16 * my) * ys + 16 * mx,
                    u + (8 * my) * cs + 8 * mx, v + (8 * my) * cs + 8 * mx,
                    grids + (4 * my) * gw + 4 * mx, ys, cs, gw, gsz};
    };
    cuda::atomic_ref<int, cuda::thread_scope_device> above(
        progress[my > 0 ? my - 1 : 0]);
    cuda::atomic_ref<int, cuda::thread_scope_device> mine(progress[my]);
    int seen = 0;                       // thread 0: row my-1's progress

    prefetch_mb(P, 0, view(0), true);   // the left padding columns too
    for (int mx = 0; mx < mb_w; ++mx) {
      const int b = mx & 1;
      const MBView cur = view(mx);
      const bool next = mx + 1 < mb_w;
      if (next) prefetch_mb(P, b ^ 1, view(mx + 1), false);

      if (my > 0 && t == 0) {
        const int need = min(mx + 2, mb_w);
        int sleep_ns = 8;
        while (seen < need) {
          seen = above.load(cuda::memory_order_acquire);
          if (seen < need) {
            __nanosleep(sleep_ns);
            sleep_ns = min(2 * sleep_ns, 256);
          }
        }
      }
      __syncthreads();
      {   // the 4 rows above, final after the acquire: 16 + 16 int4
        if (t < 16) {
          const int r = t / 4, c4 = 1 + t % 4;
          *sy(P, b, r, c4) = __ldcg(cur.gy(r, c4));
        } else {
          const int p = (t - 16) / 8, r = ((t - 16) % 8) / 2,
                    c4 = 1 + t % 2;
          *sc(P, b, p, r, c4) = __ldcg(cur.gc(p, r, c4));
        }
      }
      if (next) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      filter_macroblock(P.L[b], P.C[b][0], P.C[b][1], P.G[b], 4, 16, a_off,
                        b_off, T);

      // write back: interiors, left columns, rows above
      for (int i = t; i < 64; i += kWaveThreads) {
        const int r = 4 + i / 4, c4 = 1 + i % 4;
        *cur.gy(r, c4) = *sy(P, b, r, c4);
      }
      {
        const int p = t / 16, r = 4 + (t % 16) / 2, c4 = 1 + t % 2;
        *cur.gc(p, r, c4) = *sc(P, b, p, r, c4);
      }
      if (t < 16) {
        *cur.gy(4 + t, 0) = *sy(P, b, 4 + t, 0);
        const int r = t / 4, c4 = 1 + t % 4;
        *cur.gy(r, c4) = *sy(P, b, r, c4);
        // carry: this MB's right columns are the next one's left
        *sy(P, b ^ 1, 4 + t, 0) = *sy(P, b, 4 + t, 4);
      } else {
        const int p = (t - 16) / 8, r = 4 + (t - 16) % 8;
        *cur.gc(p, r, 0) = *sc(P, b, p, r, 0);
        const int ra = ((t - 16) % 8) / 2, c4 = 1 + t % 2;
        *cur.gc(p, ra, c4) = *sc(P, b, p, ra, c4);
        *sc(P, b ^ 1, p, r, 0) = *sc(P, b, p, r, 2);
      }
      __threadfence();
      __syncthreads();
      if (t == 0) mine.store(mx + 1, cuda::memory_order_release);
    }
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 = launched).

// lines and out: (n, 8) int32, 16-byte aligned; n >= 1.
int h264_edge_filter_lines(const int* lines, int* out, const int* qp,
                           const int* bs, int n, int a_off, int b_off,
                           int chroma, const int* tab, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = (static_cast<long>(n) + 31) / 32;
  const long want = (tiles + kLineWarps - 1) / kLineWarps;
  const long blocks = want < 4L * sms ? want : 4L * sms;
  edge_filter_lines_kernel<<<static_cast<unsigned>(blocks), kLineThreads, 0,
                             stream>>>(lines, out, qp, bs, n, a_off, b_off,
                                       chroma, tab);
  return static_cast<int>(cudaGetLastError());
}

// P2: xT and out are (8, n) int32, position-major; luma, no offsets.
// The ring of bulk copies runs where blocks own more than one span and
// the rows are 16-byte aligned (n % 4 == 0, every pointer 16-byte
// aligned); otherwise the same kernel loads per thread.
int h264_edge_filter_pm(const int* xT, int* out, const int* qp,
                        const int* bs, int n, const int* tab,
                        cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const long spans = (static_cast<long>(n) + kPmSpan - 1) / kPmSpan;
  const long most = static_cast<long>(kPmBlocksPerSm) * sms;
  const long blocks = spans < most ? spans : most;
  const int ring = spans > blocks && n % 4 == 0 && aligned(xT) &&
                   aligned(out) && aligned(qp) && aligned(bs);
  edge_filter_pm_kernel<<<static_cast<unsigned>(blocks), kPmSpan,
                          ring ? kPmRingBytes : 0, stream>>>(
      xT, out, qp, bs, n, ring, tab);
  return static_cast<int>(cudaGetLastError());
}

int h264_deblock_wave(int* y, int* u, int* v, const int* grids, int mb_w,
                      int mb_h, int wave, int slots, int a_off, int b_off,
                      const int* tab, cudaStream_t stream) {
  deblock_wave_kernel<<<slots, kWaveThreads, 0, stream>>>(
      y, u, v, grids, mb_w, mb_h, wave, a_off, b_off, tab);
  return static_cast<int>(cudaGetLastError());
}

// The whole frame deblock in one launch. scratch: mb_h + 1 int32, zeroed
// by the caller; one block of 32 threads per MB row at most.
int h264_deblock_frame(int* y, int* u, int* v, const int* grids, int mb_w,
                       int mb_h, int a_off, int b_off, const int* tab,
                       int* scratch, cudaStream_t stream) {
  deblock_frame_kernel<<<mb_h, kWaveThreads, 0, stream>>>(
      y, u, v, grids, mb_w, mb_h, a_off, b_off, tab, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
