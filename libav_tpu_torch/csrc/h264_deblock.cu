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
// (spec 8.7.2.3 / 8.7.2.4, luma or chroma, bS 0..4). Two entry points:
//
//   h264_edge_filter_lines  K1's contract: (B, 8) int32 lines, per-line qp
//                           and bS, one thread per line, out of place.
//   h264_deblock_wave       one x+2y macroblock wave of the frame deblock,
//                           in place on the 4-padded int32 planes. One
//                           block per wave slot loads its MB's 20x20 luma
//                           and two 12x12 chroma patches into shared
//                           memory, filters the 4 vertical then 4
//                           horizontal luma edges (threads 0-15, one line
//                           each) and the 2 + 2 chroma edges of U
//                           (threads 16-23) and V (24-31) in spec order
//                           with a barrier between edges, and writes the
//                           patches back. Slots past the wave's end return.
//
// What bounds it on the card: not bytes. A 1080p frame's planes and grids
// fit in L2 many times over, and a wave moves ~61 x 2.7 KB. The bound is
// the serial chain of 254 dependent waves per 1080p frame, each a launch
// of at most 61 one-warp blocks: launch latency and the per-MB chain of
// 8 barrier-separated edges. The design keeps every edge of a macroblock
// in one block so a wave is one launch, not 16 gather/filter/scatter
// rounds; fusing waves (a persistent kernel or a CUDA graph) is later
// work.
//
// The alpha/beta/tc0 tables arrive as one packed int32 array
// [ALPHA(52) | BETA(52) | TC0(52x3)] built from the JAX package's tables.

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

__global__ void edge_filter_lines_kernel(const int* __restrict__ lines,
                                         int* __restrict__ out,
                                         const int* __restrict__ qp,
                                         const int* __restrict__ bs, int n,
                                         int a_off, int b_off, int chroma,
                                         const int* __restrict__ tab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = lines[8 * i + k];
  filter_line(v + 4, 1, qp[i], bs[i], a_off, b_off, chroma != 0, tab);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[8 * i + k] = v[k];
}

constexpr int kLumaPatch = 20;    // MB + 4 rows/cols above and left
constexpr int kChromaPatch = 12;
constexpr int kWaveThreads = 32;

// grids: (8, 4*mb_h, 4*mb_w) int32 =
//   bs_v, bs_h, qp_v, qp_h, qpu_v, qpu_h, qpv_v, qpv_h
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
  const int gsz = gw * 4 * mb_h;
  const int by0 = 4 * my, bx0 = 4 * mx;
  for (int e = 0; e < 8; ++e) {
    if (t < 16) {
      int *px, step, g;
      if (e < 4) {                    // vertical luma edge e, line = row t
        px = &L[(4 + t) * kLumaPatch + 4 + 4 * e];
        step = 1;
        g = (by0 + t / 4) * gw + bx0 + e;
        filter_line(px, step, grids[2 * gsz + g], grids[g], a_off, b_off,
                    false, tab);
      } else {                        // horizontal luma edge, line = col t
        const int k = e - 4;
        px = &L[(4 + 4 * k) * kLumaPatch + 4 + t];
        step = kLumaPatch;
        g = (by0 + k) * gw + bx0 + t / 4;
        filter_line(px, step, grids[3 * gsz + g], grids[gsz + g], a_off,
                    b_off, false, tab);
      }
    } else if (e < 4) {
      const int plane = (t - 16) >> 3;    // 0 = U, 1 = V
      const int i = (t - 16) & 7;
      int* Cp = C[plane];
      if (e < 2) {                    // vertical chroma edge at x 4e
        const int g = (by0 + i / 2) * gw + bx0 + 2 * e;
        filter_line(&Cp[(4 + i) * kChromaPatch + 4 + 4 * e], 1,
                    grids[(4 + 2 * plane) * gsz + g], grids[g], a_off,
                    b_off, true, tab);
      } else {                        // horizontal chroma edge at y 4k
        const int k = e - 2;
        const int g = (by0 + 2 * k) * gw + bx0 + i / 2;
        filter_line(&Cp[(4 + 4 * k) * kChromaPatch + 4 + i], kChromaPatch,
                    grids[(5 + 2 * plane) * gsz + g], grids[gsz + g],
                    a_off, b_off, true, tab);
      }
    }
    __syncthreads();
  }

  for (int i = t; i < kLumaPatch * kLumaPatch; i += kWaveThreads)
    yb[(i / kLumaPatch) * ys + i % kLumaPatch] = L[i];
  for (int i = t; i < kChromaPatch * kChromaPatch; i += kWaveThreads) {
    const int off = (i / kChromaPatch) * cs + i % kChromaPatch;
    ub[off] = C[0][i];
    vb[off] = C[1][i];
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (0 = launched).

int h264_edge_filter_lines(const int* lines, int* out, const int* qp,
                           const int* bs, int n, int a_off, int b_off,
                           int chroma, const int* tab, cudaStream_t stream) {
  const int threads = 256;
  edge_filter_lines_kernel<<<(n + threads - 1) / threads, threads, 0,
                             stream>>>(lines, out, qp, bs, n, a_off, b_off,
                                       chroma, tab);
  return static_cast<int>(cudaGetLastError());
}

int h264_deblock_wave(int* y, int* u, int* v, const int* grids, int mb_w,
                      int mb_h, int wave, int slots, int a_off, int b_off,
                      const int* tab, cudaStream_t stream) {
  deblock_wave_kernel<<<slots, kWaveThreads, 0, stream>>>(
      y, u, v, grids, mb_w, mb_h, wave, a_off, b_off, tab);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
