// H.264 intra assembly of one picture in one persistent launch, for Hopper
// (sm_90a): h264_intra_frame.
//
// It replaces no TPU kernel. The JAX package assembles intra pictures in
// XLA (libav_tpu/codecs/h264/device.py recon_h264_jit's wavefront scan);
// the port's plain version of it, ReconH264._wavefront in
// libav_tpu_torch/codecs/h264/device.py, walks the macroblock waves (x+y,
// or x+2y with I_4x4/I_8x8) from the host, one batched step per wave:
// 254 waves of some 1,500 small torch operations at 1080p, each a launch
// that does almost nothing on the card. This kernel computes the same
// bordered int32 planes, byte for byte, with the same availability rules:
//   - at = row_top[y] (or y > 0 without it), al = x > 0; the MB's
//     top-right is available where at and x < mb_w - 1;
//   - I_16x16 (V, H, DC, Plane), chroma (DC, H, V, Plane), I_4x4 (9
//     modes, in-MB top-right by decoding order) and I_8x8 (9 modes over
//     the 8.3.2.2.1 filtered reference samples, the plain version's
//     per-quadrant availability table), written out per mode; modes out
//     of range select as the plain version's tables and where chains do;
//   - inter MBs clamp(pred + resid); I_PCM samples replace the whole MB;
//   - neighbours are read from the planes as they stand (the 128 border,
//     the right margin), with no constrained-intra masking.
//
// Scheduling: a persistent wavefront, as h264_deblock_frame's. MB (x, y)
// reads samples of (x-1, y), (x-1..x+1, y-1) only, so any order that
// keeps those before it gives the waves' result, for the x+y and the
// x+2y orders alike. Each block of 256 threads takes whole MB rows in
// order from an atomic ticket (it only ever waits on rows whose blocks
// already run: no residency assumption, any mb_h) and walks its row left
// to right. Per MB:
//   - its own inputs (prediction, residual, modes, flags, I_PCM samples)
//     are loaded before the wait: no other MB changes them;
//   - one thread spins until row y-1 has published min(x+2, mb_w) MBs
//     (acquire, __nanosleep back-off); then the top row, the 8 top-right
//     samples, the left column and the corner of luma and both chroma
//     planes come into shared memory through L2 (ld.global.cg: L1 is
//     not coherent across SMs);
//   - I_16x16, inter and I_PCM luma take one thread per sample; chroma
//     one thread per sample on warps 4-7; I_4x4 (16 dependent 4x4
//     steps) and I_8x8 (4 dependent 8x8 steps, each with its filter)
//     run on warp 0 alone with __syncwarp between steps, beside the
//     chroma warps;
//   - the MB is written once, fenced, and row y publishes x+1 (release).
//
// What bounds it on the card: not bytes (a 1080p I_8x8 picture's int32
// inputs and bordered planes are 38.6 MB, 11.5 us at 3.35 TB/s) but the
// dependency chain, mb_w + 2 (mb_h - 1) = 254 MB steps at 1080p, each an
// L2 round trip for the neighbours and, for an I_4x4 MB, 16 dependent
// sub-block steps.

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// the plain version's table index: negative modes count from the end,
// the rest clamp into the 9 modes
__device__ __forceinline__ int table_mode(int m) {
  if (m < 0) m += 9;
  return m < 0 ? 0 : (m > 8 ? 8 : m);
}

// Z-order 4x4 block b -> its column and row in 4x4 units (spec 6.4.3)
__host__ __device__ constexpr int blk_x(int b) {
  return 2 * ((b >> 2) & 1) + (b & 1);
}
__host__ __device__ constexpr int blk_y(int b) {
  return 2 * (b >> 3) + ((b >> 1) & 1);
}

// bit b: block b below the MB's top row has its above-right block
// inside the MB and decoded before it (spec 6.4.9)
constexpr unsigned tr_in_mb_mask() {
  unsigned mask = 0;
  for (int b = 0; b < 16; ++b) {
    const int x = blk_x(b), y = blk_y(b);
    if (y == 0 || x == 3) continue;
    for (int k = 0; k < b; ++k)
      if (blk_x(k) == x + 1 && blk_y(k) == y - 1) mask |= 1u << b;
  }
  return mask;
}
constexpr unsigned kTrInMb = tr_in_mb_mask();

struct Smem {
  // luma: row 0 = corner, top 16, top-right 8; column 0 of rows 1..16 =
  // left; rows 1..16 x columns 1..16 = this MB as it is reconstructed
  int P[17][25];
  int C[2][9][9];   // U, V: row 0 = corner, top 8; column 0 = left
  int F[25];        // I_8x8: filtered top 0..15, left 16..23, corner 24
  int R[256];       // this MB's luma residual
  int M[16];        // this MB's I_4x4 / I_8x8 modes
};

// I_16x16 prediction of sample (r, c) (spec 8.3.3): 0 V, 1 H, 2 DC,
// anything else Plane
__device__ int pred16(const Smem& S, int mode, int r, int c, bool at,
                      bool al) {
  if (mode == 0) return S.P[0][1 + c];
  if (mode == 1) return S.P[1 + r][0];
  if (mode == 2) {
    int ts = 0, ls = 0;
    for (int i = 0; i < 16; ++i) {
      ts += S.P[0][1 + i];
      ls += S.P[1 + i][0];
    }
    return at && al ? (ts + ls + 16) >> 5
                    : at ? (ts + 8) >> 4 : al ? (ls + 8) >> 4 : 128;
  }
  // top[k] = P[0][1 + k], left[k] = P[1 + k][0], k = -1 the corner
  int hs = 0, vs = 0;
  for (int x = 1; x <= 8; ++x) {
    hs += x * (S.P[0][8 + x] - S.P[0][8 - x]);
    vs += x * (S.P[8 + x][0] - S.P[8 - x][0]);
  }
  const int b = (5 * hs + 32) >> 6, cc = (5 * vs + 32) >> 6;
  const int a = 16 * (S.P[0][16] + S.P[16][0]);
  return clip255((a + b * (c - 7) + cc * (r - 7) + 16) >> 5);
}

// chroma prediction of sample (r, c) of plane p (spec 8.3.4): 1 H, 2 V,
// 3 Plane, anything else DC
__device__ int pred_chroma(const Smem& S, int p, int mode, int r, int c,
                           bool at, bool al) {
  const int(*Q)[9] = S.C[p];
  if (mode == 1) return Q[1 + r][0];
  if (mode == 2) return Q[0][1 + c];
  if (mode == 3) {
    int hs = 0, vs = 0;
    for (int x = 1; x <= 4; ++x) {
      hs += x * (Q[0][4 + x] - Q[0][4 - x]);
      vs += x * (Q[4 + x][0] - Q[4 - x][0]);
    }
    const int b = (17 * hs + 16) >> 5, cc = (17 * vs + 16) >> 5;
    const int a = 16 * (Q[0][8] + Q[8][0]);
    return clip255((a + b * (c - 3) + cc * (r - 3) + 16) >> 5);
  }
  const int qx = c >> 2, qy = r >> 2;
  int ts = 0, ls = 0;
  for (int i = 0; i < 4; ++i) {
    ts += Q[0][1 + 4 * qx + i];
    ls += Q[1 + 4 * qy + i][0];
  }
  const int t = (ts + 2) >> 2, l = (ls + 2) >> 2;
  if (qx == qy)                                   // both sums
    return at && al ? (ts + ls + 4) >> 3 : at ? t : al ? l : 128;
  if (qy == 0) return at ? t : al ? l : 128;      // top right: top first
  return al ? l : at ? t : 128;                   // bottom left: left first
}

// I_4x4 prediction of sample (x, y) of the 4x4 block whose top-left
// sample is P[py][px] (spec 8.3.1.2). tr: its top-right samples are
// available (else they repeat its top row's last). at/al: top/left
// availability, read by DC only.
__device__ int pred4(const Smem& S, int mode, int x, int y, int py, int px,
                     bool tr, bool at, bool al) {
  const int* top = &S.P[py - 1][px];   // top[-1] is the corner
  auto T = [&](int i) { return top[i >= 4 && !tr ? 3 : i]; };
  auto L = [&](int j) { return j < 0 ? top[-1] : S.P[py + j][px - 1]; };
  auto f3 = [](int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; };
  auto f2 = [](int a, int b) { return (a + b + 1) >> 1; };
  switch (mode) {
    case 0: return T(x);
    case 1: return L(y);
    case 2: {
      const int ts = T(0) + T(1) + T(2) + T(3);
      const int ls = L(0) + L(1) + L(2) + L(3);
      return at && al ? (ts + ls + 4) >> 3
                      : at ? (ts + 2) >> 2 : al ? (ls + 2) >> 2 : 128;
    }
    case 3:                                         // diagonal down-left
      if (x == 3 && y == 3) return (T(6) + 3 * T(7) + 2) >> 2;
      return f3(T(x + y), T(x + y + 1), T(x + y + 2));
    case 4:                                         // diagonal down-right
      if (x > y) return f3(T(x - y - 2), T(x - y - 1), T(x - y));
      if (x < y) return f3(L(y - x - 2), L(y - x - 1), L(y - x));
      return f3(T(0), T(-1), L(0));
    case 5: {                                       // vertical-right
      const int z = 2 * x - y, k = x - (y >> 1);
      if (z >= 0 && !(z & 1)) return f2(T(k - 1), T(k));
      if (z >= 0) return f3(T(k - 2), T(k - 1), T(k));
      if (z == -1) return f3(L(0), T(-1), T(0));
      return f3(L(y - 1), L(y - 2), L(y - 3));
    }
    case 6: {                                       // horizontal-down
      const int z = 2 * y - x, k = y - (x >> 1);
      if (z >= 0 && !(z & 1)) return f2(L(k - 1), L(k));
      if (z >= 0) return f3(L(k - 2), L(k - 1), L(k));
      if (z == -1) return f3(L(0), T(-1), T(0));
      return f3(T(x - 1), T(x - 2), T(x - 3));
    }
    case 7: {                                       // vertical-left
      const int k = x + (y >> 1);
      if (!(y & 1)) return f2(T(k), T(k + 1));
      return f3(T(k), T(k + 1), T(k + 2));
    }
    default: {                                      // horizontal-up
      const int z = x + 2 * y, k = y + (x >> 1);
      if (z <= 4 && !(z & 1)) return f2(L(k), L(k + 1));
      if (z < 5) return f3(L(k), L(k + 1), L(k + 2));
      if (z == 5) return (L(2) + 3 * L(3) + 2) >> 2;
      return L(3);
    }
  }
}

// I_8x8 prediction of sample (x, y) over the filtered references in F
// (spec 8.3.2.2.2-10); dc precomputed.
__device__ int pred8(const Smem& S, int mode, int x, int y, int dc) {
  auto T = [&](int i) { return i < 0 ? S.F[24] : S.F[i]; };
  auto L = [&](int j) { return j < 0 ? S.F[24] : S.F[16 + j]; };
  auto f3 = [](int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; };
  auto f2 = [](int a, int b) { return (a + b + 1) >> 1; };
  switch (mode) {
    case 0: return T(x);
    case 1: return L(y);
    case 2: return dc;
    case 3:                                         // diagonal down-left
      if (x == 7 && y == 7) return (T(14) + 3 * T(15) + 2) >> 2;
      return f3(T(x + y), T(x + y + 1), T(x + y + 2));
    case 4:                                         // diagonal down-right
      if (x > y) return f3(T(x - y - 2), T(x - y - 1), T(x - y));
      if (x < y) return f3(L(y - x - 2), L(y - x - 1), L(y - x));
      return f3(L(0), T(-1), T(0));
    case 5: {                                       // vertical-right
      const int z = 2 * x - y, k = x - (y >> 1);
      if (z >= 0 && !(z & 1)) return f2(T(k - 1), T(k));
      if (z >= 0) return f3(T(k - 2), T(k - 1), T(k));
      if (z == -1) return f3(L(0), T(-1), T(0));
      return f3(L(y - 2 * x - 1), L(y - 2 * x - 2), L(y - 2 * x - 3));
    }
    case 6: {                                       // horizontal-down
      const int z = 2 * y - x, k = y - (x >> 1);
      if (z >= 0 && !(z & 1)) return f2(L(k - 1), L(k));
      if (z >= 0) return f3(L(k - 2), L(k - 1), L(k));
      if (z == -1) return f3(L(0), T(-1), T(0));
      return f3(T(x - 2 * y - 1), T(x - 2 * y - 2), T(x - 2 * y - 3));
    }
    case 7: {                                       // vertical-left
      const int k = x + (y >> 1);
      if (!(y & 1)) return f2(T(k), T(k + 1));
      return f3(T(k), T(k + 1), T(k + 2));
    }
    default: {                                      // horizontal-up
      const int z = x + 2 * y, k = y + (x >> 1);
      if (z > 13) return L(7);
      if (z == 13) return (L(6) + 3 * L(7) + 2) >> 2;
      if (!(z & 1)) return f2(L(k), L(k + 1));
      return f3(L(k), L(k + 1), L(k + 2));
    }
  }
}

// The 16 I_4x4 blocks of the MB in Z order on warp 0 (lanes 0-15 one
// sample each), each from the blocks before it (spec 8.3.1).
__device__ void intra4_mb(Smem& S, int lane, bool at, bool al,
                          bool atr_mb) {
  const int x = lane & 3, y = (lane >> 2) & 3;
  for (int b = 0; b < 16; ++b) {
    const int bx = blk_x(b), by = blk_y(b);
    const int px = 1 + 4 * bx, py = 1 + 4 * by;
    const bool tr = by > 0 ? (kTrInMb >> b) & 1 : bx == 3 ? atr_mb : at;
    if (lane < 16) {
      const int v = pred4(S, table_mode(S.M[b]), x, y, py, px, tr,
                          by == 0 ? at : true, bx == 0 ? al : true);
      S.P[py + y][px + x] = clip255(v + S.R[(4 * by + y) * 16 + 4 * bx + x]);
    }
    __syncwarp();
  }
}

// The 4 I_8x8 quadrants of the MB on warp 0 (2 samples a lane), each
// from the quadrants before it; the reference samples are filtered first
// (spec 8.3.2.2.1). Availability per quadrant (top, left, top-left,
// top-right) as the plain version's table.
__device__ void intra8_mb(Smem& S, int lane, bool at, bool al,
                          bool atr_mb) {
  for (int q = 0; q < 4; ++q) {
    const int qx = (q & 1) * 8, qy = (q >> 1) * 8;
    const int px = 1 + qx, py = 1 + qy;
    const bool qat = q < 2 ? at : true;
    const bool qal = q & 1 ? true : al;
    const bool qatl = q == 0 ? at && al : q == 1 ? at : q == 2 ? al : true;
    const bool qatr = q == 0 ? at : q == 1 ? atr_mb : q == 2;
    const int* top = &S.P[py - 1][px];   // top[-1] is the corner
    auto T = [&](int i) { return top[i >= 8 && !qatr ? 7 : i]; };
    auto L = [&](int j) { return S.P[py + j][px - 1]; };
    const int tl = top[-1];
    if (lane < 16) {
      const int i = lane;
      S.F[i] = i == 0 ? ((qatl ? tl : T(0)) + 2 * T(0) + T(1) + 2) >> 2
             : i == 15 ? (T(14) + 3 * T(15) + 2) >> 2
             : (T(i - 1) + 2 * T(i) + T(i + 1) + 2) >> 2;
    } else if (lane < 24) {
      const int j = lane - 16;
      S.F[lane] = j == 0 ? ((qatl ? tl : L(0)) + 2 * L(0) + L(1) + 2) >> 2
                : j == 7 ? (L(6) + 3 * L(7) + 2) >> 2
                : (L(j - 1) + 2 * L(j) + L(j + 1) + 2) >> 2;
    } else if (lane == 24) {
      S.F[24] = (L(0) + 2 * tl + T(0) + 2) >> 2;
    }
    __syncwarp();
    int ts = 0, ls = 0;
    for (int i = 0; i < 8; ++i) {
      ts += S.F[i];
      ls += S.F[16 + i];
    }
    const int dc = qat && qal ? (ts + ls + 8) >> 4
                 : qat ? (ts + 4) >> 3 : qal ? (ls + 4) >> 3 : 128;
    const int mode = table_mode(S.M[4 * q]);
    int v[2];
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h, x = k & 7, y = k >> 3;
      v[h] = clip255(pred8(S, mode, x, y, dc) +
                     S.R[(qy + y) * 16 + qx + x]);
    }
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      S.P[py + (k >> 3)][px + (k & 7)] = v[h];
    }
    __syncwarp();
  }
}

struct Inputs {
  const int *pred_y, *pred_u, *pred_v, *resid_y, *resid_u, *resid_v;
  const int *intra, *luma_mode, *chroma_mode;
  const int *i4, *i4_modes, *t8;   // i4 null: no I_4x4; t8 null: no I_8x8
  const int* row_top;              // null: top available below row 0
  const int *ipcm, *pcm_y, *pcm_u, *pcm_v;   // ipcm null: no I_PCM
};

__global__ void __launch_bounds__(kThreads)
intra_frame_kernel(int* __restrict__ fy, int* __restrict__ fu,
                   int* __restrict__ fv, const Inputs in, int mb_w,
                   int mb_h, int* scratch) {
  // scratch[0]: next row ticket; scratch[1 + r]: MBs of row r published
  __shared__ Smem S;
  __shared__ int row_s;
  const int t = threadIdx.x, lane = t & 31;
  const int ys = 16 * mb_w + 17, cs = 8 * mb_w + 9;   // bordered pitches
  int* progress = scratch + 1;

  for (;;) {
    if (t == 0) row_s = atomicAdd(scratch, 1);
    __syncthreads();
    const int my = row_s;
    __syncthreads();                    // row_s is rewritten next row
    if (my >= mb_h) return;
    const bool at = in.row_top ? in.row_top[my] != 0 : my > 0;
    cuda::atomic_ref<int, cuda::thread_scope_device> above(
        progress[my > 0 ? my - 1 : 0]);
    cuda::atomic_ref<int, cuda::thread_scope_device> mine(progress[my]);
    int seen = 0;                       // thread 0: row my-1's progress

    for (int mx = 0; mx < mb_w; ++mx) {
      const int m = my * mb_w + mx;
      const bool al = mx > 0, atr_mb = at && mx < mb_w - 1;
      // this MB's own inputs, final before the wait
      const bool intra = in.intra[m] != 0;
      const bool pcm = in.ipcm && in.ipcm[m] != 0;
      const bool i4 = !pcm && in.i4 && in.i4[m] != 0;
      const bool i8 = i4 && in.t8 && in.t8[m] != 0;
      const int ry = in.resid_y[256 * m + t];
      int luma = pcm ? in.pcm_y[256 * m + t] : in.pred_y[256 * m + t];
      const int cp = (t >> 6) & 1, ci = t & 63;   // warps 4-7: chroma
      int chroma = 0, rc = 0;
      if (t >= 128) {
        const int k = 64 * m + ci;
        chroma = pcm ? (cp ? in.pcm_v : in.pcm_u)[k]
                     : (cp ? in.pred_v : in.pred_u)[k];
        rc = (cp ? in.resid_v : in.resid_u)[k];
      }
      if (i4) {
        S.R[t] = ry;
        if (t < 16) S.M[t] = in.i4_modes[16 * m + t];
      }

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
      // neighbours, final after the acquire (the left ones this block
      // wrote itself)
      const int y0 = 16 * my + 1, x0 = 16 * mx + 1;
      const int cy0 = 8 * my + 1, cx0 = 8 * mx + 1;
      if (t < 25) {
        S.P[0][t] = __ldcg(fy + (y0 - 1) * ys + x0 - 1 + t);
      } else if (t >= 32 && t < 48) {
        S.P[t - 31][0] = __ldcg(fy + (y0 + t - 32) * ys + x0 - 1);
      } else if (t >= 64 && t < 128) {
        const int p = (t - 64) >> 5, i = t & 31;
        const int* f = p ? fv : fu;
        if (i < 9) {
          S.C[p][0][i] = __ldcg(f + (cy0 - 1) * cs + cx0 - 1 + i);
        } else if (i < 17) {
          S.C[p][i - 8][0] = __ldcg(f + (cy0 + i - 9) * cs + cx0 - 1);
        }
      }
      __syncthreads();

      if (i4) {
        if (t < 32) {
          if (i8) {
            intra8_mb(S, lane, at, al, atr_mb);
          } else {
            intra4_mb(S, lane, at, al, atr_mb);
          }
        }
      } else {
        const int r = t >> 4, c = t & 15;
        if (!pcm) {
          const int p = intra ? pred16(S, in.luma_mode[m], r, c, at, al)
                              : luma;
          luma = clip255(p + ry);
        }
        S.P[1 + r][1 + c] = luma;
      }
      if (t >= 128) {
        const int r = ci >> 3, c = ci & 7;
        if (!pcm) {
          const int p = intra ? pred_chroma(S, cp, in.chroma_mode[m], r, c,
                                            at, al)
                              : chroma;
          chroma = clip255(p + rc);
        }
        (cp ? fv : fu)[(cy0 + r) * cs + cx0 + c] = chroma;
      }
      __syncthreads();
      fy[(y0 + (t >> 4)) * ys + x0 + (t & 15)] = S.P[1 + (t >> 4)][1 + (t & 15)];
      __threadfence();
      __syncthreads();
      if (t == 0) mine.store(mx + 1, cuda::memory_order_release);
    }
  }
}

}  // namespace

extern "C" {

// The intra assembly of one picture in one launch (see the top of the
// file). fy: (16 mb_h + 17, 16 mb_w + 17), fu, fv: (8 mb_h + 9,
// 8 mb_w + 9) int32, filled with 128 by the caller; per MB int32 inputs
// (pred_y, resid_y, pcm_y: 256 each; chroma 64; i4_modes 16); i4, t8,
// row_top and ipcm may be null (then i4_modes, pcm_* are not read).
// scratch: mb_h + 1 int32, zeroed by the caller. Returns
// cudaGetLastError() after the launch (0 = launched).
int h264_intra_frame(int* fy, int* fu, int* fv, const int* pred_y,
                     const int* pred_u, const int* pred_v,
                     const int* resid_y, const int* resid_u,
                     const int* resid_v, const int* intra,
                     const int* luma_mode, const int* chroma_mode,
                     const int* i4, const int* i4_modes, const int* t8,
                     const int* row_top, const int* ipcm, const int* pcm_y,
                     const int* pcm_u, const int* pcm_v, int mb_w, int mb_h,
                     int* scratch, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Inputs in{pred_y, pred_u, pred_v, resid_y, resid_u, resid_v,
                  intra, luma_mode, chroma_mode, i4, i4_modes, t8,
                  row_top, ipcm, pcm_y, pcm_u, pcm_v};
  const int blocks = mb_h < sms ? mb_h : sms;
  intra_frame_kernel<<<blocks, kThreads, 0, stream>>>(fy, fu, fv, in, mb_w,
                                                      mb_h, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
