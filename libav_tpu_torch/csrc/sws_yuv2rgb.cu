// Planar 8-bit YUV to interleaved rgb24/bgr24 for Hopper (sm_90a):
// kernel `sws_yuv2rgb` of the port.
//
// Replaces no Pallas kernel: the JAX package runs this stage as one
// XLA-fused float32 elementwise program, libav_tpu/swscale/__init__.py
// SwsContext._yuv_rgb_jit (nearest chroma upsample, BT.601 with the
// limited- or full-range constants, round half to even, clip to
// [0, 255]). Its output is the bar, byte for byte, so every rounding
// step here is written out with __fmul_rn / __fadd_rn / __fmaf_rn: the
// build does not pass -fmad=false, and nvcc would otherwise contract
// a*b+c on its own and round once where XLA rounded twice.
//
// Where XLA rounds. XLA's CPU backend contracts some multiply-adds of
// that program into FMAs, and which ones depends on the width (read from
// its object code; libav_tpu_torch/swscale/yuv2rgb.py says why). With
// ys = y - oy, c = u - 128 or v - 128, all exact:
//   rb_form 0: r = fma(ys, ky, kru*v),  b likewise with kbv*u
//   rb_form 1: r = fma(kru, v, ys*ky),  b likewise
//   g_form 0:  g = fma(ys, ky, kgu*u) + kgv*v
//   g_form 1:  g = fma(kgv, v, fma(kgu, u, ys*ky))
//   g_form 2:  g = fma(kgv, v, fma(ys, ky, kgu*u))
// where every product and sum not inside an fma is rounded to float32.
// The wrapper passes the forms and the float32 constants; rb_form 0
// comes only with g_form 0, so four pairs occur (FORM 0-3 below). The
// plain version beside it (yuv2rgb.py) computes the same steps.
//
// What bounds it on the card: bytes. Per pixel it reads 1 + 2/k chroma
// bytes (k pixels per chroma sample) and writes 3, with ~25 simple
// operations, far under the card's operations-per-byte line: at
// 1920x1080 4:2:0 3,110,400 bytes in and 6,220,800 out, 2.79 us at
// 3.35 TB/s. The first design (one thread per pixel, three 1-byte
// stores at stride 3, I2F/F2I conversions) ran at a quarter of that:
// bound by instructions and memory transactions per byte, not by DRAM.
//
// Design: one launch per frame. A thread takes a run of 16 adjacent
// pixels on one row, or on two rows when the chroma is vertically
// subsampled (the two rows share one chroma row, so its bytes are loaded
// and its products formed once for both). A warp takes 32 neighbouring
// runs of one row pair (a row segment of 512 pixels), a block 4 warps.
//   - Loads: 16 luma bytes per row as one 16-byte load, the run's
//     16 >> sub_w chroma bytes of U and of V as one load each.
//   - Arithmetic: a byte becomes the float 2^23 + byte by one byte
//     permute (PRMT) and leaves as the low byte of 1.5 * 2^23 + x after
//     the clip (round half to even in the add), so no I2F/F2I conversion
//     runs; the per-pixel float steps are the forms above, unchanged.
//   - Stores: a run's 48 output bytes are built in 12 registers. When
//     every active lane of the warp is whole and aligned, the warp stages
//     its 32 x 48 bytes in shared memory and writes them back as
//     contiguous 16-byte stores (512 bytes per warp instruction); a lane
//     that is not (the last partial run of a row, a chroma or luma row
//     not 16-byte aligned, an output row pitch 3W not a multiple of 16)
//     takes a scalar path in the same launch: byte loads and byte stores
//     for its n <= 16 pixels, the same arithmetic.
// Rows and chroma rows are addressed through the planes' strides, so a
// cropped view needs no copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 16;              // luma pixels per thread and row
constexpr int kWarps = 4;             // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr float kTwo23 = 8388608.0f;  // 2^23
constexpr float kMagic = 12582912.0f; // 1.5 * 2^23

struct Yuv2RgbConsts {
  float ky, oy, kru, kgu, kgv, kbv;
  int rb_form;   // see the note above
  int g_form;
};

// byte i (0..3) of w as the float 2^23 + byte (exact)
__device__ __forceinline__ float byte_f(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + i));
}

// round half to even and clip to [0, 255] (rintf, then the clip: the same
// for finite x), as the low byte of the result
__device__ __forceinline__ uint32_t to_u8_bits(float x) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(x, 0.0f), 255.0f), kMagic));
}

// word with byte p (0..3) replaced by byte 0 of b
__device__ __forceinline__ uint32_t put_byte(uint32_t word, uint32_t b,
                                             int p) {
  return __byte_perm(word, b, (0x3210 & ~(0xF << (4 * p))) | (4 << (4 * p)));
}

__device__ __forceinline__ bool aligned(const void* p, int n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// FORM 0: rb_form 0, g_form 0; FORM 1 + g: rb_form 1, g_form g.
// ROWS 2: the thread takes rows 2g and 2g+1, which share a chroma row.
template <int SW, int ROWS, int FORM>
__global__ void __launch_bounds__(kThreads)
    yuv2rgb_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
                   const uint8_t* __restrict__ v, uint8_t* __restrict__ out,
                   int w, int h, long ys_stride, long us_stride,
                   long vs_stride, int sub_h, int runs, int segs, int groups,
                   int bgr, const Yuv2RgbConsts c) {
  constexpr int kC = kRun >> SW;            // chroma bytes per run
  constexpr int kCW = (kC + 3) / 4;         // ... in 32-bit words
  __shared__ uint4 stage[kWarps][3 * 32];

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long warp = static_cast<long>(blockIdx.x) * kWarps + wib;
  if (warp >= static_cast<long>(groups) * segs) return;   // whole warp
  const int grp = static_cast<int>(warp / segs);
  const int seg = static_cast<int>(warp - static_cast<long>(grp) * segs);
  const int run = seg * 32 + lane;
  const int x0 = run * kRun;
  const int n = run < runs ? min(kRun, w - x0) : 0;   // pixels of this lane
  const int row0 = grp * ROWS;
  const int nrows = min(ROWS, h - row0);
  const int cy = row0 >> sub_h;

  const uint8_t* up = u + cy * us_stride + (x0 >> SW);
  const uint8_t* vp = v + cy * vs_stride + (x0 >> SW);
  bool vec[ROWS];
  uint32_t uw[kCW], vw[kCW], yw[ROWS][4];
  const bool cvec = n == kRun && aligned(up, kC) && aligned(vp, kC);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const uint8_t* yp = y + (row0 + r) * ys_stride + x0;
    const uint8_t* op = out + (static_cast<long>(row0 + r) * w + x0) * 3;
    vec[r] = cvec && r < nrows && aligned(yp, 16) && aligned(op, 16);
  }
  // loads
  if (cvec) {
    if constexpr (kC == 16) {
      const uint4 a = *reinterpret_cast<const uint4*>(up);
      const uint4 b = *reinterpret_cast<const uint4*>(vp);
      uw[0] = a.x; uw[1] = a.y; uw[2] = a.z; uw[3] = a.w;
      vw[0] = b.x; vw[1] = b.y; vw[2] = b.z; vw[3] = b.w;
    } else if constexpr (kC == 8) {
      const uint2 a = *reinterpret_cast<const uint2*>(up);
      const uint2 b = *reinterpret_cast<const uint2*>(vp);
      uw[0] = a.x; uw[1] = a.y;
      vw[0] = b.x; vw[1] = b.y;
    } else {
      uw[0] = *reinterpret_cast<const uint32_t*>(up);
      vw[0] = *reinterpret_cast<const uint32_t*>(vp);
    }
  } else {
    const int cn = (n + (1 << SW) - 1) >> SW;
#pragma unroll
    for (int k = 0; k < kCW; ++k) uw[k] = vw[k] = 0;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      if (i < cn) {
        uw[i >> 2] |= static_cast<uint32_t>(up[i]) << (8 * (i & 3));
        vw[i >> 2] |= static_cast<uint32_t>(vp[i]) << (8 * (i & 3));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const uint8_t* yp = y + (row0 + r) * ys_stride + x0;
    if (vec[r]) {
      const uint4 a = *reinterpret_cast<const uint4*>(yp);
      yw[r][0] = a.x; yw[r][1] = a.y; yw[r][2] = a.z; yw[r][3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) yw[r][k] = 0;
      if (r < nrows) {
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          if (i < n)
            yw[r][i >> 2] |= static_cast<uint32_t>(yp[i]) << (8 * (i & 3));
      }
    }
  }

  // arithmetic: channel 0 and 2 of the output take (k0, c0) and (k2, c2),
  // red's and blue's constants and chroma, swapped for bgr24
  const float ybias = kTwo23 + c.oy;          // oy is 0 or 16: exact
  const float cbias = kTwo23 + 128.0f;
  const float k0 = bgr ? c.kbv : c.kru, k2 = bgr ? c.kru : c.kbv;
  uint32_t ow[ROWS][12];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int k = 0; k < 12; ++k) ow[r][k] = 0;
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const float uc = __fsub_rn(byte_f(uw[j >> 2], j & 3), cbias);
    const float vc = __fsub_rn(byte_f(vw[j >> 2], j & 3), cbias);
    const float c0 = bgr ? uc : vc, c2 = bgr ? vc : uc;
    float p0 = 0.0f, p2 = 0.0f, pgu = 0.0f, pgv = 0.0f;
    if constexpr (FORM == 0) {
      p0 = __fmul_rn(k0, c0);
      p2 = __fmul_rn(k2, c2);
    }
    if constexpr (FORM == 0 || FORM == 1 || FORM == 3) pgu = __fmul_rn(c.kgu, uc);
    if constexpr (FORM == 0 || FORM == 1) pgv = __fmul_rn(c.kgv, vc);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int s = 0; s < (1 << SW); ++s) {
        const int i = (j << SW) + s;          // pixel of the run
        const float ys = __fsub_rn(byte_f(yw[r][i >> 2], i & 3), ybias);
        const float yf = __fmul_rn(ys, c.ky);
        float ch0, ch2, g;
        if constexpr (FORM == 0) {
          ch0 = __fmaf_rn(ys, c.ky, p0);
          ch2 = __fmaf_rn(ys, c.ky, p2);
        } else {
          ch0 = __fmaf_rn(k0, c0, yf);
          ch2 = __fmaf_rn(k2, c2, yf);
        }
        if constexpr (FORM <= 1) {
          g = __fadd_rn(__fmaf_rn(ys, c.ky, pgu), pgv);
        } else if constexpr (FORM == 2) {
          g = __fmaf_rn(c.kgv, vc, __fmaf_rn(c.kgu, uc, yf));
        } else {
          g = __fmaf_rn(c.kgv, vc, __fmaf_rn(ys, c.ky, pgu));
        }
        const uint32_t bytes[3] = {to_u8_bits(ch0), to_u8_bits(g),
                                   to_u8_bits(ch2)};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int b = 3 * i + q;
          ow[r][b >> 2] = put_byte(ow[r][b >> 2], bytes[q], b & 3);
        }
      }
    }
  }

  // stores
  uint4* st = stage[wib];
  const unsigned active = __ballot_sync(0xffffffffu, n > 0);
  const int m = __popc(active);               // active lanes: 0 .. m-1
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nrows) break;                    // uniform in the warp
    uint8_t* orow = out + static_cast<long>(row0 + r) * w * 3;
    const unsigned whole = __ballot_sync(0xffffffffu, vec[r]);
    if (whole == active) {
      if (n > 0) {
        st[3 * lane] = make_uint4(ow[r][0], ow[r][1], ow[r][2], ow[r][3]);
        st[3 * lane + 1] = make_uint4(ow[r][4], ow[r][5], ow[r][6], ow[r][7]);
        st[3 * lane + 2] =
            make_uint4(ow[r][8], ow[r][9], ow[r][10], ow[r][11]);
      }
      __syncwarp();
      uint4* base = reinterpret_cast<uint4*>(orow + 3L * seg * 32 * kRun);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int ci = 32 * k + lane;
        if (ci < 3 * m) base[ci] = st[ci];
      }
      __syncwarp();
    } else if (vec[r]) {
      uint4* o = reinterpret_cast<uint4*>(orow + 3L * x0);
      o[0] = make_uint4(ow[r][0], ow[r][1], ow[r][2], ow[r][3]);
      o[1] = make_uint4(ow[r][4], ow[r][5], ow[r][6], ow[r][7]);
      o[2] = make_uint4(ow[r][8], ow[r][9], ow[r][10], ow[r][11]);
    } else {
      uint8_t* o = orow + 3L * x0;
#pragma unroll
      for (int b = 0; b < 3 * kRun; ++b)
        if (b < 3 * n) o[b] = static_cast<uint8_t>(ow[r][b >> 2] >> (8 * (b & 3)));
    }
  }
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, const uint8_t*,
                        uint8_t*, int, int, long, long, long, int, int, int,
                        int, int, Yuv2RgbConsts);

// FORM 0 and 1 (g_form 0) come only with horizontally subsampled chroma
template <int SW, int ROWS>
Kernel pick(int form) {
  if constexpr (SW > 0) {
    if (form == 0) return yuv2rgb_kernel<SW, ROWS, 0>;
    if (form == 1) return yuv2rgb_kernel<SW, ROWS, 1>;
  }
  if (form == 2) return yuv2rgb_kernel<SW, ROWS, 2>;
  if (form == 3) return yuv2rgb_kernel<SW, ROWS, 3>;
  return nullptr;
}

}  // namespace

// sub_w, sub_h: log2 of the chroma subsampling, 0..2 each. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments no kernel takes.
extern "C" int sws_yuv2rgb(const void* y, const void* u, const void* v,
                           void* out, int w, int h, long ys_stride,
                           long us_stride, long vs_stride, int sub_w,
                           int sub_h, int bgr, const void* consts,
                           void* stream) {
  const Yuv2RgbConsts c = *static_cast<const Yuv2RgbConsts*>(consts);
  int form;
  if (c.rb_form == 0 && c.g_form == 0)
    form = 0;
  else if (c.rb_form == 1 && c.g_form >= 0 && c.g_form <= 2)
    form = 1 + c.g_form;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (sub_w < 0 || sub_w > 2 || sub_h < 0 || sub_h > 2 || w <= 0 || h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = sub_h ? 2 : 1;
  const int runs = (w + kRun - 1) / kRun;
  const int segs = (runs + 31) / 32;
  const int groups = (h + rows - 1) / rows;
  const long blocks =
      (static_cast<long>(groups) * segs + kWarps - 1) / kWarps;
  Kernel k;
  switch (3 * sub_w + (rows - 1)) {
    case 0: k = pick<0, 1>(form); break;
    case 1: k = pick<0, 2>(form); break;
    case 3: k = pick<1, 1>(form); break;
    case 4: k = pick<1, 2>(form); break;
    case 6: k = pick<2, 1>(form); break;
    default: k = pick<2, 2>(form); break;
  }
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  k<<<static_cast<unsigned>(blocks), kThreads, 0,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
      static_cast<const uint8_t*>(v), static_cast<uint8_t*>(out), w, h,
      ys_stride, us_stride, vs_stride, sub_h, runs, segs, groups, bgr, c);
  return static_cast<int>(cudaGetLastError());
}
