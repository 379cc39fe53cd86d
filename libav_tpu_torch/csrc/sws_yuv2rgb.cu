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
// Where XLA rounds. The optimised HLO of _yuv_rgb_jit is one loop
// fusion of converts, adds and multiplies; the multiply-adds are
// contracted to FMAs by the CPU backend's code generator, not in the
// HLO, so the order is read from its object code (XLA_FLAGS=
// --xla_dump_to=DIR, jax 0.9.0, the fusion's .o disassembled) and
// checked on its outputs at 1920x1080 for 4:2:0, 4:2:2 and 4:4:4 in
// both ranges. With ys = y - oy, c = u - 128 or v - 128, all exact:
//   rb_form 0 (limited range): r = fma(ys, ky, kru*v),  b likewise
//   rb_form 1 (full range):    r = fma(kru, v, ys*ky),  b likewise
//   g_form 0: g = fma(ys, ky, kgu*u) + kgv*v
//   g_form 1 (full range 4:4:4): g = fma(kgv, v, fma(kgu, u, ys*ky))
// where every product and sum not inside an fma is rounded to float32.
// XLA picks its contractions per shape (which products its unrolled
// loop shares between pixels); the wrapper passes the forms and the
// float32 constants, and the plain version beside it
// (libav_tpu_torch/swscale/yuv2rgb.py) computes the same steps.
//
// What bounds it on the card: bytes. Per pixel it reads 1 + 2/k chroma
// bytes (k = 4, 2 or 1 pixels per chroma sample) and writes 3, with ~12
// float operations, far under the card's operations-per-byte line. At
// 1920x1080 4:2:0 that is 3,110,400 bytes in and 6,220,800 out.
//
// Design: one launch per frame, one thread per output pixel, a CUDA
// block of 256 threads along a row (grid: ceil(W / 256) x H). Neighbour
// threads read neighbour luma bytes and write neighbour 3-byte pixels,
// so a warp reads 32 contiguous bytes and writes 96. Rows and chroma
// rows are addressed through the planes' strides, so a cropped view
// needs no copy. A faster design (several pixels per thread, 16-byte
// stores) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Yuv2RgbConsts {
  float ky, oy, kru, kgu, kgv, kbv;
  int rb_form;   // 0: fma(ys, ky, k*c); 1: fma(k, c, ys*ky)
  int g_form;    // 0: fma(ys, ky, kgu*u) + kgv*v; 1: fma(kgv, v, fma(kgu, u, ys*ky))
};

__device__ __forceinline__ uint8_t to_u8(float x) {
  // round half to even, then clip; x is finite
  float r = rintf(x);
  r = fminf(fmaxf(r, 0.0f), 255.0f);
  return static_cast<uint8_t>(r);
}

__global__ void __launch_bounds__(256)
    yuv2rgb_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
                   const uint8_t* __restrict__ v, uint8_t* __restrict__ out,
                   int w, int h, long ys_stride, long us_stride,
                   long vs_stride, int sub_w, int sub_h, int bgr,
                   const Yuv2RgbConsts c) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (x >= w || row >= h) return;
  const int cx = x >> sub_w, cy = row >> sub_h;
  const float ys = __fadd_rn(static_cast<float>(y[row * ys_stride + x]), -c.oy);
  const float uc = __fadd_rn(static_cast<float>(u[cy * us_stride + cx]), -128.0f);
  const float vc = __fadd_rn(static_cast<float>(v[cy * vs_stride + cx]), -128.0f);
  const float yf = __fmul_rn(ys, c.ky);
  float r, g, b;
  if (c.rb_form == 0) {
    r = __fmaf_rn(ys, c.ky, __fmul_rn(c.kru, vc));
    b = __fmaf_rn(ys, c.ky, __fmul_rn(c.kbv, uc));
  } else {
    r = __fmaf_rn(c.kru, vc, yf);
    b = __fmaf_rn(c.kbv, uc, yf);
  }
  if (c.g_form == 0) {
    g = __fadd_rn(__fmaf_rn(ys, c.ky, __fmul_rn(c.kgu, uc)),
                  __fmul_rn(c.kgv, vc));
  } else {
    g = __fmaf_rn(c.kgv, vc, __fmaf_rn(c.kgu, uc, yf));
  }
  uint8_t* o = out + static_cast<long>(row) * 3 * w + 3L * x;
  o[bgr ? 2 : 0] = to_u8(r);
  o[1] = to_u8(g);
  o[bgr ? 0 : 2] = to_u8(b);
}

}  // namespace

extern "C" int sws_yuv2rgb(const void* y, const void* u, const void* v,
                           void* out, int w, int h, long ys_stride,
                           long us_stride, long vs_stride, int sub_w,
                           int sub_h, int bgr, const void* consts,
                           void* stream) {
  const Yuv2RgbConsts c = *static_cast<const Yuv2RgbConsts*>(consts);
  dim3 grid((w + 255) / 256, h);
  yuv2rgb_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
      static_cast<const uint8_t*>(v), static_cast<uint8_t*>(out), w, h,
      ys_stride, us_stride, vs_stride, sub_w, sub_h, bgr, c);
  return static_cast<int>(cudaGetLastError());
}
