// Bit-exact `-idct simple` 8x8 inverse DCT for Hopper (sm_90a): kernel K2
// of the port.
//
// Replaces the JAX package's Pallas kernel
// libav_tpu/ops/idct.py:_idct8x8_int_pallas, which laid the batch out
// coefficient-major, (64, B), so that each butterfly step was one
// full-width multiply-add over the TPU's 128 lanes. That layout existed
// for the lanes; here blocks stay in their natural (B, 8, 8) order.
//
// Contract (libav_tpu/ops/idct.py idct8x8_int_ref): (B, 8, 8) int32 in,
// (B, 8, 8) int32 out.
//   x = wrap16(in)
//   row i:  y = wrap16((sum_j x[i][j] * M[k][j] + 2^(row_shift-1))
//                      >> row_shift), or wrap16(x[i][0] << 3) when
//           x[i][1..7] are all zero (the per-row DC-only shortcut)
//   col j:  z[k][j] = (sum_i M[k][i] * y[i][j] + col_bias) >> col_shift
// Both sums wrap in int32 as the reference C does: after the wrap to
// int16 a row sum can reach 8 * 32768 * 22725 > 2^31. Signed overflow is
// undefined in C++, so the sums accumulate in uint32_t (modular) and are
// converted back to int, which nvcc does as two's complement. `>>` on a
// negative int is an arithmetic shift in nvcc, as in torch and numpy.
// M, the shifts and the bias come from the wrapper, built from the JAX
// package's own numbers, so they cannot drift.
//
// What bounds it on the card: bytes. Each block reads and writes 256 B
// with 2 x 8 x 64 multiply-adds, far under the card's ops-per-byte line;
// a 1080-line frame picture (48,960 blocks) moves 25 MB.
//
// Design: 8 threads per 8x8 block, 32 blocks per 256-thread CUDA block.
// Thread r of a block loads row r as two 16-byte vectors (a warp reads
// 4 whole blocks, 1 KB, contiguous), runs the row pass and stores the
// int16-range row into shared memory; after a __syncwarp over its block's
// 8 lanes the same thread runs column r, stores it into shared memory,
// and after a second __syncwarp writes output row r as two 16-byte
// vectors. The 9-int row pitch keeps both shared-memory passes free of
// bank conflicts. A block's 8 lanes sit in one warp and enter or leave
// together, so the ragged last CUDA block needs no barrier across warps.
//
// The second entry point, mpv_idct8x8_cm, is kernel P1: the same function
// in the coefficient-major layout, (64, B) int32, row 8r+c holding
// coefficient (r, c) of every block. It replaces the timing tool's Pallas
// kernel libav_tpu/tools/pallas_probe.py:_build, which used that layout so
// that each butterfly step was one multiply-add over 128 lanes (and so
// needed B % 128 == 0). Here one thread owns one 8x8 block: for each
// coefficient row, neighbouring threads read neighbouring blocks, so
// every load and store of a warp is one 128-byte line. The thread reads
// one row of 8 coefficients at a time and keeps the 64 int16-range row
// results in registers for the column pass (no shared memory); ptxas -v
// reports its registers and spills. Any B >= 1; the last CUDA block is
// masked. Bound, as for K2, by bytes: 512 B per block in and out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlocksPerCta = 32;
constexpr int kThreads = 8 * kBlocksPerCta;
constexpr int kPitch = 9;

struct IdctConsts {
  int m[64];        // M[k][j], row-major
  int row_shift;
  int col_shift;
  int col_bias;
};

__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>((static_cast<uint32_t>(v) + 0x8000u) & 0xFFFFu) -
         0x8000;
}

__global__ void __launch_bounds__(kThreads)
    idct8x8_kernel(const int4* __restrict__ in, int4* __restrict__ out,
                   int n, const IdctConsts c) {
  __shared__ int s[kBlocksPerCta * 8 * kPitch];
  const int lane_blk = threadIdx.x >> 3;          // block within the CTA
  const int r = threadIdx.x & 7;                  // row, then column
  const long blk = static_cast<long>(blockIdx.x) * kBlocksPerCta + lane_blk;
  if (blk >= n) return;                           // whole 8-lane groups
  const unsigned group = 0xFFu << (threadIdx.x & 24);
  int* sb = s + lane_blk * 8 * kPitch;

  const int4 a = in[blk * 16 + 2 * r];
  const int4 b = in[blk * 16 + 2 * r + 1];
  const int x[8] = {wrap16(a.x), wrap16(a.y), wrap16(a.z), wrap16(a.w),
                    wrap16(b.x), wrap16(b.y), wrap16(b.z), wrap16(b.w)};
  const bool dc_only = (x[1] | x[2] | x[3] | x[4] | x[5] | x[6] | x[7]) == 0;
  // x0 << 3 through uint32_t: a left shift of a negative int is undefined
  const int dc_row =
      wrap16(static_cast<int>(static_cast<uint32_t>(x[0]) << 3));
  const uint32_t row_round = 1u << (c.row_shift - 1);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t acc = row_round;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc += static_cast<uint32_t>(x[j]) *
             static_cast<uint32_t>(c.m[k * 8 + j]);
    const int y = static_cast<int>(acc) >> c.row_shift;
    sb[r * kPitch + k] = wrap16(dc_only ? dc_row : y);
  }
  __syncwarp(group);

  int y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = sb[i * kPitch + r];
  __syncwarp(group);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t acc = static_cast<uint32_t>(c.col_bias);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc += static_cast<uint32_t>(c.m[k * 8 + i]) *
             static_cast<uint32_t>(y[i]);
    sb[k * kPitch + r] = static_cast<int>(acc) >> c.col_shift;
  }
  __syncwarp(group);

  const int* row = sb + r * kPitch;
  out[blk * 16 + 2 * r] = make_int4(row[0], row[1], row[2], row[3]);
  out[blk * 16 + 2 * r + 1] = make_int4(row[4], row[5], row[6], row[7]);
}

constexpr int kCmThreads = 128;

__global__ void __launch_bounds__(kCmThreads)
    idct8x8_cm_kernel(const int* __restrict__ in, int* __restrict__ out,
                      int n, const IdctConsts c) {
  const long blk = static_cast<long>(blockIdx.x) * kCmThreads + threadIdx.x;
  if (blk >= n) return;
  const int* src = in + blk;
  int* dst = out + blk;
  const long stride = n;                          // one coefficient row
  const uint32_t row_round = 1u << (c.row_shift - 1);
  int y[64];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = wrap16(src[(8 * r + j) * stride]);
    const bool dc_only =
        (x[1] | x[2] | x[3] | x[4] | x[5] | x[6] | x[7]) == 0;
    const int dc_row =
        wrap16(static_cast<int>(static_cast<uint32_t>(x[0]) << 3));
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t acc = row_round;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc += static_cast<uint32_t>(x[j]) *
               static_cast<uint32_t>(c.m[k * 8 + j]);
      y[8 * r + k] =
          wrap16(dc_only ? dc_row : static_cast<int>(acc) >> c.row_shift);
    }
  }
#pragma unroll
  for (int col = 0; col < 8; ++col) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t acc = static_cast<uint32_t>(c.col_bias);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc += static_cast<uint32_t>(c.m[k * 8 + i]) *
               static_cast<uint32_t>(y[8 * i + col]);
      dst[(8 * k + col) * stride] = static_cast<int>(acc) >> c.col_shift;
    }
  }
}

IdctConsts unpack(const int* consts) {
  IdctConsts c;
  for (int i = 0; i < 64; ++i) c.m[i] = consts[i];
  c.row_shift = consts[64];
  c.col_shift = consts[65];
  c.col_bias = consts[66];
  return c;
}

}  // namespace

extern "C" {

// consts: host array [M (64, row-major) | row_shift | col_shift | col_bias].
// Returns cudaGetLastError() after the launch (0 = launched).
int mpv_idct8x8(const int* in, int* out, int n, const int* consts,
                cudaStream_t stream) {
  const int ctas = (n + kBlocksPerCta - 1) / kBlocksPerCta;
  idct8x8_kernel<<<ctas, kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(in), reinterpret_cast<int4*>(out), n,
      unpack(consts));
  return static_cast<int>(cudaGetLastError());
}

// P1: in and out are (64, n) int32, coefficient-major.
int mpv_idct8x8_cm(const int* in, int* out, int n, const int* consts,
                   cudaStream_t stream) {
  idct8x8_cm_kernel<<<(n + kCmThreads - 1) / kCmThreads, kCmThreads, 0,
                      stream>>>(in, out, n, unpack(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
