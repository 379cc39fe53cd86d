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

}  // namespace

extern "C" {

// consts: host array [M (64, row-major) | row_shift | col_shift | col_bias].
// Returns cudaGetLastError() after the launch (0 = launched).
int mpv_idct8x8(const int* in, int* out, int n, const int* consts,
                cudaStream_t stream) {
  IdctConsts c;
  for (int i = 0; i < 64; ++i) c.m[i] = consts[i];
  c.row_shift = consts[64];
  c.col_shift = consts[65];
  c.col_bias = consts[66];
  const int ctas = (n + kBlocksPerCta - 1) / kBlocksPerCta;
  idct8x8_kernel<<<ctas, kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(in), reinterpret_cast<int4*>(out), n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
