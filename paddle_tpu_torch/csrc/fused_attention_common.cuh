// Helpers shared by the fused attention kernels (fused_attention.cu,
// fused_attention_bwd.cu): element conversion, warp reductions, the tile
// layout in shared memory, and the score of one (query, key) pair.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kBlockCols = 64;                     // rows of the tile a block walks
constexpr int kColsPerLane = kBlockCols / 32;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a torch cast does
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row stride (in floats) of a [rows][DP] tile in shared memory: 4 floats of
// padding keep every row 16-byte aligned for float4 reads and put the rows
// that a warp's lanes read at once on different banks.
template <int DP>
__host__ __device__ constexpr int row_stride() { return DP + 4; }

// Stage rows [r0, r0 + rows) of a [S, d] matrix (row stride ss, unit column
// stride) into a [rows][row_stride<DP>()] fp32 tile, zero past S and past d.
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long ss, int r0, int rows,
                                           int s, int d) {
  constexpr int RS = row_stride<DP>();
  for (int i = threadIdx.x; i < rows * DP; i += kThreads) {
    const int r = i / DP, c = i % DP, row = r0 + r;
    float x = 0.f;
    if (row < s && c < d) x = to_float<T>(src[row * ss + c]);
    dst[r * RS + c] = x;
  }
}

// acc[r][t] = sum over c of A[row0 + r][c] * B[lane + 32 t][c], for this
// warp's kRowsPerWarp rows of A against kBlockCols rows of B (both tiles as
// stage_rows leaves them).  Each sum runs over c upward in one fp32 FMA
// chain, so a score recomputed here has the bits the forward kernel had.
template <int DP>
__device__ __forceinline__ void tile_dot(const float* A, int row0, const float* B, int lane,
                                         float acc[kRowsPerWarp][kColsPerLane]) {
  constexpr int RS = row_stride<DP>();
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) acc[r][t] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 bv[kColsPerLane];
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t)
      bv[t] = *reinterpret_cast<const float4*>(&B[(lane + 32 * t) * RS + c]);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(&A[(row0 + r) * RS + c]);
#pragma unroll
      for (int t = 0; t < kColsPerLane; ++t) {
        acc[r][t] = fmaf(av.x, bv[t].x, acc[r][t]);
        acc[r][t] = fmaf(av.y, bv[t].y, acc[r][t]);
        acc[r][t] = fmaf(av.z, bv[t].z, acc[r][t]);
        acc[r][t] = fmaf(av.w, bv[t].w, acc[r][t]);
      }
    }
  }
}

// The score of query qi against key kj from the raw product qk, with the
// terms added in the order of the op's einsum branch: scale, then the causal
// term, then the padding term mterm = (Mask[kj] - 1) * 1e9.
__device__ __forceinline__ float masked_score(float qk, float scale, bool causal, int qi, int kj,
                                              bool has_mask, float mterm) {
  // _rn intrinsics: no contraction into an FMA, so every step rounds as
  // the reference's separate multiply and adds do
  float x = __fmul_rn(qk, scale);
  if (causal) x = __fadd_rn(x, (kj <= qi) ? 0.f : -1e9f);
  if (has_mask) x = __fadd_rn(x, mterm);
  return x;
}

}  // namespace attn
