// Helpers of the fused attention kernels (fused_attention.cu,
// fused_attention_bwd.cu): a float converted to the tiles' element type,
// and the score of one (query, key) pair.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a torch cast does
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
