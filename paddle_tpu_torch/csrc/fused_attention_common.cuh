// Helpers of the fused attention kernels (fused_attention.cu,
// fused_attention_bwd.cu): a float converted to the tiles' element type,
// the score of one (query, key) pair, and the once-only raise of a
// kernel's shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

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

// Raises one kernel's dynamic shared-memory limit, once a device, at the
// kernel's first launch there.  cudaFuncSetAttribute is a host-side call, not
// a stream operation: the executor captures a step into a CUDA graph only
// after running it once, so every later launch, captured or not, is the
// launch alone.  One object a kernel instantiation (a function-local static
// in its launcher); devices 0 to 63.
class SmemLimit {
 public:
  template <typename Kernel>
  cudaError_t raise_once(Kernel* kernel, int smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    if ((done_ >> dev) & 1) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) done_ |= uint64_t{1} << dev;
    return err;
  }

 private:
  std::mutex mu_;
  uint64_t done_ = 0;
};

}  // namespace attn
