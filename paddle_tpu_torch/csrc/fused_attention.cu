// Fused scaled-dot-product attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel behind the JAX package's `fused_attention` op
// (its ops/nn_ops.py:694-708, flash branch): jax's Pallas
// flash_attention forward, `_flash_attention_impl`, whose pallas_call is
// at jax/experimental/pallas/ops/tpu/flash_attention.py:758 (jax 0.9.0).
//
// What it computes, for Q, K, V of shape [N, H, S, D] (fp32 or bf16):
//   s   = (Q K^T) * scale                       (fp32)
//   s  += causal ? (j <= i ? 0 : -1e9) : 0      (fp32, added first)
//   s  += (Mask[n, j] - 1) * 1e9                (fp32, when Mask is given)
//   Out = softmax(s) V                          (written in Q's dtype)
//   Stats = [m, log l]                          (fp32 [2, N, H, S], only
//                                                when the caller asks for it)
// where m is the row max of s and l = sum_j exp(s_j - m).  The backward
// kernels (fused_attention_bwd.cu) rebuild the probabilities from them as
// P = exp((s - m) - log l).  The two stay apart: their sum, the row's
// log-sum-exp, rounds back to m on a row whose every key is masked
// (every score -1e9, where one fp32 ulp is 64), and exp(s - lse) would
// then give each key 1 where the softmax gives 1/S.  The serving path
// does not ask for the statistics and does not pay for them.
// These are the mask semantics of the op's einsum branch (the JAX
// package's ops/nn_ops.py:709-717), which that package runs on the CPU,
// so every row compares with that reference, pad query rows included.
// The TPU flash branch lowers Mask to segment ids instead; it differs from
// this only on pad query rows, whose outputs are garbage by construction
// in both (nn_ops.py:649-651) and are masked downstream.
//
// Design, simple and right first:
//  * One block per (n, h, tile of kBlockQ query rows).  The TPU grid walked
//    the K/V tiles as a sequential grid dimension and carried the softmax
//    state in VMEM scratch; here a loop inside the block walks the K/V
//    tiles, staged in shared memory, and each row's running max, running
//    denominator and output accumulator stay in fp32 registers (online
//    softmax), so no [N, H, S, S] tensor ever reaches device memory.
//  * Each warp owns kRowsPerWarp query rows.  For Q K^T a lane owns
//    kKeysPerLane keys of the tile and all of the warp's rows; for P V a
//    lane owns DP / 32 output columns.  Probabilities go through a small
//    per-warp shared buffer between the two products.
//  * Products are fp32 FMAs on the CUDA cores, for both input types: bf16
//    inputs are widened to fp32 when staged.  fp32 inputs therefore keep
//    full fp32 products (a TF32 or bf16 tensor-core product would not meet
//    the 1e-4 fp32 tolerance).  wgmma, TMA and warp specialisation for the
//    bf16 path are later work.
//  * Ragged edges are masked: any S (keys past S score -inf, query rows
//    past S are not written) and any D <= 128 (head dim zero-padded to DP,
//    one of 32, 64, 128).  Q, K, V and Out are addressed through their
//    (n, h, s) strides with a unit last stride, so the [N, S, H, D] views
//    the model's head split produces are read in place.
//
// What bounds it on an H100 SXM (reckoned from shapes; PERF.md holds the
// measured times): at N=16, H=12, S=128, D=64 the two products are
// 4*N*H*S*S*D = 805 MFLOP.  fp32 moves 25.2 MB (Q, K, V, Out; the mask is
// 8 KB): 805 MFLOP / 67 TFLOP/s = 12.0 us against 25.2 MB / 3.35 TB/s =
// 7.5 us, so compute bounds it.  bf16 moves 12.6 MB = 3.8 us; its products
// on the tensor cores would take 0.8 us, so memory bounds bf16 - a bound
// this CUDA-core kernel does not reach, since it runs bf16 at the fp32
// rate.

#include <stdint.h>

#include "fused_attention_common.cuh"

namespace {

using namespace attn;

constexpr int kBlockQ = kBlockRows;  // query rows per block
constexpr int kBlockK = kBlockCols;  // keys per K/V tile
constexpr int kKeysPerLane = kColsPerLane;  // keys of a tile a lane scores

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // [N, Sk] fp32 with row stride mask_sn, or null
  void* out;
  float* stats;       // [2, N, H, Sq] fp32, contiguous (row max, log row sum), or null
  int sq, sk, d;
  long long q_sn, q_sh, q_ss;
  long long k_sn, k_sh, k_ss;
  long long v_sn, v_sh, v_ss;
  long long o_sn, o_sh, o_ss;
  long long mask_sn;
  int causal;
  float scale;
};

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBlockQ) * row_stride<DP>() + size_t(kBlockK) * row_stride<DP>() +
                          size_t(kBlockK) * DP + size_t(kWarps) * kRowsPerWarp * kBlockK);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) fused_attention_fwd_kernel(const Params p) {
  constexpr int QS = row_stride<DP>();
  constexpr int kDimsPerLane = DP / 32;  // output columns a lane owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBlockQ][QS]
  float* Ks = Qs + kBlockQ * QS;                // [kBlockK][QS]
  float* Vs = Ks + kBlockK * QS;                // [kBlockK][DP]
  float* Ps = Vs + kBlockK * DP;                // [kWarps][kRowsPerWarp][kBlockK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long n = blockIdx.z;
  const long long h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;

  const T* qg = static_cast<const T*>(p.q) + n * p.q_sn + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + n * p.k_sn + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + n * p.v_sn + h * p.v_sh;
  T* og = static_cast<T*>(p.out) + n * p.o_sn + h * p.o_sh;
  const float* mrow = p.mask != nullptr ? p.mask + n * p.mask_sn : nullptr;

  // Stage this block's query rows, zero past S and past D.
  stage_rows<T, DP>(Qs, qg, p.q_ss, q0, kBlockQ, p.sq, p.d);

  const int row0 = warp * kRowsPerWarp;
  float* Pw = Ps + warp * kRowsPerWarp * kBlockK;
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.sk; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int i = tid; i < kBlockK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP, kj = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < p.sk && c < p.d) {
        kx = to_float<T>(kg[kj * p.k_ss + c]);
        vx = to_float<T>(vg[kj * p.v_ss + c]);
      }
      Ks[r * QS + c] = kx;
      Vs[r * DP + c] = vx;
    }
    __syncthreads();

    // s[r][t]: this warp's row r against this lane's key t of the tile.
    float s[kRowsPerWarp][kKeysPerLane];
    tile_dot<DP>(Qs, row0, Ks, lane, s);

    // Scale, then the causal and padding terms in the reference's order;
    // keys past S drop out of the softmax entirely.
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int kj = k0 + lane + 32 * t;
      const bool valid = kj < p.sk;
      const float mterm = (mrow != nullptr && valid) ? (mrow[kj] - 1.0f) * 1e9f : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float x = masked_score(s[r][t], p.scale, p.causal, q0 + row0 + r, kj,
                                     mrow != nullptr, mterm);
        s[r][t] = valid ? x : -INFINITY;
      }
    }

    // Online softmax: fold this tile into each row's running max and sum,
    // rescale the accumulator, and hand the tile's probabilities to P V.
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int t = 1; t < kKeysPerLane; ++t) mx = fmaxf(mx, s[r][t]);
      const float m_new = fmaxf(m_run[r], warp_max(mx));  // finite: key k0 is valid
      const float corr = expf(m_run[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) {
        const float pv = expf(s[r][t] - m_new);
        psum += pv;
        Pw[r * kBlockK + lane + 32 * t] = pv;
      }
      l_run[r] = l_run[r] * corr + warp_sum(psum);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float4 pr[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        pr[r] = *reinterpret_cast<const float4*>(&Pw[r * kBlockK + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[kDimsPerLane];
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) vv[c] = Vs[(j + jj) * DP + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
#pragma unroll
          for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
        }
      }
    }
    __syncwarp();  // Pw is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= p.sq) continue;
    if (p.stats != nullptr && lane == 0) {
      const long long at = (n * gridDim.y + h) * p.sq + qi;
      p.stats[at] = m_run[r];
      p.stats[at + (long long)gridDim.z * gridDim.y * p.sq] = logf(l_run[r]);
    }
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < p.d) og[qi * p.o_ss + d] = from_float<T>(acc[r][c] / l_run[r]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, int n, int h, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(fused_attention_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, h, n);
  fused_attention_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const Params& p, int n, int h, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32>(p, n, h, stream);
  if (p.d <= 64) return launch<T, 64>(p, n, h, stream);
  return launch<T, 128>(p, n, h, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  stats may be null.  Returns a cudaError_t (0 on success):
// the launch's own error, read with cudaGetLastError right after it.
extern "C" int paddle_fused_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* out, void* stats, int dtype, int n,
    int h, int sq, int sk, int d, long long q_sn, long long q_sh, long long q_ss, long long k_sn,
    long long k_sh, long long k_ss, long long v_sn, long long v_sh, long long v_ss, long long o_sn,
    long long o_sh, long long o_ss, long long mask_sn, int causal, float scale, void* stream) {
  if (n < 1 || h < 1 || sq < 1 || sk < 1 || d < 1 || d > 128 || n > 65535 || h > 65535)
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const float*>(mask);
  p.out = out;
  p.stats = static_cast<float*>(stats);
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.q_sn = q_sn;
  p.q_sh = q_sh;
  p.q_ss = q_ss;
  p.k_sn = k_sn;
  p.k_sh = k_sh;
  p.k_ss = k_ss;
  p.v_sn = v_sn;
  p.v_sh = v_sh;
  p.v_ss = v_ss;
  p.o_sn = o_sn;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.mask_sn = mask_sn;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dim<float>(p, n, h, s);
  else if (dtype == 1)
    err = dispatch_dim<__nv_bfloat16>(p, n, h, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
