// Fused scaled-dot-product attention, backward, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of the backward of jax's Pallas
// flash_attention (jax 0.9.0, jax/experimental/pallas/ops/tpu/
// flash_attention.py), which the JAX package's `fused_attention_grad`
// reaches through its generic vjp grad (core/registry.py:131):
//   * `_flash_attention_bwd_dkv` (:941, pallas_call at :1121): dK and dV,
//     here `fused_attention_bwd_dkv_kernel`;
//   * `_flash_attention_bwd_dq` (:1287, pallas_call at :1456): dQ, here
//     `fused_attention_bwd_dq_kernel`.
//
// What they compute, for Q, K, V, dO of shape [N, H, S, D] (fp32 or bf16),
// the row log-sum-exp LSE that the forward kernel writes (fp32 [N, H, Sq])
// and Di = rowsum(O * dO) (fp32 [N, H, Sq], a torch reduction beside the
// launch, as XLA computed it beside the TPU kernels):
//   s   = (Q K^T) * scale + causal + padding   (fp32, the forward's order:
//                                               attn::masked_score)
//   P   = exp(s - LSE)
//   dV  = P^T dO
//   dP  = dO V^T
//   dS  = P * (dP - Di)
//   dQ  = scale * dS K
//   dK  = scale * dS^T Q                        (all written in Q's dtype)
// This is the vjp of the op's einsum branch (the JAX package's
// ops/nn_ops.py:709-717), with no gradient to Mask.  The raw products Q K^T
// run through attn::tile_dot, the forward kernel's own FMA chain, so the
// recomputed scores carry the forward's bits: near -1e9 one fp32 ulp is 64,
// and any other order of additions would move P on rows with masked keys.
// Pad query rows get real gradients (they attend the real keys, and later
// layers send gradient back through them), so every row and every tile is
// processed; nothing is skipped.
//
// Design, simple and right first, split as the TPU split it:
//  * dK/dV: one block per (n, h, tile of kBlockRows keys).  A loop inside the
//    block walks the query tiles (the TPU's sequential grid dimension);
//    each warp owns kRowsPerWarp keys and keeps their dK and dV rows in
//    fp32 registers across the walk.  For P^T and dP^T a lane owns
//    kColsPerLane queries of the tile; P^T and dS^T go through small
//    per-warp shared buffers to the two products that accumulate into the
//    key rows, where a lane owns DP / 32 columns.
//  * dQ: one block per (n, h, tile of kBlockRows queries), walking the K/V
//    tiles; each warp owns kRowsPerWarp query rows and their dQ rows.
//  * No atomics: every output element is summed by one thread in a fixed
//    order, so results repeat bit for bit from run to run.
//  * Products are fp32 FMAs on the CUDA cores for both input types, as in
//    the forward kernel.  wgmma, TMA and fusing the two kernels are later
//    work.
//  * Ragged edges are masked: keys or queries past S give P = 0 and are not
//    written; the head dim is zero-padded to DP (32, 64 or 128).  Q, K, V,
//    dO, dQ, dK and dV are addressed through their (n, h, s) strides with a
//    unit last stride, so the [N, S, H, D] views of the head split are read
//    and written in place.
//
// What bounds them on an H100 SXM (reckoned from shapes; PERF.md holds the
// measured times), at the training shape N=32, H=12, S=128, D=64, fp32:
//  * dK/dV: four products (Q K^T, dO V^T, P^T dO, dS^T Q), 8*N*H*S*S*D =
//    3.22 GFLOP, 48.1 us at 67 TFLOP/s; it reads Q, K, V, dO and writes dK,
//    dV (75.5 MB, plus LSE and Di), 22.5 us at 3.35 TB/s.  Compute bounds it.
//  * dQ: three products (Q K^T, dO V^T, dS K), 2.42 GFLOP, 36.1 us; it reads
//    Q, K, V, dO and writes dQ (62.9 MB), 18.8 us.  Compute bounds it.
// The split recomputes Q K^T and dO V^T in both kernels; a fused backward
// needs five products, 4.03 GFLOP, 60.1 us for the pair against the
// split's 84.1 us.

#include <stdint.h>

#include "fused_attention_common.cuh"

namespace {

using namespace attn;

constexpr int kTile = kBlockCols;  // rows of the walked tile (queries or keys)

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // [N, Sk] fp32 with row stride mask_sn, or null
  const void* dout;
  const float* lse;   // [N, H, Sq] fp32, contiguous
  const float* di;    // [N, H, Sq] fp32, contiguous
  void* dq;
  void* dk;
  void* dv;
  int sq, sk, d;
  long long q_sn, q_sh, q_ss;
  long long k_sn, k_sh, k_ss;
  long long v_sn, v_sh, v_ss;
  long long do_sn, do_sh, do_ss;
  long long dq_sn, dq_sh, dq_ss;
  long long dk_sn, dk_sh, dk_ss;
  long long dv_sn, dv_sh, dv_ss;
  long long mask_sn;
  int causal;
  float scale;
};

// Shared memory: two [kBlockRows] tiles of the rows a block owns, two
// [kTile] tiles of the rows it walks, `bufs` per-warp [kRowsPerWarp][kTile]
// buffers, and two [kTile] vectors (LSE and Di of the walked queries).
template <int DP>
constexpr size_t smem_bytes(int bufs) {
  return sizeof(float) * (size_t(2) * (kBlockRows + kTile) * row_stride<DP>() +
                          size_t(bufs) * kWarps * kRowsPerWarp * kTile + 2 * kTile);
}

// ---------------------------------------------------------------------------
// dK, dV: rows are keys, the walked tiles are queries.
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) fused_attention_bwd_dkv_kernel(const BwdParams p) {
  constexpr int RS = row_stride<DP>();
  constexpr int kDimsPerLane = DP / 32;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kBlockRows][RS]
  float* Vs = Ks + kBlockRows * RS;             // [kBlockRows][RS]
  float* Qs = Vs + kBlockRows * RS;             // [kTile][RS]
  float* dOs = Qs + kTile * RS;                 // [kTile][RS]
  float* Pb = dOs + kTile * RS;                 // [kWarps][kRowsPerWarp][kTile]
  float* dSb = Pb + kWarps * kRowsPerWarp * kTile;
  float* lse_s = dSb + kWarps * kRowsPerWarp * kTile;  // [kTile]
  float* di_s = lse_s + kTile;                          // [kTile]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long n = blockIdx.z;
  const long long h = blockIdx.y;
  const int k0 = blockIdx.x * kBlockRows;
  const int row0 = warp * kRowsPerWarp;

  const T* qg = static_cast<const T*>(p.q) + n * p.q_sn + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + n * p.k_sn + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + n * p.v_sn + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + n * p.do_sn + h * p.do_sh;
  const float* lse_g = p.lse + (n * gridDim.y + h) * p.sq;
  const float* di_g = p.di + (n * gridDim.y + h) * p.sq;
  const float* mrow = p.mask != nullptr ? p.mask + n * p.mask_sn : nullptr;

  stage_rows<T, DP>(Ks, kg, p.k_ss, k0, kBlockRows, p.sk, p.d);
  stage_rows<T, DP>(Vs, vg, p.v_ss, k0, kBlockRows, p.sk, p.d);

  // this warp's keys: validity and padding term, fixed for the whole walk
  bool kvalid[kRowsPerWarp];
  float mterm[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int kj = k0 + row0 + r;
    kvalid[r] = kj < p.sk;
    mterm[r] = (mrow != nullptr && kvalid[r]) ? (mrow[kj] - 1.0f) * 1e9f : 0.f;
  }

  float* Pw = Pb + warp * kRowsPerWarp * kTile;
  float* dSw = dSb + warp * kRowsPerWarp * kTile;
  float dk_acc[kRowsPerWarp][kDimsPerLane], dv_acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int q0 = 0; q0 < p.sq; q0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    stage_rows<T, DP>(Qs, qg, p.q_ss, q0, kTile, p.sq, p.d);
    stage_rows<T, DP>(dOs, dog, p.do_ss, q0, kTile, p.sq, p.d);
    for (int i = tid; i < kTile; i += kThreads) {
      const int qi = q0 + i;
      lse_s[i] = qi < p.sq ? lse_g[qi] : 0.f;
      di_s[i] = qi < p.sq ? di_g[qi] : 0.f;
    }
    __syncthreads();

    // sT[r][t] = K[key r] . Q[query t];  dpT[r][t] = V[key r] . dO[query t]
    float sT[kRowsPerWarp][kColsPerLane], dpT[kRowsPerWarp][kColsPerLane];
    tile_dot<DP>(Ks, row0, Qs, lane, sT);
    tile_dot<DP>(Vs, row0, dOs, lane, dpT);
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      const int col = lane + 32 * t;
      const int qi = q0 + col;
      const bool qvalid = qi < p.sq;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float x = masked_score(sT[r][t], p.scale, p.causal, qi, k0 + row0 + r,
                                     mrow != nullptr, mterm[r]);
        const float pv = (qvalid && kvalid[r]) ? expf(x - lse_s[col]) : 0.f;
        Pw[r * kTile + col] = pv;
        dSw[r * kTile + col] = pv * (dpT[r][t] - di_s[col]);
      }
    }
    __syncwarp();

    // dV[r] += sum_t P^T[r][t] dO[t];  dK[r] += sum_t dS^T[r][t] Q[t]
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 pr[kRowsPerWarp], sr[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        pr[r] = *reinterpret_cast<const float4*>(&Pw[r * kTile + j]);
        sr[r] = *reinterpret_cast<const float4*>(&dSw[r * kTile + j]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float dov[kDimsPerLane], qv[kDimsPerLane];
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) {
          dov[c] = dOs[(j + jj) * RS + lane + 32 * c];
          qv[c] = Qs[(j + jj) * RS + lane + 32 * c];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
          const float sj = jj == 0 ? sr[r].x : jj == 1 ? sr[r].y : jj == 2 ? sr[r].z : sr[r].w;
#pragma unroll
          for (int c = 0; c < kDimsPerLane; ++c) {
            dv_acc[r][c] = fmaf(pj, dov[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(sj, qv[c], dk_acc[r][c]);
          }
        }
      }
    }
    __syncwarp();  // Pw and dSw are rewritten by the next tile
  }

  T* dkg = static_cast<T*>(p.dk) + n * p.dk_sn + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + n * p.dv_sn + h * p.dv_sh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int kj = k0 + row0 + r;
    if (!kvalid[r]) continue;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < p.d) {
        dkg[kj * p.dk_ss + d] = from_float<T>(dk_acc[r][c] * p.scale);
        dvg[kj * p.dv_ss + d] = from_float<T>(dv_acc[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: rows are queries, the walked tiles are keys.
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) fused_attention_bwd_dq_kernel(const BwdParams p) {
  constexpr int RS = row_stride<DP>();
  constexpr int kDimsPerLane = DP / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBlockRows][RS]
  float* dOs = Qs + kBlockRows * RS;            // [kBlockRows][RS]
  float* Ks = dOs + kBlockRows * RS;            // [kTile][RS]
  float* Vs = Ks + kTile * RS;                  // [kTile][RS]
  float* dSb = Vs + kTile * RS;                 // [kWarps][kRowsPerWarp][kTile]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long n = blockIdx.z;
  const long long h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockRows;
  const int row0 = warp * kRowsPerWarp;

  const T* qg = static_cast<const T*>(p.q) + n * p.q_sn + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + n * p.k_sn + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + n * p.v_sn + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + n * p.do_sn + h * p.do_sh;
  const float* lse_g = p.lse + (n * gridDim.y + h) * p.sq;
  const float* di_g = p.di + (n * gridDim.y + h) * p.sq;
  const float* mrow = p.mask != nullptr ? p.mask + n * p.mask_sn : nullptr;

  stage_rows<T, DP>(Qs, qg, p.q_ss, q0, kBlockRows, p.sq, p.d);
  stage_rows<T, DP>(dOs, dog, p.do_ss, q0, kBlockRows, p.sq, p.d);

  // this warp's queries: LSE and Di, fixed for the whole walk
  float lse_r[kRowsPerWarp], di_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    lse_r[r] = qi < p.sq ? lse_g[qi] : 0.f;
    di_r[r] = qi < p.sq ? di_g[qi] : 0.f;
  }

  float* dSw = dSb + warp * kRowsPerWarp * kTile;
  float dq_acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) dq_acc[r][c] = 0.f;

  for (int k0 = 0; k0 < p.sk; k0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    stage_rows<T, DP>(Ks, kg, p.k_ss, k0, kTile, p.sk, p.d);
    stage_rows<T, DP>(Vs, vg, p.v_ss, k0, kTile, p.sk, p.d);
    __syncthreads();

    // s[r][t] = Q[query r] . K[key t];  dp[r][t] = dO[query r] . V[key t]
    float s[kRowsPerWarp][kColsPerLane], dp[kRowsPerWarp][kColsPerLane];
    tile_dot<DP>(Qs, row0, Ks, lane, s);
    tile_dot<DP>(dOs, row0, Vs, lane, dp);
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      const int col = lane + 32 * t;
      const int kj = k0 + col;
      const bool kvalid = kj < p.sk;
      const float mterm = (mrow != nullptr && kvalid) ? (mrow[kj] - 1.0f) * 1e9f : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int qi = q0 + row0 + r;
        const float x = masked_score(s[r][t], p.scale, p.causal, qi, kj, mrow != nullptr, mterm);
        const float pv = (kvalid && qi < p.sq) ? expf(x - lse_r[r]) : 0.f;
        dSw[r * kTile + col] = pv * (dp[r][t] - di_r[r]);
      }
    }
    __syncwarp();

    // dQ[r] += sum_j dS[r][j] K[j]
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 sr[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        sr[r] = *reinterpret_cast<const float4*>(&dSw[r * kTile + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kv[kDimsPerLane];
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) kv[c] = Ks[(j + jj) * RS + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float sj = jj == 0 ? sr[r].x : jj == 1 ? sr[r].y : jj == 2 ? sr[r].z : sr[r].w;
#pragma unroll
          for (int c = 0; c < kDimsPerLane; ++c) dq_acc[r][c] = fmaf(sj, kv[c], dq_acc[r][c]);
        }
      }
    }
    __syncwarp();  // dSw is rewritten by the next tile
  }

  T* dqg = static_cast<T*>(p.dq) + n * p.dq_sn + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < p.d) dqg[qi * p.dq_ss + d] = from_float<T>(dq_acc[r][c] * p.scale);
    }
  }
}

// which: 0 = dK/dV, 1 = dQ
template <typename T, int DP>
cudaError_t launch(const BwdParams& p, int n, int h, int which, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>(which == 0 ? 2 : 1);
  const int rows = which == 0 ? p.sk : p.sq;
  const dim3 grid((rows + kBlockRows - 1) / kBlockRows, h, n);
  cudaError_t err;
  if (which == 0) {
    err = cudaFuncSetAttribute(fused_attention_bwd_dkv_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    fused_attention_bwd_dkv_kernel<T, DP><<<grid, kThreads, smem, stream>>>(p);
  } else {
    err = cudaFuncSetAttribute(fused_attention_bwd_dq_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    fused_attention_bwd_dq_kernel<T, DP><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const BwdParams& p, int n, int h, int which, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32>(p, n, h, which, stream);
  if (p.d <= 64) return launch<T, 64>(p, n, h, which, stream);
  return launch<T, 128>(p, n, h, which, stream);
}

int run(int which, const void* q, const void* k, const void* v, const void* mask, const void* dout,
        const void* lse, const void* di, void* dq, void* dk, void* dv, int dtype, int n, int h,
        int sq, int sk, int d, const long long* strides, long long mask_sn, int causal,
        float scale, void* stream) {
  if (n < 1 || h < 1 || sq < 1 || sk < 1 || d < 1 || d > 128 || n > 65535 || h > 65535)
    return int(cudaErrorInvalidValue);
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const float*>(mask);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  long long* dst[21] = {&p.q_sn,  &p.q_sh,  &p.q_ss,  &p.k_sn,  &p.k_sh,  &p.k_ss,  &p.v_sn,
                        &p.v_sh,  &p.v_ss,  &p.do_sn, &p.do_sh, &p.do_ss, &p.dq_sn, &p.dq_sh,
                        &p.dq_ss, &p.dk_sn, &p.dk_sh, &p.dk_ss, &p.dv_sn, &p.dv_sh, &p.dv_ss};
  for (int i = 0; i < 21; ++i) *dst[i] = strides[i];
  p.mask_sn = mask_sn;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dim<float>(p, n, h, which, s);
  else if (dtype == 1)
    err = dispatch_dim<__nv_bfloat16>(p, n, h, which, s);
  else
    err = cudaErrorInvalidValue;
  return int(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 21 (n, h, s) element strides,
// in the order q, k, v, dout, dq, dk, dv.  lse and di: fp32 [N, H, Sq],
// contiguous.  The dK/dV entry writes dk and dv (dq may be null); the dQ
// entry writes dq (dk and dv may be null).  Each returns a cudaError_t (0 on
// success): the launch's own error, read with cudaGetLastError right after.
extern "C" int paddle_fused_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* di, void* dq, void* dk, void* dv, int dtype, int n, int h, int sq,
    int sk, int d, const long long* strides, long long mask_sn, int causal, float scale,
    void* stream) {
  return run(0, q, k, v, mask, dout, lse, di, dq, dk, dv, dtype, n, h, sq, sk, d, strides, mask_sn,
             causal, scale, stream);
}

extern "C" int paddle_fused_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* di, void* dq, void* dk, void* dv, int dtype, int n, int h, int sq,
    int sk, int d, const long long* strides, long long mask_sn, int causal, float scale,
    void* stream) {
  return run(1, q, k, v, mask, dout, lse, di, dq, dk, dv, dtype, n, h, sq, sk, d, strides, mask_sn,
             causal, scale, stream);
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
