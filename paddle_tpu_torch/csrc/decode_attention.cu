// Decode attention over an int8 KV cache, for Hopper (sm_90a): the attention
// of the slot-pooled LM step and of the K-wide speculative verify, reading
// the cache's int8 codes and dequantizing them in registers.
//
// Replaces what XLA fused on the TPU for the int8 KV path of the JAX package's
// decoding.py (:305-328 in the step, :496-537 in the verify fn):
// `dequantize_rows` of the whole cache, then the masked softmax einsums.
// That was no Pallas kernel, but written as torch ops the same function
// dequantizes the cache into an fp32 copy in HBM first, four times the
// bytes of the codes the int8 cache exists to save; this kernel reads the
// codes once.
//
// What it computes, for slot s, head h and query j < K (K = 1 for the step,
// the verify width for the verify fn), with L = min(ts[s] + j, T - 1):
//   k_t = k_codes[s, h, t, :] * k_scale[s, h, t]      (v_t likewise)
//   ctx[s, j, h, :] = sum_{t <= L} softmax_t(q[s, j, h, :] . k_t * scale) v_t
// q and ctx are fp32 [S, K, H, Dh]; the codes int8 [S, H, T, Dh]; the scales
// fp32 [S, H, T]; ts int32 [S].  The JAX package masks positions above L
// with a score of -1e9, whose exp underflows to exactly 0 in fp32, so
// skipping them, as this kernel does, drops no term.
//
// What bounds it on an H100 SXM: bytes.  It reads the codes and scales of
// the positions t <= ts + K - 1 once (Dh + 4 bytes a position, K and V each)
// plus q, and writes ctx; the 2 K Dh multiply-adds a position are far below
// the card's fp32 rate at 3.35 TB/s.
//
// Design (a simple kernel that is right; split-T and TMA are later work):
// one CTA of 128 threads per (slot, head), the K query rows in shared
// memory.  The positions up to the last one any query reads go by in tiles
// of 128, one position a thread: the thread reads its key row with 16-byte
// vector loads, dequantizes it in registers and forms its K scores, and
// stages its value row in shared memory.  An online softmax (running max
// and sum a query) folds each tile into K x Dh accumulators spread over the
// threads, each of which walks the staged value rows of its output column.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // positions a tile; threads a CTA
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* q;
  const int8_t* kc;
  const float* ks;
  const int8_t* vc;
  const float* vs;
  const int* ts;
  float* ctx;
  float scale;
  int K, H, T;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH, int KMAX>
__global__ void __launch_bounds__(kThreads) decode_attention_int8_kernel(Params p) {
  constexpr int kOut = (KMAX * DH + kThreads - 1) / kThreads;  // outputs a thread
  __shared__ float q_sh[KMAX][DH];
  __shared__ float p_sh[KMAX][kThreads];
  __shared__ __align__(16) int8_t v_sh[kThreads][DH];
  __shared__ float vs_sh[kThreads];
  __shared__ float red[KMAX][kWarps];
  __shared__ float m_run[KMAX], l_run[KMAX], alpha_sh[KMAX];

  const int K = p.K, H = p.H, T = p.T;
  const int s = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long sh = (long long)s * H + h;  // (slot, head) row of the cache
  const int t0s = p.ts[s];
  const int t_last = min(t0s + K - 1, T - 1);

  for (int i = tid; i < K * DH; i += kThreads) {
    const int j = i / DH, d = i % DH;
    q_sh[j][d] = p.q[(((long long)s * K + j) * H + h) * DH + d];
  }
  if (tid < KMAX) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  float acc[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int base = 0; base <= t_last; base += kThreads) {
    const int t = base + tid;
    float sc[KMAX];
    if (t <= t_last) {
      const int8_t* krow = p.kc + (sh * T + t) * DH;
      const int8_t* vrow = p.vc + (sh * T + t) * DH;
      float dot[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) dot[j] = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += 16) {
        const int4 kw = *reinterpret_cast<const int4*>(krow + c);
        *reinterpret_cast<int4*>(&v_sh[tid][c]) = *reinterpret_cast<const int4*>(vrow + c);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kw);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float kv = float(kb[e]);
#pragma unroll
          for (int j = 0; j < KMAX; ++j) dot[j] = fmaf(q_sh[j][c + e], kv, dot[j]);
        }
      }
      const float kscale = p.ks[sh * T + t] * p.scale;
      vs_sh[tid] = p.vs[sh * T + t];
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        sc[j] = (j < K && t <= min(t0s + j, T - 1)) ? dot[j] * kscale : -INFINITY;
    } else {
      vs_sh[tid] = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += 16) *reinterpret_cast<int4*>(&v_sh[tid][c]) = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) sc[j] = -INFINITY;
    }
    // the tile's max score a query, then the new running max
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const float m = warp_max(sc[j]);
      if (lane == 0) red[j][warp] = m;
    }
    __syncthreads();
    if (tid < K) {
      float m = red[tid][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[tid][w]);
      const float m_new = fmaxf(m_run[tid], m);
      // m_new is finite from the first tile on: position 0 is read by every query
      alpha_sh[tid] = (m_run[tid] == -INFINITY) ? 0.f : expf(m_run[tid] - m_new);
      m_run[tid] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const float pj = (sc[j] == -INFINITY) ? 0.f : expf(sc[j] - m_run[j]);
      p_sh[j][tid] = pj;
      const float sum = warp_sum(pj);
      if (lane == 0) red[j][warp] = sum;
    }
    __syncthreads();
    if (tid < K) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[tid][w];
      l_run[tid] = l_run[tid] * alpha_sh[tid] + sum;
    }
    const int n_t = min(kThreads, t_last - base + 1);
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int o = tid + r * kThreads;
      if (o < K * DH) {
        const int j = o / DH, d = o % DH;
        float a = acc[r] * alpha_sh[j];
        for (int tt = 0; tt < n_t; ++tt) a = fmaf(p_sh[j][tt] * vs_sh[tt], float(v_sh[tt][d]), a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int o = tid + r * kThreads;
    if (o < K * DH) {
      const int j = o / DH, d = o % DH;
      p.ctx[(((long long)s * K + j) * H + h) * DH + d] = acc[r] / l_run[j];
    }
  }
}

template <int KMAX>
cudaError_t launch(const Params& p, int S, int DH, cudaStream_t stream) {
  const dim3 grid(S * p.H);
  switch (DH) {
    case 32: decode_attention_int8_kernel<32, KMAX><<<grid, kThreads, 0, stream>>>(p); break;
    case 64: decode_attention_int8_kernel<64, KMAX><<<grid, kThreads, 0, stream>>>(p); break;
    case 128: decode_attention_int8_kernel<128, KMAX><<<grid, kThreads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

constexpr int kVerifyMax = 8;  // the widest verify this source serves

Params make_params(const float* q, const int8_t* kc, const float* ks, const int8_t* vc, const float* vs,
                   const int* ts, float scale, int K, int H, int T, float* ctx) {
  Params p;
  p.q = q;
  p.kc = kc;
  p.ks = ks;
  p.vc = vc;
  p.vs = vs;
  p.ts = ts;
  p.ctx = ctx;
  p.scale = scale;
  p.K = K;
  p.H = H;
  p.T = T;
  return p;
}

}  // namespace

// The step's attention (one query a slot).  q, ctx: fp32 [S, 1, H, DH];
// k_codes, v_codes: int8 [S, H, T, DH], 16-byte aligned; k_scale, v_scale:
// fp32 [S, H, T]; ts: int32 [S].  DH is 32, 64 or 128.  Returns a cudaError_t.
extern "C" int paddle_decode_attention_int8_step(const float* q, const int8_t* k_codes, const float* k_scale,
                                                 const int8_t* v_codes, const float* v_scale, const int* ts,
                                                 float scale, int S, int H, int T, int DH, float* ctx,
                                                 void* stream) {
  if (S < 1 || H < 1 || T < 1) return int(cudaErrorInvalidValue);
  const Params p = make_params(q, k_codes, k_scale, v_codes, v_scale, ts, scale, 1, H, T, ctx);
  return int(launch<1>(p, S, DH, static_cast<cudaStream_t>(stream)));
}

// The verify fn's attention (K queries a slot, query j at position ts + j),
// K <= 8; the layouts are the step's with K in place of 1.
extern "C" int paddle_decode_attention_int8_verify(const float* q, const int8_t* k_codes,
                                                   const float* k_scale, const int8_t* v_codes,
                                                   const float* v_scale, const int* ts, float scale, int S,
                                                   int K, int H, int T, int DH, float* ctx, void* stream) {
  if (S < 1 || H < 1 || T < 1 || K < 1 || K > kVerifyMax) return int(cudaErrorInvalidValue);
  const Params p = make_params(q, k_codes, k_scale, v_codes, v_scale, ts, scale, K, H, T, ctx);
  return int(launch<kVerifyMax>(p, S, DH, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
