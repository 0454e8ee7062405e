// Ring attention's merge step (kernel B2) for Hopper (sm_90a): one block's
// attention output folded into the running output, by the blocks' row
// statistics, in one elementwise pass.
//
// Replaces what XLA fused on the TPU inside the JAX package's ring attention
// (its parallel/ring_attention.py:26, the body of the `lax.scan`:
// the running max, the correction factor and the rescaled accumulator; no
// pallas_call).  The port attends each K/V block that reaches a rank with
// kernel B1's forward, which also writes the block's row statistics
// (csrc/fused_attention.cu), and merges the block's normalised output into
// the running one here.
//
// What it computes, for o_a, o_b [N, H, T, D] (fp32 or bf16, any (n, h, t)
// strides, unit stride on d) and their row statistics st_a, st_b, fp32
// [2, N, H, T] contiguous in B1's format (row max m, log of the row sum l of
// exp(s - m)):
//   m   = max(m_a, m_b)
//   w_a = exp((m_a - m) + log l_a),  w_b = exp((m_b - m) + log l_b)
//   l   = w_a + w_b
//   out = (o_a w_a + o_b w_b) / max(l, 1e-20)       (in o's type)
//   st  = (m, log l)                                  (fp32)
// which is o_a e^(lse_a - lse) + o_b e^(lse_b - lse) with lse = m + log l =
// logaddexp(lse_a, lse_b), taken without forming lse: B1's row max and log
// row sum stay apart because their sum rounds away where every score is
// masked (kernels/fused_attention.py `_row_stats`).  A block with no valid
// key comes as the masked fill, m = -1e30 and log l = -inf, and weighs 0;
// two of them give l = 0, out = 0 (the JAX function's max(l, 1e-20) guard)
// and log l = -inf again.  All arithmetic is fp32 in registers.
//
// What bounds it on an H100 SXM: bytes.  It reads o_a, o_b and the two
// statistics once and writes out and its statistics once:
// 3 N H T D item + 6 N H T 4 bytes (item = 4 fp32, 2 bf16), against some 10
// operations an element.  At phase 39's [2, 8, 1024, 64] in fp32: 13.0 MB,
// 3.9 us at 3.35 TB/s.
//
// Design: a grid-stride loop, one thread an element, the row's four
// statistics read by each of its D threads (one L1 line for a warp).  A
// simple kernel that is right; vector loads come with a PR that makes it
// fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  long long rows;             // N H T
  int h, t, d;
  long long sa[3], sb[3], so[3];  // (n, h, t) strides of o_a, o_b, out, in elements
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ring_merge_kernel(const T* __restrict__ oa, const float* __restrict__ sta,
                      const T* __restrict__ ob, const float* __restrict__ stb,
                      T* __restrict__ out, float* __restrict__ st_out, Params p) {
  const long long total = p.rows * p.d;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / p.d;
    const int e = int(i - row * p.d);
    const long long nh = row / p.t;
    const long long t = row - nh * p.t;
    const long long n = nh / p.h;
    const long long h = nh - n * p.h;
    const float ma = sta[row], la = sta[p.rows + row];
    const float mb = stb[row], lb = stb[p.rows + row];
    const float m = fmaxf(ma, mb);
    const float wa = expf((ma - m) + la);
    const float wb = expf((mb - m) + lb);
    const float l = wa + wb;
    const float va = load(oa + n * p.sa[0] + h * p.sa[1] + t * p.sa[2] + e);
    const float vb = load(ob + n * p.sb[0] + h * p.sb[1] + t * p.sb[2] + e);
    store(out + n * p.so[0] + h * p.so[1] + t * p.so[2] + e, (va * wa + vb * wb) / fmaxf(l, 1e-20f));
    if (e == 0) {
      st_out[row] = m;
      st_out[p.rows + row] = logf(l);
    }
  }
}

template <typename T>
cudaError_t launch(const void* oa, const float* sta, const void* ob, const float* stb, void* out,
                   float* st_out, const Params& p, cudaStream_t stream) {
  const long long total = p.rows * p.d;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks an SM; the loop strides over the rest
  ring_merge_kernel<T><<<int(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(oa), sta, static_cast<const T*>(ob), stb, static_cast<T*>(out), st_out,
      p);
  return cudaGetLastError();
}

}  // namespace

// o_a, o_b, out: [n, h, t, d] of type dtype (0 fp32, 1 bf16) with the (n, h, t)
// strides given in elements and a unit stride on d; st_a, st_b, st_out: fp32
// [2, n, h, t] contiguous.  out and st_out may not alias the inputs.
// Returns a cudaError_t (0 on a successful launch).
extern "C" int paddle_ring_merge(const void* oa, const void* sta, const void* ob, const void* stb,
                                 void* out, void* st_out, int dtype, int n, int h, int t, int d,
                                 long long sa0, long long sa1, long long sa2, long long sb0,
                                 long long sb1, long long sb2, long long so0, long long so1,
                                 long long so2, void* stream) {
  if (n < 1 || h < 1 || t < 1 || d < 1 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  Params p;
  p.rows = (long long)n * h * t;
  p.h = h;
  p.t = t;
  p.d = d;
  p.sa[0] = sa0; p.sa[1] = sa1; p.sa[2] = sa2;
  p.sb[0] = sb0; p.sb[1] = sb1; p.sb[2] = sb2;
  p.so[0] = so0; p.so[1] = so1; p.so[2] = so2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(sta);
  const float* b = static_cast<const float*>(stb);
  float* o = static_cast<float*>(st_out);
  return int(dtype == 0 ? launch<float>(oa, a, ob, b, out, o, p, s)
                        : launch<__nv_bfloat16>(oa, a, ob, b, out, o, p, s));
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
