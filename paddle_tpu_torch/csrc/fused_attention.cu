// Fused scaled-dot-product attention, forward, for Hopper (sm_90a), on the
// tensor cores.
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
// What bounds it on an H100 SXM (reckoned from shapes; PERF.md holds the
// measured times).  Bytes are Q, K, V read once and Out written once, plus
// Mask; operations are the two products, 4 N H S^2 D, at the tensor cores'
// rate (fp32 as 3xTF32, below: three TF32 products a product, 495
// TFLOP/s; bf16 989 TFLOP/s).  At H=12, S=128, D=64:
//   * fp32, N=32 (training): 50.3 MB at 3.35 TB/s = 15.0 us against
//     3 x 1.61 GFLOP = 9.8 us;
//   * fp32, N=16 (serving): 7.5 us against 4.9 us;
//   * bf16, N=16: 3.8 us against 0.8 us.
// So bytes bound every case: each input is read from device memory once
// per block that needs it, and no [N, H, S, S] tensor leaves the SM.
//
// Design (the building blocks are attention_sm90.cuh's, shared with the
// backward's dQ kernel, whose walk this kernel follows):
//  * A block owns query rows of one (n, h) and walks the K/V tiles in a
//    loop, where the TPU walked them as a sequential grid dimension.  Each
//    warpgroup owns 64 rows (wgmma's M); fp32 at D <= 64 runs two a block,
//    sharing each tile's conversion.  Every output element is summed by
//    one thread in a fixed order, so results repeat bit for bit and a
//    row's result does not depend on the batch it is served in.
//  * S = Q K^T on wgmma, both operands K-major as stored, into an fp32
//    accumulator in registers.  Scale, causal and padding terms are applied
//    to the fragment in the reference's order (attn::masked_score); keys
//    past S score -inf.
//  * Online softmax on the fragment: each accumulator row lives in the 4
//    lanes of a quad, so the row max takes two shuffles.  Each thread keeps
//    its two rows' running max and its share of their running sums; the O
//    accumulator is rescaled by exp(m_old - m_new) at each tile.  The first
//    tile starts from m = -inf and holds key 0, which is real, so m is
//    finite from then on (-1e9 on an all-pad row) and no (-inf) - (-inf)
//    is formed.  exp is 2^x of the argument times log2(e) (ex2.approx,
//    2 ulps), about 1e-6 relative.
//  * O += P V on wgmma with A from registers: the score accumulator,
//    turned into P = exp(s - m) in place, is the A fragment (attn::Frags).
//    O is scaled by the inverse of the row sum once, at the end.
//  * fp32 (the training path's type): 3xTF32.  Each operand x splits into
//    big (x with its 13 low mantissa bits cleared) and small = x - big;
//    each product is a_big b_big + a_big b_small + a_small b_big, about
//    2^-20 of each term: fp32's accuracy to a few ulps.  The block's Q is
//    split once; each K tile is split as it arrives, and each V tile into
//    the halves of its transpose (TF32 wgmma takes K-major operands only),
//    its walked rows in the order 0 2 4 6 1 3 5 7 that matches the
//    accumulator fragment.  P splits into big and small in registers.
//  * bf16: bf16 wgmma straight from the staged tiles; V is read MN-major
//    through the descriptor's transpose flag.  P feeds A rounded once to
//    bf16, as the reference rounds its softmax weights (the JAX package's
//    ops/nn_ops.py:716); here P = exp(s - m) is unnormalised, in (0, 1],
//    and the division comes at the end in fp32.  (The backward feeds P and
//    dS as two bf16 halves: its sums over many rows grow past the limit.
//    Two halves here measured no closer to the reference, and slower.)
//  * Copies: the block's Q and each K/V tile with its Mask values come
//    through cp.async; tile it + 1 loads while tile it computes (a ring of
//    two stages in bf16; fp32 reuses its one raw stage once the tile is
//    converted; a ring of four bf16 stages, all of S = 128 in flight at
//    once, measured slower).  No mbarrier waits: nothing can wait forever.  Out goes
//    out through shared memory in 16-byte stores.  Where a pointer, stride
//    or D is not a multiple of 16 bytes, plain loads and stores take the
//    same paths.
//  * Shapes: any S (rows past S are zero-filled and not written); D up to
//    128, zero-padded to DP = 32, 64 or 128; causal or not; Mask or none;
//    Q, K, V and Out are addressed through their (n, h, s) strides with a
//    unit last stride, so the [N, S, H, D] views of the head split are read
//    and written in place.
//  * Score bits: the dQ kernel computes S = Q K^T with the same split, the
//    same k order and the same wgmma shapes (the same Cfg), so its
//    recomputed scores are this kernel's, bit for bit.
//  * At H=12, S=128, D=64: fp32 blocks of 256 threads own 128 rows with
//    115,456 bytes of shared memory, two a SM (below): 192 blocks at N=16
//    and 384 at N=32 are 0.73 and 1.45 waves on 132 SMs.  bf16 blocks of
//    128 threads own 64 rows with 25,344 bytes; registers allow four a SM,
//    so the 384 blocks at N=16 are 0.73 waves.

#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

using namespace attn;

// 2^x on the special-function unit, flushing denormal results to zero:
// exp2f's extra steps keep denormals, which a softmax weight below 2^-126
// does not need.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // [N, Sk] fp32 with row stride mask_sn, or null
  void* out;
  float* stats;       // [2, N, H, Sq] fp32, contiguous (row max, log row sum), or null
  int sq, sk, d;
  long long nhs;      // N * H * Sq: from the row max to the log row sum
  long long q_sn, q_sh, q_ss;
  long long k_sn, k_sh, k_ss;
  long long v_sn, v_sh, v_ss;
  long long o_sn, o_sh, o_ss;
  long long mask_sn;
  int causal;
  int vec;            // every row allows 16-byte copies and stores
  float scale;
};

// Two blocks a SM: in fp32 at D = 64 that holds ptxas to 128 registers a
// thread (it takes 166 unbounded, which leaves room for one block), and
// shared memory (115,456 bytes a block) allows two.
template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kThreads, 2)
    fused_attention_fwd_kernel(const FwdParams p) {
  using C = Cfg<T, DP>;
  constexpr bool kF32 = C::kF32;
  constexpr int W = C::kWalk;
  constexpr int NT = C::kThreads;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  // the block's queries (fp32: big and small halves)
  T* Qb = reinterpret_cast<T*>(smem);
  T* Qs = kF32 ? reinterpret_cast<T*>(smem + C::kRowTile) : Qb;
  // the ring: [kStages][raw K, raw V], then [2][Mask]
  unsigned char* ring = smem + (kF32 ? 2 : 1) * C::kRowTile;
  // fp32: K in halves, V's transpose in halves; before the walk, the
  // block's raw Q
  float* conv = reinterpret_cast<float*>(ring + C::kRing);
  constexpr int kWalkF = W * DP;
  float *Kb = conv, *Ks = conv + kWalkF, *VTb = conv + 2 * kWalkF, *VTs = conv + 3 * kWalkF;
  static_assert(!kF32 || C::kRowTile <= 4 * C::kWalkTile, "raw Q must fit where K and V convert");

  const int tid = threadIdx.x, wgi = tid >> 7, lane = tid & 31, t4 = lane & 3;
  const long long n = blockIdx.z, h = blockIdx.y;
  const int b0 = blockIdx.x * C::kBlockRows;  // the block's queries
  const int q0 = b0 + kRows * wgi;            // this warpgroup's queries
  // this thread's queries: q0 + row_lo and q0 + row_lo + 8
  const int row_lo = 16 * ((tid >> 5) & 3) + (lane >> 2);
  const bool vec = p.vec != 0;

  const T* qg = static_cast<const T*>(p.q) + n * p.q_sn + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + n * p.k_sn + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + n * p.v_sn + h * p.v_sh;
  const float* mrow = p.mask != nullptr ? p.mask + n * p.mask_sn : nullptr;

  auto raw = [&](int it, int which) {
    return reinterpret_cast<T*>(ring + (it % C::kStages) * C::kStage + which * C::kWalkTile);
  };
  auto mvals = [&](int it) {
    return reinterpret_cast<float*>(ring + C::kStages * C::kStage + (it & 1) * C::kVecSlot);
  };
  // walked tile `it`: its rows [it W, it W + W) of K and V, and their Mask
  auto load_stage = [&](int it) {
    const int k0 = it * W;
    load_tile<T, W, DP, NT>(raw(it, 0), kg, p.k_ss, k0, p.sk, p.d, vec);
    load_tile<T, W, DP, NT>(raw(it, 1), vg, p.v_ss, k0, p.sk, p.d, vec);
    if (mrow != nullptr && tid < W)
      cp_async4(mvals(it) + tid, k0 + tid < p.sk ? mrow + k0 + tid : mrow, k0 + tid < p.sk);
  };

  // the block's queries and the first tile, in flight together
  const int n_tiles = (p.sk + W - 1) / W;
  load_tile<T, C::kBlockRows, DP, NT>(kF32 ? reinterpret_cast<T*>(conv) : Qb, qg, p.q_ss, b0,
                                      p.sq, p.d, vec);
  load_stage(0);
  cp_async_commit();
  if constexpr (kF32) {
    cp_async_wait_all();
    __syncthreads();
    split_tile<C::kBlockRows, DP, false, NT>(conv, Qb, Qs, nullptr, nullptr);
    __syncthreads();  // the first tile's conversion rewrites conv
  }

  // this thread's two rows: running max and its share of the running sum
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[DP / 2];
  zero(o);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * W;
    // tile `it` has landed, and no other copy is in flight
    cp_async_wait_all();
    wg::fence_proxy_async();
    __syncthreads();
    const T *kb = raw(it, 0), *ks = kb, *vtb = raw(it, 1), *vts = vtb;
    if constexpr (kF32) {
      split_tile<W, DP, false, NT>(raw(it, 0), Kb, Ks, nullptr, nullptr);
      split_tile<W, DP, true, NT, false>(raw(it, 1), nullptr, nullptr, VTb, VTs);
      wg::fence_proxy_async();
      __syncthreads();
      kb = Kb, ks = Ks, vtb = VTb, vts = VTs;
    }
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      load_stage(it + 1);
      cp_async_commit();
    }

    // S = Q K^T: queries x keys
    float s[W / 2];
    zero(s);
    wg::fence();
    const int a_off = wgi * kRows * DP;  // this warpgroup's rows of the block's tile
    mma_over_d<T, DP, W>(s, Qb + a_off, Qs + a_off, kb, ks);
    wg::commit();
    wg::wait_all();
    wg::keep(s);

    // scores in the reference's order, and each row's max over the tile
    const float* mv = mvals(it);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t4 + e, kj = k0 + col;
        const bool kvalid = kj < p.sk;
        const float mterm = mrow != nullptr ? (mv[col] - 1.0f) * 1e9f : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const float x = masked_score(s[i], p.scale, p.causal, q0 + row_lo + 8 * hh, kj,
                                       mrow != nullptr, mterm);
          s[i] = kvalid ? x : -INFINITY;
          mx[hh] = fmaxf(mx[hh], s[i]);
        }
      }
    }
    // online softmax: the new running max (the quad's 4 lanes hold a row),
    // the old sum and O rescaled to it, and P = exp(s - m) in place
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh]);  // finite: key k0 is real
      corr[hh] = ex2((m_run[hh] - m_new) * kLog2e);  // 0 on the first tile
      m_run[hh] = m_new;
      l_run[hh] *= corr[hh];
    }
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const int hh = (i >> 1) & 1;
      s[i] = ex2((s[i] - m_run[hh]) * kLog2e);  // keys past S: 2^-inf = 0
      l_run[hh] += s[i];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V
    Frags<T, W, false> pa;  // bf16: P rounded once
    pa.make(s);
    wg::fence();
    mma_over_walk<T, DP, W, false>(o, pa, vtb, vts);
    wg::commit();
    wg::wait_all();
    wg::keep(o);
    pa.keep();
    __syncthreads();  // the stage and the converted tiles are rewritten next
  }

  // each row's sum over its quad; O times its inverse (one division a
  // row, not one an element); the statistics
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
    inv[hh] = 1.0f / l_run[hh];
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  if (p.stats != nullptr && t4 == 0) {
    const long long at = (n * gridDim.y + h) * p.sq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = q0 + row_lo + 8 * hh;
      if (qi < p.sq) {
        p.stats[at + qi] = m_run[hh];
        p.stats[p.nhs + at + qi] = logf(l_run[hh]);
      }
    }
  }
  // all of shared memory is free now: the epilogue stages Out there
  store_rows<T, DP, NT>(smem, o, 1.0f, static_cast<T*>(p.out) + n * p.o_sn + h * p.o_sh, p.o_ss,
                        b0, p.sq, p.d, vec);
}

template <typename T, int DP>
cudaError_t launch(const FwdParams& p, int n, int h, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  const int smem = C::smem_bytes(kFwd);
  static SmemLimit limit;
  cudaError_t err = limit.raise_once(fused_attention_fwd_kernel<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + C::kBlockRows - 1) / C::kBlockRows, h, n);
  fused_attention_fwd_kernel<T, DP><<<grid, C::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const FwdParams& p, int n, int h, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32>(p, n, h, stream);
  if (p.d <= 64) return launch<T, 64>(p, n, h, stream);
  return launch<T, 128>(p, n, h, stream);
}

template <typename T, int DP>
void config_of(int* out) {
  using C = Cfg<T, DP>;
  out[0] = C::kThreads;
  out[1] = C::kBlockRows;
  out[2] = C::kWalk;
  out[3] = C::smem_bytes(kFwd);
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
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const float*>(mask);
  p.out = out;
  p.stats = static_cast<float*>(stats);
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.nhs = (long long)n * h * sq;
  const long long strides[12] = {q_sn, q_sh, q_ss, k_sn, k_sh, k_ss,
                                 v_sn, v_sh, v_ss, o_sn, o_sh, o_ss};
  long long* dst[12] = {&p.q_sn, &p.q_sh, &p.q_ss, &p.k_sn, &p.k_sh, &p.k_ss,
                        &p.v_sn, &p.v_sh, &p.v_ss, &p.o_sn, &p.o_sh, &p.o_ss};
  for (int i = 0; i < 12; ++i) *dst[i] = strides[i];
  p.mask_sn = mask_sn;
  p.causal = causal;
  p.scale = scale;
  // 16-byte copies and stores need every row to start on 16 bytes, and D
  // to fill whole chunks
  const long long item = dtype == 0 ? 4 : 2;
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) && (d * item) % 16 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && (strides[i] * item) % 16 == 0;
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch_dim<float>(p, n, h, s) : dispatch_dim<__nv_bfloat16>(p, n, h, s);
  return int(err);
}

// The launch configuration of one instantiation, for reports: out[0..3] =
// threads a block, rows a block owns, rows a walked tile, dynamic shared
// memory bytes.  dtype as above; dp: the head dim.
extern "C" void paddle_fused_attention_fwd_config(int dtype, int dp, int* out) {
  if (dtype == 0)
    dp <= 32 ? config_of<float, 32>(out) : dp <= 64 ? config_of<float, 64>(out) : config_of<float, 128>(out);
  else
    dp <= 32 ? config_of<__nv_bfloat16, 32>(out)
             : dp <= 64 ? config_of<__nv_bfloat16, 64>(out) : config_of<__nv_bfloat16, 128>(out);
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
