// Fused scaled-dot-product attention, backward, for Hopper (sm_90a), on
// the tensor cores.
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
// the row statistics the forward kernel writes (fp32 [2, N, H, Sq]: the row
// max m of the scores and log l, the log of the row sum of exp(s - m)) and
// Di = rowsum(O * dO) (fp32 [N, H, Sq], a torch reduction beside the
// launch, as XLA computed it beside the TPU kernels):
//   s   = (Q K^T) * scale + causal + padding   (fp32, the reference's order
//                                               of additions:
//                                               attn::masked_score)
//   P   = exp((s - m) - log l)
//   dV  = P^T dO
//   dP  = dO V^T
//   dS  = P * (dP - Di)
//   dQ  = scale * dS K
//   dK  = scale * dS^T Q                        (all written in Q's dtype)
// This is the vjp of the op's einsum branch (the JAX package's
// ops/nn_ops.py:709-717), with no gradient to Mask.  m and log l are kept
// apart because their sum rounds away on a row whose keys are all masked:
// there every score is -1e9, where one fp32 ulp is 64, so m + log(S) is m,
// and exp(s - (m + log l)) would give each key 1 where the softmax gives
// 1/S.  Pad query rows get real gradients (they attend the real keys, and
// later layers send gradient back through them), so every row and every
// tile is processed; nothing is skipped.
//
// Score bits: the dQ kernel computes S = Q K^T as the forward kernel does,
// with the same split, the same k order and the same wgmma shapes (one
// Cfg), so its recomputed scores are the forward's bit for bit.  The dK/dV
// kernel computes S^T = K Q^T: the same three products of each pair of
// halves, summed in another order (its first term is K_small Q_big, the
// forward's Q_small K_big), so a recomputed score can differ from the
// forward's by fp32 rounding.  On a row with a real key that moves P by
// about 1e-7 relative.  A masked score stays -1e9 exactly unless
// |q.k * scale| >= 32 (half an ulp at 1e9), so all-pad rows keep their bits.
//
// What bounds them on an H100 SXM (reckoned from shapes; PERF.md holds the
// measured times), at the training shape N=32, H=12, S=128, D=64 with a
// padding mask.  Bytes are Q, K, V, dO read once and the outputs written
// once, plus the row statistics, Di and Mask; operations count the
// products each kernel runs, at the tensor cores' rate:
//   * dK/dV: four products (K Q^T, V dO^T, P^T dO, dS^T Q), 3.22 GFLOP;
//     fp32 as 3xTF32 (below) is 3 x 3.22 GFLOP at 495 TFLOP/s = 19.5 us
//     against 76.1 MB at 3.35 TB/s = 22.7 us; bf16 3.3 us against 11.4 us.
//   * dQ: three products (Q K^T, dO V^T, dS K), 2.42 GFLOP; fp32 14.6 us
//     against 63.5 MB = 18.9 us; bf16 2.4 us against 9.5 us.
// So bytes bound both, in both types: every input is read from device
// memory once per block that needs it, and the scores never leave the SM.
//
// Design (the building blocks are attention_sm90.cuh's, shared with the
// forward kernel):
//  * The TPU's split: dK/dV blocks own keys and walk the query tiles; dQ
//    blocks own queries and walk the key/value tiles.  A loop in the block
//    takes the place of the TPU's sequential grid dimension.  Each
//    warpgroup (128 threads) owns 64 rows, wgmma's M.  No atomics: every
//    output element is summed by one thread in a fixed order, so results
//    repeat bit for bit.
//  * Products on wgmma, fp32 accumulators in registers.  The two products
//    over D (scores and dP) take A and B from shared memory.  The products
//    over the walked rows (P^T dO, dS^T Q, dS K) take A from registers: the
//    accumulator fragment of the scores, turned into P or dS in place, is
//    the A fragment of the next product.  Masks, exp, Di and the scale are
//    applied to the fragment in the reference's order; exp is exp2 of the
//    argument times log2(e), about 1e-6 relative at the arguments that
//    matter.
//  * bf16: bf16 wgmma.  The tiles are staged as they are stored, [rows][D];
//    the products over the walked rows read the same tile MN-major (the
//    descriptor's transpose flag).  P and dS feed A as two bf16 halves,
//    big = bf16(x) and small = bf16(x - big): one rounding of P to bf16
//    moved dV by up to 0.0625 where it is near 5 at the training shape,
//    past the check's limit.  One warpgroup a block, 64 rows, walked tiles
//    of 32; two stages in the ring.
//  * fp32 (the training path's type): 3xTF32.  Each operand x splits into
//    big (x with its 13 low mantissa bits cleared) and small = x - big, and
//    each product is a_big b_big + a_big b_small + a_small b_big on TF32
//    wgmma, accumulated in fp32: about 2^-20 of each term, fp32's accuracy
//    to a few ulps, at three times TF32's work.  TF32 wgmma takes K-major
//    operands only, so each walked tile is converted in shared memory into
//    its halves and the halves of its transpose ([D][rows]); the A fragment
//    taken from an accumulator holds columns {2t, 2t+1} where TF32 wants
//    {t, t+4}, so the transposed tiles store each 8 walked rows in the order
//    0 2 4 6 1 3 5 7 (split_tile).  The conversion costs as much as the
//    products, so at D <= 64 a block runs two warpgroups (128 rows) that
//    share it; walked tiles of 32 rows (16 at D = 128, one warpgroup, for
//    shared memory); one raw stage, free again once it is converted.
//  * Copies: each walked tile, and its per-row vectors (row max, log row
//    sum, Di; or Mask), comes through the ring with cp.async; the next one
//    loads while this one computes.  (TMA would need a 4-D tensor map per
//    call for the [N, S, H, D] views; at tiles of 32 rows, cp.async of
//    16-byte chunks is enough.)  The block's own rows are staged once, with
//    their loads in flight together.  The outputs go out through shared
//    memory in 16-byte stores.  Where a pointer, stride or D is not a
//    multiple of 16 bytes, plain loads and stores take the same paths.
//  * Shapes: any S (rows past S are zero-filled and give P = 0, and are not
//    written); D up to 128, zero-padded to DP = 32, 64 or 128; causal or
//    not; Mask or none; Q, K, V, dO, dQ, dK and dV are addressed through
//    their (n, h, s) strides with a unit last stride, so the [N, S, H, D]
//    views of the head split are read and written in place.
//  * Shared memory tiles use wgmma's no-swizzle layout: core matrices of 8
//    rows x 16 bytes, 128 contiguous bytes each (tile_off).
//  * At the training shape: fp32 grids of 384 blocks (256 threads, 213,760
//    and 197,376 bytes of shared memory for dK/dV and dQ: one block a SM),
//    bf16 grids of 768 (128 threads, 33,536 bytes; registers allow three
//    dK/dV or five dQ blocks a SM).

#include <stdint.h>

#include "attention_sm90.cuh"

namespace {

using namespace attn;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;   // [N, Sk] fp32 with row stride mask_sn, or null
  const void* dout;
  const float* stats;  // [2, N, H, Sq] fp32, contiguous: row max, log row sum
  const float* di;     // [N, H, Sq] fp32, contiguous
  void* dq;
  void* dk;
  void* dv;
  int sq, sk, d;
  long long nhs;       // N * H * Sq: from the row max to the log row sum
  long long q_sn, q_sh, q_ss;
  long long k_sn, k_sh, k_ss;
  long long v_sn, v_sh, v_ss;
  long long do_sn, do_sh, do_ss;
  long long dq_sn, dq_sh, dq_ss;
  long long dk_sn, dk_sh, dk_ss;
  long long dv_sn, dv_sh, dv_ss;
  long long mask_sn;
  int causal;
  int vec;             // every row allows 16-byte copies and stores
  float scale;
};

// ---------------------------------------------------------------------------
// dK, dV: the block's rows are keys, the walked tiles are queries.
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kThreads, 1)
    fused_attention_bwd_dkv_kernel(const BwdParams p) {
  using C = Cfg<T, DP>;
  constexpr bool kF32 = C::kF32;
  constexpr int W = C::kWalk;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  // the block's keys and values (fp32: big and small halves)
  T* Kb = reinterpret_cast<T*>(smem);
  T* Vb = reinterpret_cast<T*>(smem + (kF32 ? 2 : 1) * C::kRowTile);
  T* Ks = kF32 ? reinterpret_cast<T*>(smem + C::kRowTile) : Kb;
  T* Vs = kF32 ? reinterpret_cast<T*>(smem + 3 * C::kRowTile) : Vb;
  // the ring: [kStages][raw Q, raw dO], then [2][row max, log row sum, Di]
  unsigned char* ring = smem + (kF32 ? 4 : 2) * C::kRowTile;
  // fp32: the walked tile converted: Q, dO in halves, and their transposes
  float* conv = reinterpret_cast<float*>(ring + C::kRing);
  constexpr int kWalkF = W * DP;
  float *Qb = conv, *Qs = conv + kWalkF, *dOb = conv + 2 * kWalkF, *dOs = conv + 3 * kWalkF;
  float *QTb = conv + 4 * kWalkF, *QTs = conv + 5 * kWalkF;
  float *dOTb = conv + 6 * kWalkF, *dOTs = conv + 7 * kWalkF;

  constexpr int NT = C::kThreads;
  const int tid = threadIdx.x, wgi = tid >> 7, lane = tid & 31, t4 = lane & 3;
  const long long n = blockIdx.z, h = blockIdx.y;
  const int b0 = blockIdx.x * C::kBlockRows;  // the block's keys
  const int k0 = b0 + kRows * wgi;            // this warpgroup's keys
  // this thread's keys: k0 + row_lo and k0 + row_lo + 8
  const int row_lo = 16 * ((tid >> 5) & 3) + (lane >> 2);
  const bool vec = p.vec != 0;

  const T* qg = static_cast<const T*>(p.q) + n * p.q_sn + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + n * p.k_sn + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + n * p.v_sn + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + n * p.do_sn + h * p.do_sh;
  const long long at = (n * gridDim.y + h) * p.sq;
  const float* mrow = p.mask != nullptr ? p.mask + n * p.mask_sn : nullptr;

  auto raw = [&](int it, int which) {
    return reinterpret_cast<T*>(ring + (it % C::kStages) * C::kStage + which * C::kWalkTile);
  };
  auto vecs = [&](int it) {
    return reinterpret_cast<float*>(ring + C::kStages * C::kStage + (it & 1) * C::kVecSlot);
  };
  // walked tile `it`: its rows [it W, it W + W) of Q and dO, and their row
  // max, log row sum and Di
  auto load_stage = [&](int it) {
    const int q0 = it * W;
    load_tile<T, W, DP, NT>(raw(it, 0), qg, p.q_ss, q0, p.sq, p.d, vec);
    load_tile<T, W, DP, NT>(raw(it, 1), dog, p.do_ss, q0, p.sq, p.d, vec);
    if (tid < 3 * W) {
      const int which = tid / W, qi = q0 + tid % W;
      const float* src = which == 0 ? p.stats + at : which == 1 ? p.stats + p.nhs + at : p.di + at;
      cp_async4(vecs(it) + tid, qi < p.sq ? src + qi : src, qi < p.sq);
    }
  };

  const int n_tiles = (p.sq + W - 1) / W;
  load_stage(0);
  if constexpr (kF32) {
    cp_async_commit();
    load_split2<C::kBlockRows, DP, NT>(Kb, Ks, kg, p.k_ss, Vb, Vs, vg, p.v_ss, b0, p.sk, p.d, vec);
  } else {
    load_tile<T, C::kBlockRows, DP, NT>(Kb, kg, p.k_ss, b0, p.sk, p.d, vec);
    load_tile<T, C::kBlockRows, DP, NT>(Vb, vg, p.v_ss, b0, p.sk, p.d, vec);
    cp_async_commit();
  }

  // this thread's keys: validity and padding term, fixed for the walk
  bool kvalid[2];
  float mterm[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = k0 + row_lo + 8 * hh;
    kvalid[hh] = kj < p.sk;
    mterm[hh] = (mrow != nullptr && kvalid[hh]) ? (mrow[kj] - 1.0f) * 1e9f : 0.f;
  }

  float dk[DP / 2], dv[DP / 2];
  zero(dk);
  zero(dv);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * W;
    // tile `it` has landed, and no other copy is in flight: the proxy fence
    // (for bf16 stages, which wgmma reads as they landed) waits for nothing
    // else
    cp_async_wait_all();
    wg::fence_proxy_async();
    __syncthreads();
    const T *qb = raw(it, 0), *qs = qb, *dob = raw(it, 1), *dos = dob;
    const T *qtb = qb, *qts = qb, *dotb = dob, *dots = dob;
    if constexpr (kF32) {
      split_tile<W, DP, true, NT>(raw(it, 0), Qb, Qs, QTb, QTs);
      split_tile<W, DP, true, NT>(raw(it, 1), dOb, dOs, dOTb, dOTs);
      wg::fence_proxy_async();
      __syncthreads();
      qb = Qb, qs = Qs, dob = dOb, dos = dOs, qtb = QTb, qts = QTs, dotb = dOTb, dots = dOTs;
    }
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      load_stage(it + 1);
      cp_async_commit();
    }

    // S^T = K Q^T and dP^T = V dO^T: keys x queries
    float sT[W / 2], dpT[W / 2];
    zero(sT);
    zero(dpT);
    wg::fence();
    const int a_off = wgi * kRows * DP;  // this warpgroup's rows of the block's tiles
    mma_over_d<T, DP, W>(sT, Kb + a_off, Ks + a_off, qb, qs);
    mma_over_d<T, DP, W>(dpT, Vb + a_off, Vs + a_off, dob, dos);
    wg::commit();
    wg::wait_all();
    wg::keep(sT);
    wg::keep(dpT);

    // P and dS in place, in the reference's order
    const float* sv = vecs(it);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t4 + e, qi = q0 + col;
        const float mq = sv[col], lq = sv[W + col], dq = sv[2 * W + col];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const float x = masked_score(sT[i], p.scale, p.causal, qi, k0 + row_lo + 8 * hh,
                                       mrow != nullptr, mterm[hh]);
          const float pv = (qi < p.sq && kvalid[hh]) ? exp2f(((x - mq) - lq) * kLog2e) : 0.f;
          sT[i] = pv;
          dpT[i] = pv * (dpT[i] - dq);
        }
      }
    }

    // dV += P^T dO, dK += dS^T Q
    Frags<T, W> pa, dsa;
    pa.make(sT);
    dsa.make(dpT);
    wg::fence();
    mma_over_walk<T, DP, W>(dv, pa, dotb, dots);
    mma_over_walk<T, DP, W>(dk, dsa, qtb, qts);
    wg::commit();
    wg::wait_all();
    wg::keep(dv);
    wg::keep(dk);
    pa.keep();
    dsa.keep();
    __syncthreads();  // the stage and the converted tiles are rewritten next
  }

  // all of shared memory is free now: the epilogue stages dK and dV there
  store_rows<T, DP, NT>(smem, dk, p.scale, static_cast<T*>(p.dk) + n * p.dk_sn + h * p.dk_sh,
                        p.dk_ss, b0, p.sk, p.d, vec);
  store_rows<T, DP, NT>(smem + C::kOutTile, dv, 1.0f,
                        static_cast<T*>(p.dv) + n * p.dv_sn + h * p.dv_sh, p.dv_ss, b0, p.sk, p.d,
                        vec);
}

// ---------------------------------------------------------------------------
// dQ: the block's rows are queries, the walked tiles are keys and values.
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kThreads, 1)
    fused_attention_bwd_dq_kernel(const BwdParams p) {
  using C = Cfg<T, DP>;
  constexpr bool kF32 = C::kF32;
  constexpr int W = C::kWalk;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  // the block's queries and their dO rows (fp32: big and small halves)
  T* Qb = reinterpret_cast<T*>(smem);
  T* dOb = reinterpret_cast<T*>(smem + (kF32 ? 2 : 1) * C::kRowTile);
  T* Qs = kF32 ? reinterpret_cast<T*>(smem + C::kRowTile) : Qb;
  T* dOs = kF32 ? reinterpret_cast<T*>(smem + 3 * C::kRowTile) : dOb;
  // the ring: [kStages][raw K, raw V], then [2][Mask]
  unsigned char* ring = smem + (kF32 ? 4 : 2) * C::kRowTile;
  // fp32: K in halves and transposed halves, V in halves
  float* conv = reinterpret_cast<float*>(ring + C::kRing);
  constexpr int kWalkF = W * DP;
  float *Kb = conv, *Ks = conv + kWalkF, *KTb = conv + 2 * kWalkF, *KTs = conv + 3 * kWalkF;
  float *Vb = conv + 4 * kWalkF, *Vs = conv + 5 * kWalkF;

  constexpr int NT = C::kThreads;
  const int tid = threadIdx.x, wgi = tid >> 7, lane = tid & 31, t4 = lane & 3;
  const long long n = blockIdx.z, h = blockIdx.y;
  const int b0 = blockIdx.x * C::kBlockRows;  // the block's queries
  const int q0 = b0 + kRows * wgi;            // this warpgroup's queries
  const int row_lo = 16 * ((tid >> 5) & 3) + (lane >> 2);
  const bool vec = p.vec != 0;

  const T* qg = static_cast<const T*>(p.q) + n * p.q_sn + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + n * p.k_sn + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + n * p.v_sn + h * p.v_sh;
  const T* dog = static_cast<const T*>(p.dout) + n * p.do_sn + h * p.do_sh;
  const long long at = (n * gridDim.y + h) * p.sq;
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

  const int n_tiles = (p.sk + W - 1) / W;
  load_stage(0);
  if constexpr (kF32) {
    cp_async_commit();
    load_split2<C::kBlockRows, DP, NT>(Qb, Qs, qg, p.q_ss, dOb, dOs, dog, p.do_ss, b0, p.sq, p.d,
                                       vec);
  } else {
    load_tile<T, C::kBlockRows, DP, NT>(Qb, qg, p.q_ss, b0, p.sq, p.d, vec);
    load_tile<T, C::kBlockRows, DP, NT>(dOb, dog, p.do_ss, b0, p.sq, p.d, vec);
    cp_async_commit();
  }

  // this thread's queries: row statistics and Di, fixed for the walk
  bool qvalid[2];
  float mr[2], lr[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + row_lo + 8 * hh;
    qvalid[hh] = qi < p.sq;
    mr[hh] = qvalid[hh] ? p.stats[at + qi] : 0.f;
    lr[hh] = qvalid[hh] ? p.stats[p.nhs + at + qi] : 0.f;
    dr[hh] = qvalid[hh] ? p.di[at + qi] : 0.f;
  }

  float dq[DP / 2];
  zero(dq);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * W;
    cp_async_wait_all();
    wg::fence_proxy_async();
    __syncthreads();
    const T *kb = raw(it, 0), *ks = kb, *ktb = kb, *kts = kb, *vb = raw(it, 1), *vs = vb;
    if constexpr (kF32) {
      split_tile<W, DP, true, NT>(raw(it, 0), Kb, Ks, KTb, KTs);
      split_tile<W, DP, false, NT>(raw(it, 1), Vb, Vs, nullptr, nullptr);
      wg::fence_proxy_async();
      __syncthreads();
      kb = Kb, ks = Ks, ktb = KTb, kts = KTs, vb = Vb, vs = Vs;
    }
    if (it + 1 < n_tiles) {
      load_stage(it + 1);
      cp_async_commit();
    }

    // S = Q K^T and dP = dO V^T: queries x keys
    float s[W / 2], dp[W / 2];
    zero(s);
    zero(dp);
    wg::fence();
    const int a_off = wgi * kRows * DP;  // this warpgroup's rows of the block's tiles
    mma_over_d<T, DP, W>(s, Qb + a_off, Qs + a_off, kb, ks);
    mma_over_d<T, DP, W>(dp, dOb + a_off, dOs + a_off, vb, vs);
    wg::commit();
    wg::wait_all();
    wg::keep(s);
    wg::keep(dp);

    const float* mv = mvals(it);
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
          const float pv =
              (kvalid && qvalid[hh]) ? exp2f(((x - mr[hh]) - lr[hh]) * kLog2e) : 0.f;
          dp[i] = pv * (dp[i] - dr[hh]);
        }
      }
    }

    // dQ += dS K
    Frags<T, W> dsa;
    dsa.make(dp);
    wg::fence();
    mma_over_walk<T, DP, W>(dq, dsa, ktb, kts);
    wg::commit();
    wg::wait_all();
    wg::keep(dq);
    dsa.keep();
    __syncthreads();
  }

  store_rows<T, DP, NT>(smem, dq, p.scale, static_cast<T*>(p.dq) + n * p.dq_sn + h * p.dq_sh,
                        p.dq_ss, b0, p.sq, p.d, vec);
}

// which: 0 = dK/dV, 1 = dQ
template <typename T, int DP>
cudaError_t launch(const BwdParams& p, int n, int h, int which, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  const int smem = C::smem_bytes(which == 0 ? kDkv : kDq);
  const int rows = which == 0 ? p.sk : p.sq;
  const dim3 grid((rows + C::kBlockRows - 1) / C::kBlockRows, h, n);
  static SmemLimit dkv_limit, dq_limit;
  cudaError_t err;
  if (which == 0) {
    err = dkv_limit.raise_once(fused_attention_bwd_dkv_kernel<T, DP>, smem);
    if (err != cudaSuccess) return err;
    fused_attention_bwd_dkv_kernel<T, DP><<<grid, C::kThreads, smem, stream>>>(p);
  } else {
    err = dq_limit.raise_once(fused_attention_bwd_dq_kernel<T, DP>, smem);
    if (err != cudaSuccess) return err;
    fused_attention_bwd_dq_kernel<T, DP><<<grid, C::kThreads, smem, stream>>>(p);
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
        const void* stats, const void* di, void* dq, void* dk, void* dv, int dtype, int n, int h,
        int sq, int sk, int d, const long long* strides, long long mask_sn, int causal,
        float scale, void* stream) {
  if (n < 1 || h < 1 || sq < 1 || sk < 1 || d < 1 || d > 128 || n > 65535 || h > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const float*>(mask);
  p.dout = dout;
  p.stats = static_cast<const float*>(stats);
  p.di = static_cast<const float*>(di);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.nhs = (long long)n * h * sq;
  long long* dst[21] = {&p.q_sn,  &p.q_sh,  &p.q_ss,  &p.k_sn,  &p.k_sh,  &p.k_ss,  &p.v_sn,
                        &p.v_sh,  &p.v_ss,  &p.do_sn, &p.do_sh, &p.do_ss, &p.dq_sn, &p.dq_sh,
                        &p.dq_ss, &p.dk_sn, &p.dk_sh, &p.dk_ss, &p.dv_sn, &p.dv_sh, &p.dv_ss};
  for (int i = 0; i < 21; ++i) *dst[i] = strides[i];
  p.mask_sn = mask_sn;
  p.causal = causal;
  p.scale = scale;
  // 16-byte copies and stores need every row to start on 16 bytes, and D
  // to fill whole chunks
  const long long item = dtype == 0 ? 4 : 2;
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) && aligned16(dq) &&
             aligned16(dk) && aligned16(dv) && (d * item) % 16 == 0;
  for (int i = 0; i < 21; ++i) vec = vec && (strides[i] * item) % 16 == 0;
  p.vec = vec ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch_dim<float>(p, n, h, which, s)
                                     : dispatch_dim<__nv_bfloat16>(p, n, h, which, s);
  return int(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 21 (n, h, s) element strides,
// in the order q, k, v, dout, dq, dk, dv.  stats: fp32 [2, N, H, Sq] (row
// max, log row sum), di: fp32 [N, H, Sq], both contiguous.  The dK/dV entry
// writes dk and dv (dq may be null); the dQ entry writes dq (dk and dv may
// be null).  Each returns a cudaError_t (0 on success): the launch's own
// error, read with cudaGetLastError right after.
extern "C" int paddle_fused_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* stats, const void* di, void* dq, void* dk, void* dv, int dtype, int n, int h,
    int sq, int sk, int d, const long long* strides, long long mask_sn, int causal, float scale,
    void* stream) {
  return run(0, q, k, v, mask, dout, stats, di, dq, dk, dv, dtype, n, h, sq, sk, d, strides,
             mask_sn, causal, scale, stream);
}

extern "C" int paddle_fused_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* stats, const void* di, void* dq, void* dk, void* dv, int dtype, int n, int h,
    int sq, int sk, int d, const long long* strides, long long mask_sn, int causal, float scale,
    void* stream) {
  return run(1, q, k, v, mask, dout, stats, di, dq, dk, dv, dtype, n, h, sq, sk, d, strides,
             mask_sn, causal, scale, stream);
}

namespace {
template <typename T, int DP>
void config_of(int which, int* out) {
  using C = Cfg<T, DP>;
  out[0] = C::kThreads;
  out[1] = C::kBlockRows;
  out[2] = C::kWalk;
  out[3] = C::smem_bytes(which == 0 ? kDkv : kDq);
}
}  // namespace

// The launch configuration of one instantiation, for reports: out[0..3] =
// threads a block, rows a block owns, rows a walked tile, dynamic shared
// memory bytes.  which: 0 = dK/dV, 1 = dQ; dtype as above; dp: the head dim.
extern "C" void paddle_fused_attention_bwd_config(int which, int dtype, int dp, int* out) {
  if (dtype == 0)
    dp <= 32 ? config_of<float, 32>(which, out)
             : dp <= 64 ? config_of<float, 64>(which, out) : config_of<float, 128>(which, out);
  else
    dp <= 32 ? config_of<__nv_bfloat16, 32>(which, out)
             : dp <= 64 ? config_of<__nv_bfloat16, 64>(which, out)
                        : config_of<__nv_bfloat16, 128>(which, out);
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
