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
// What bounds it on an H100 SXM: bytes at K = 1 to 4.  It reads the codes
// and scales of the positions t <= ts + K - 1 once (Dh + 4 bytes a position,
// K and V each) plus q, and writes ctx.  Its 2 K Dh multiply-adds a position,
// with two more operations to dequantize each code (a byte permute and a
// subtraction, once for all K queries), make K = 8 bound by issue on the
// fp32 pipes instead.
//
// Design (its choices measured on an H100 80GB HBM3 by chip_smoke.py, see PERF.md):
// * The positions of a (slot, head) may be split into C chunks (the
//   wrapper's split_plan: as many CTAs as keep about two on every SM, at
//   most 8, each with a tile for every warp), one CTA of 4 warps a chunk.
//   At the LM's 32 slots x 8 heads C is 1: the 256 CTAs already fill the
//   card, and every split measured slower (more waves of CTAs whose rings
//   fill shared memory).  With few slots the split fills the idle SMs.  A
//   chunk wholly above the last position read does no work.
// * Each warp owns every 4th tile of its CTA's chunk (32 positions, 64 at
//   K >= 4 and Dh <= 64) and keeps two tiles in flight: lane 0 issues one
//   1-D bulk copy (TMA) each for the tile's key codes and value codes,
//   contiguous in the cache, completing on the stage's mbarrier; the lanes
//   copy the scales with 4-byte cp.async (any T).  No warp waits for another
//   until the chunk's end.
// * Scores: a lane one or two positions, its key rows read from shared
//   memory in 16-byte pieces starting at a piece that rotates with the lane
//   (so the 8 lanes of each access hit 8 distinct bank groups), 4 codes a
//   32-bit word dequantized exactly by byte permutes (the byte b + 128 under
//   the exponent of 2^23).  q sits in shared memory in 16-dim pieces padded
//   to 20 floats, so the rotated reads of q are conflict-free too.  The
//   warp keeps its own online softmax in base 2 (running max a query,
//   lane-partial sums).
// * The weighted sum: a lane owns 4 output columns of one row group
//   (Dh / 4 lanes a value row, 128 / Dh rows at once), reads 4 value codes
//   a 32-bit load and the rows' K weights (softmax times value scale) from
//   the warp's shared memory, and keeps K x 4 accumulators in registers.
// * The 4 warps' partials (running max, sum, K x Dh accumulators) merge once
//   a chunk, in shared memory, in warp order.  With C > 1 the chunks'
//   partials merge in rank order at CTA rank 0 over the cluster's
//   distributed shared memory, in the same launch (a two-pass merge through
//   a workspace measured no faster, PERF.md).  Fixed orders: two launches
//   give the same bits.
// * One instantiation a verify width bucket (KMAX 1, 2, 4, 8) and head dim
//   (32, 64, 128); query rows j >= K are zeros and their scores masked.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSplitAlign = 32;  // positions: a chunk of the split plan is a multiple of this
constexpr int kMaxSplit = 8;  // CTAs a (slot, head): the portable cluster size

struct Params {
  const float* q;
  const int8_t* kc;
  const float* ks;
  const int8_t* vc;
  const float* vs;
  const int* ts;
  float* ctx;
  float scale_log2;  // the softmax scale times log2(e): scores and maxima are kept in base 2
  int K, H, T, C, chunk;
};

constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared memory of one CTA, in bytes from the start of the dynamic block.
template <int DH, int KMAX>
struct Layout {
  static constexpr int kRows = KMAX >= 4 && DH <= 64 ? 2 : 1;    // positions a lane scores a tile
  static constexpr int kTile = 32 * kRows;                       // positions a warp stages at once
  static constexpr int kStages = 2;                              // tiles in flight a warp
  static constexpr int kChunks = DH / 16;                        // 16-byte pieces a code row
  static constexpr int kQPitch = 20;                             // floats a 16-dim piece of q
  static constexpr int kV = kTile * DH;                          // value rows in a stage
  static constexpr int kKs = kV + kTile * DH;                    // key scales
  static constexpr int kVs = kKs + kTile * 4;                    // value scales
  static constexpr int kStage = kVs + kTile * 4;
  static constexpr int kPart = KMAX * DH + 2 * KMAX;             // floats: acc[KMAX][DH], m, l
  static constexpr int kBar = 0;                                 // uint64 mbarrier[kWarps][kStages]
  static constexpr int kQ = round16(kBar + kWarps * kStages * 8);  // float q[KMAX][kChunks][kQPitch]
  static constexpr int kW = kQ + KMAX * kChunks * kQPitch * 4;   // float w[kWarps][kTile][KMAX]
  static constexpr int kCta = kW + kWarps * kTile * KMAX * 4;    // the CTA's partial
  static constexpr int kRing = round16(kCta + kPart * 4);        // [kWarps][kStages] stages
  static constexpr int kBytes = kRing + kWarps * kStages * kStage;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects `bytes` from the bulk copies signalling `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four int8 codes (one 32-bit word) to floats, exactly: the byte b + 128 under
// the exponent of 2^23 is the float 2^23 + b + 128.
__device__ __forceinline__ void dequant4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Element (j, d) of n <= NMAX partials merged in order: the weighted
// accumulator A, the sum L and the max M.  A partial that saw no position
// has m = -inf and weighs 0 (never exp(-inf - -inf)).  The loops run to NMAX
// with the partials past n masked, so every partial's loads issue together.
template <int DH, int KMAX, int NMAX, typename PartOf>
__device__ __forceinline__ void merge_element(PartOf part_of, int n, int j, int d, float& A, float& Ls,
                                              float& M) {
  float m[NMAX], a[NMAX], l[NMAX];
#pragma unroll
  for (int r = 0; r < NMAX; ++r) {
    const float* pr = part_of(r < n ? r : 0);
    m[r] = r < n ? pr[KMAX * DH + j] : -INFINITY;
    a[r] = pr[j * DH + d];
    l[r] = pr[KMAX * DH + KMAX + j];
  }
  M = -INFINITY;
#pragma unroll
  for (int r = 0; r < NMAX; ++r) M = fmaxf(M, m[r]);
  A = 0.f;
  Ls = 0.f;
#pragma unroll
  for (int r = 0; r < NMAX; ++r) {
    if (m[r] != -INFINITY) {
      const float e = exp2f(m[r] - M);
      A = fmaf(e, a[r], A);
      Ls = fmaf(e, l[r], Ls);
    }
  }
}

template <int DH, int KMAX>
__global__ void __launch_bounds__(kThreads) decode_attention_split_kernel(Params p) {
  using L = Layout<DH, KMAX>;
  constexpr int G = DH / 4;        // lanes a value row in the weighted sum
  constexpr int R = 32 / G;        // value rows at once a warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_sh = reinterpret_cast<float*>(smem + L::kQ);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.K, H = p.H, T = p.T, C = p.C;
  const int rank = blockIdx.x % C;
  const long long sh = blockIdx.x / C;  // (slot, head) row of the cache
  const int s = int(sh / H), h = int(sh % H);
  const int t0 = min(p.ts[s], T - 1);
  const int t_last = min(t0 + K - 1, T - 1);
  const int c0 = rank * p.chunk;
  const int c_end = min(c0 + p.chunk, t_last + 1);  // this CTA reads [c0, c_end)
  constexpr int kTile = L::kTile;
  const int n_tiles = c_end > c0 ? (c_end - c0 + kTile - 1) / kTile : 0;
  const int n_mine = n_tiles > warp ? (n_tiles - 1 - warp) / kWarps + 1 : 0;

  unsigned char* ring = smem + L::kRing + warp * L::kStages * L::kStage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar) + warp * L::kStages;
  float* w_sh = reinterpret_cast<float*>(smem + L::kW) + warp * kTile * KMAX;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < L::kStages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // the warp's i-th tile into stage `stage`: its code rows are two
  // contiguous blocks, one bulk copy each, issued by lane 0 and completing
  // on the stage's mbarrier; the lanes copy a scale each (4-byte cp.async,
  // any T) in one group a call, empty or not, so the group counts agree
  auto issue = [&](int i, int stage) {
    if (i < n_mine) {
      const int base = c0 + (warp + kWarps * i) * kTile;
      const int nr = min(kTile, c_end - base);  // rows of the tile that are read
      unsigned char* st = ring + stage * L::kStage;
      const long long at = sh * T + base;  // the tile's first row of the cache
      if (lane == 0) {
        // this stage's last reads (generic) come before the copy's writes (async)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(bars + stage, 2 * nr * DH);
        bulk_copy(st, p.kc + at * DH, nr * DH, bars + stage);
        bulk_copy(st + L::kV, p.vc + at * DH, nr * DH, bars + stage);
      }
#pragma unroll
      for (int r = lane; r < kTile; r += 32) {
        if (r < nr) {
          cp_async4(st + L::kKs + r * 4, p.ks + at + r);
          cp_async4(st + L::kVs + r * 4, p.vs + at + r);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < L::kStages; ++i) issue(i, i);

  for (int i = tid; i < KMAX * DH; i += kThreads) {
    const int j = i / DH, d = i % DH;
    q_sh[(j * L::kChunks + d / 16) * L::kQPitch + d % 16] =
        j < K ? p.q[(((long long)s * K + j) * H + h) * DH + d] : 0.f;
  }
  __syncthreads();

  float m[KMAX], l[KMAX], acc[KMAX][4];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  const int cg_col = 4 * (lane % G), row0 = lane / G;

  // a lane's key row is read in 16-byte pieces starting at piece `rot`, so
  // the 8 lanes of each 16-byte shared-memory access hit 8 distinct bank
  // groups (the rows lie back to back, Dh bytes apart)
  constexpr int NC = L::kChunks;
  const int rot = (lane / (NC >= 8 ? 1 : 8 / NC)) % NC;

  for (int i = 0; i < n_mine; ++i) {
    mbar_wait(bars + i % L::kStages, (i / L::kStages) & 1);
    cp_async_wait<L::kStages - 1>();
    __syncwarp();
    const unsigned char* st = ring + (i % L::kStages) * L::kStage;
    const int base = c0 + (warp + kWarps * i) * kTile;
    const int nr = min(kTile, c_end - base);  // rows of this tile that are read

    // scores, a lane kRows positions (lane, lane + 32).  Each 16-dim piece
    // is summed apart before it joins the dot product (terms reach 1e4 when
    // q is large, so one chain of Dh terms would round more than a blocked
    // product does); at KMAX < 4, NP partial sums a piece break the chain of
    // dependent multiply-adds.  Rows past nr hold stale codes: their finite
    // scores are masked below
    constexpr int RL = L::kRows;
    constexpr int NP = KMAX >= 4 ? 1 : 4 / RL;
    float dot[RL][KMAX];
#pragma unroll
    for (int rr = 0; rr < RL; ++rr) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) dot[rr][j] = 0.f;
    }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = (cc + rot) & (NC - 1);
      float kf[RL][16];
#pragma unroll
      for (int rr = 0; rr < RL; ++rr) {
        const uint4 kw = *reinterpret_cast<const uint4*>(st + (lane + 32 * rr) * DH + 16 * c);
        dequant4(kw.x, kf[rr]);
        dequant4(kw.y, kf[rr] + 4);
        dequant4(kw.z, kf[rr] + 8);
        dequant4(kw.w, kf[rr] + 12);
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        const float* qc = q_sh + (j * NC + c) * L::kQPitch;
        float part[RL][NP];
#pragma unroll
        for (int rr = 0; rr < RL; ++rr) {
#pragma unroll
          for (int u = 0; u < NP; ++u) part[rr][u] = 0.f;
        }
#pragma unroll
        for (int e4 = 0; e4 < 16; e4 += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qc + e4);
#pragma unroll
          for (int rr = 0; rr < RL; ++rr) {
            float& a = part[rr][(e4 / 4) % NP];
            a = fmaf(qv.x, kf[rr][e4], a);
            a = fmaf(qv.y, kf[rr][e4 + 1], a);
            a = fmaf(qv.z, kf[rr][e4 + 2], a);
            a = fmaf(qv.w, kf[rr][e4 + 3], a);
          }
        }
#pragma unroll
        for (int rr = 0; rr < RL; ++rr) {
          float piece = part[rr][0];
#pragma unroll
          for (int u = 1; u < NP; ++u) piece += part[rr][u];
          dot[rr][j] += piece;
        }
      }
    }
    float kscale[RL], vscale[RL];
#pragma unroll
    for (int rr = 0; rr < RL; ++rr) {
      const int r = lane + 32 * rr;
      kscale[rr] = r < nr ? reinterpret_cast<const float*>(st + L::kKs)[r] * p.scale_log2 : 0.f;
      vscale[rr] = r < nr ? reinterpret_cast<const float*>(st + L::kVs)[r] : 0.f;
    }

    // the warp's online softmax; the weights of this tile's rows to shared memory
    float alpha[KMAX], wrow[RL][KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const int last = min(t0 + j, T - 1);
      float sc[RL], mx = -INFINITY;
#pragma unroll
      for (int rr = 0; rr < RL; ++rr) {
        const int r = lane + 32 * rr;
        sc[rr] = (r < nr && j < K && base + r <= last) ? dot[rr][j] * kscale[rr] : -INFINITY;
        mx = fmaxf(mx, sc[rr]);
      }
      const float mn = fmaxf(m[j], warp_max(mx));
      alpha[j] = (mn == -INFINITY) ? 1.f : exp2f(m[j] - mn);
      float lj = l[j] * alpha[j];
#pragma unroll
      for (int rr = 0; rr < RL; ++rr) {
        const float pj = sc[rr] == -INFINITY ? 0.f : exp2f(sc[rr] - mn);
        lj += pj;
        wrow[rr][j] = pj * vscale[rr];
      }
      l[j] = lj;
      m[j] = mn;
    }
#pragma unroll
    for (int rr = 0; rr < RL; ++rr) {
      float* wr = w_sh + (lane + 32 * rr) * KMAX;
      if constexpr (KMAX % 4 == 0) {
#pragma unroll
        for (int j = 0; j < KMAX; j += 4)
          *reinterpret_cast<float4*>(wr + j) = make_float4(wrow[rr][j], wrow[rr][j + 1], wrow[rr][j + 2],
                                                           wrow[rr][j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) wr[j] = wrow[rr][j];
      }
    }
    __syncwarp();

    // the weighted sum: 4 columns a lane, R rows at once
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[j];
    }
    const unsigned char* vrows = st + L::kV + cg_col;
#pragma unroll 4
    for (int r = row0; r < nr; r += R) {
      float v[4];
      dequant4(*reinterpret_cast<const uint32_t*>(vrows + r * DH), v);
      float wv[KMAX];
      if constexpr (KMAX % 4 == 0) {
#pragma unroll
        for (int j = 0; j < KMAX; j += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(w_sh + r * KMAX + j);
          wv[j] = w4.x;
          wv[j + 1] = w4.y;
          wv[j + 2] = w4.z;
          wv[j + 3] = w4.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) wv[j] = w_sh[r * KMAX + j];
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(wv[j], v[e], acc[j][e]);
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
    issue(i + L::kStages, i % L::kStages);
  }
  cp_async_wait<0>();

  // the warp's partial, into its own ring: sums over lanes and row groups
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    l[j] = warp_sum(l[j]);
#pragma unroll
    for (int o = G; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
    }
  }
  __syncwarp();
  float* wpart = reinterpret_cast<float*>(ring);
  if (row0 == 0) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      *reinterpret_cast<float4*>(wpart + j * DH + cg_col) = make_float4(acc[j][0], acc[j][1], acc[j][2],
                                                                        acc[j][3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      wpart[KMAX * DH + j] = m[j];
      wpart[KMAX * DH + KMAX + j] = l[j];
    }
  }
  __syncthreads();

  // the CTA's partial: its warps' merged in warp order
  auto warp_part = [&](int w) {
    return reinterpret_cast<const float*>(smem + L::kRing + w * L::kStages * L::kStage);
  };
  if (C == 1) {
    for (int i = tid; i < K * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      float A, Ls, M;
      merge_element<DH, KMAX, kWarps>(warp_part, kWarps, j, d, A, Ls, M);
      p.ctx[(((long long)s * K + j) * H + h) * DH + d] = A / Ls;
    }
    return;
  }
  float* cpart = reinterpret_cast<float*>(smem + L::kCta);
  for (int i = tid; i < KMAX * DH; i += kThreads) {
    const int j = i / DH, d = i % DH;
    float A, Ls, M;
    merge_element<DH, KMAX, kWarps>(warp_part, kWarps, j, d, A, Ls, M);
    cpart[i] = A;
    if (d == 0) {
      cpart[KMAX * DH + j] = M;
      cpart[KMAX * DH + KMAX + j] = Ls;
    }
  }

  // rank 0 merges the cluster's partials, in rank order, over distributed
  // shared memory; every CTA takes part in both syncs, so none exits while
  // rank 0 may still read its shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0) {
    auto rank_part = [&](int r) { return static_cast<const float*>(cluster.map_shared_rank(cpart, r)); };
    for (int i = tid; i < K * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      float A, Ls, M;
      merge_element<DH, KMAX, kMaxSplit>(rank_part, C, j, d, A, Ls, M);
      p.ctx[(((long long)s * K + j) * H + h) * DH + d] = A / Ls;
    }
  }
  cluster.sync();
}

template <int DH, int KMAX>
cudaError_t launch(const Params& p, int S, cudaStream_t stream) {
  using L = Layout<DH, KMAX>;
  static attn::SmemLimit limit;
  cudaError_t err = limit.raise_once(decode_attention_split_kernel<DH, KMAX>, L::kBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * p.H * p.C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (p.C > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, decode_attention_split_kernel<DH, KMAX>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t dispatch_dim(const Params& p, int S, int DH, cudaStream_t stream) {
  switch (DH) {
    case 32: return launch<32, KMAX>(p, S, stream);
    case 64: return launch<64, KMAX>(p, S, stream);
    case 128: return launch<128, KMAX>(p, S, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int kVerifyMax = 8;  // the widest verify this source serves

cudaError_t run(const float* q, const int8_t* kc, const float* ks, const int8_t* vc, const float* vs,
                const int* ts, float scale, int S, int K, int H, int T, int DH, int splits, int chunk,
                float* ctx, void* stream) {
  if (S < 1 || H < 1 || T < 1 || K < 1 || K > kVerifyMax) return cudaErrorInvalidValue;
  // the plan covers 0..T-1, each position once, in whole tiles
  if (splits < 1 || splits > kMaxSplit || chunk < 1 || chunk % kSplitAlign != 0 || (splits - 1) * chunk >= T ||
      splits * chunk < T)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kc = kc;
  p.ks = ks;
  p.vc = vc;
  p.vs = vs;
  p.ts = ts;
  p.ctx = ctx;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.K = K;
  p.H = H;
  p.T = T;
  p.C = splits;
  p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 1) return dispatch_dim<1>(p, S, DH, st);
  if (K == 2) return dispatch_dim<2>(p, S, DH, st);
  if (K <= 4) return dispatch_dim<4>(p, S, DH, st);
  return dispatch_dim<8>(p, S, DH, st);
}

}  // namespace

// The step's attention (one query a slot).  q, ctx: fp32 [S, 1, H, DH];
// k_codes, v_codes: int8 [S, H, T, DH], 16-byte aligned; k_scale, v_scale:
// fp32 [S, H, T]; ts: int32 [S].  DH is 32, 64 or 128.  The split plan:
// `splits` CTAs a (slot, head), each `chunk` positions (a multiple of 32;
// the plan covers 0..T-1, each position once), their partials merged over a
// thread-block cluster of `splits` CTAs.  Returns a cudaError_t.
extern "C" int paddle_decode_attention_int8_step(const float* q, const int8_t* k_codes, const float* k_scale,
                                                 const int8_t* v_codes, const float* v_scale, const int* ts,
                                                 float scale, int S, int H, int T, int DH, int splits,
                                                 int chunk, float* ctx, void* stream) {
  return int(run(q, k_codes, k_scale, v_codes, v_scale, ts, scale, S, 1, H, T, DH, splits, chunk, ctx, stream));
}

// The verify fn's attention (K queries a slot, query j at position ts + j),
// K <= 8, run by the instantiation for the next of 1, 2, 4, 8 at or above K;
// the layouts are the step's with K in place of 1.
extern "C" int paddle_decode_attention_int8_verify(const float* q, const int8_t* k_codes,
                                                   const float* k_scale, const int8_t* v_codes,
                                                   const float* v_scale, const int* ts, float scale, int S,
                                                   int K, int H, int T, int DH, int splits, int chunk,
                                                   float* ctx, void* stream) {
  return int(run(q, k_codes, k_scale, v_codes, v_scale, ts, scale, S, K, H, T, DH, splits, chunk, ctx, stream));
}

// The launch shape of the instantiation that serves K queries at head dim DH:
// out = {threads, positions a tile, tiles in flight a warp, dynamic shared
// memory bytes, the largest split}.
extern "C" void paddle_decode_attention_int8_config(int K, int DH, int* out) {
  const int kmax = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : 8;
  int bytes = 0, stages = 0, tile = 0;
#define PADDLE_B3_BYTES(D, KM) \
  if (DH == D && kmax == KM) \
    bytes = Layout<D, KM>::kBytes, stages = Layout<D, KM>::kStages, tile = Layout<D, KM>::kTile;
  PADDLE_B3_BYTES(32, 1) PADDLE_B3_BYTES(32, 2) PADDLE_B3_BYTES(32, 4) PADDLE_B3_BYTES(32, 8)
  PADDLE_B3_BYTES(64, 1) PADDLE_B3_BYTES(64, 2) PADDLE_B3_BYTES(64, 4) PADDLE_B3_BYTES(64, 8)
  PADDLE_B3_BYTES(128, 1) PADDLE_B3_BYTES(128, 2) PADDLE_B3_BYTES(128, 4) PADDLE_B3_BYTES(128, 8)
#undef PADDLE_B3_BYTES
  out[0] = kThreads;
  out[1] = tile;
  out[2] = stages;
  out[3] = bytes;
  out[4] = kMaxSplit;
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
