// Hopper (sm_90a) building blocks of the fused attention kernels
// (fused_attention.cu: the forward; fused_attention_bwd.cu: dK/dV and dQ):
// the block configuration, the no-swizzle tile layout and its wgmma
// descriptors, cp.async copies, the 3xTF32 split of fp32 tiles, A
// fragments taken from an accumulator, the products over D and over the
// walked rows, and the epilogue's staged stores.
//
// Every kernel gives each warpgroup (128 threads) 64 rows, wgmma's M, and
// walks tiles of kWalk rows of the other operand.  Shared-memory tiles use
// wgmma's no-swizzle layout: core matrices of 8 rows x 16 bytes, 128
// contiguous bytes each (tile_off).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "fused_attention_common.cuh"
#include "wgmma_sm90.cuh"

namespace attn {

constexpr int kRows = 64;  // rows a warpgroup owns: wgmma's M

// Whether a pointer allows 16-byte copies and stores (null does).
inline bool aligned16(const void* ptr) {
  return ptr == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// The kernel a configuration sizes.
enum Kernel { kFwd, kDkv, kDq };

// Block shape and shared memory of the three kernels: the forward and dQ
// blocks own query rows and walk the key/value tiles, the dK/dV blocks own
// key rows and walk the query tiles.
template <typename T, int DP>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // warpgroups a block: fp32 at D <= 64 runs two, each with its own 64 rows,
  // which share the conversion of every walked tile (shared memory allows
  // no second one at D = 128, and bf16 has no conversion to share)
  static constexpr int kWG = kF32 && DP <= 64 ? 2 : 1;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kBlockRows = kRows * kWG;
  // rows of a walked tile: bounded by shared memory (fp32) and registers
  static constexpr int kWalk = kF32 && DP > 64 ? 16 : 32;
  static constexpr int kRowTile = kBlockRows * DP * int(sizeof(T));  // bytes
  static constexpr int kWalkTile = kWalk * DP * int(sizeof(T));
  // The ring of raw walked tiles: a stage holds two (forward and dQ: K and
  // V; dK/dV: Q and dO).  The load of tile it + 1 starts once tile it is in
  // shared memory (and, in fp32, converted) and runs while tile it
  // computes.  bf16 reads a stage with wgmma, so it keeps two; fp32 is done
  // with its stage once it is converted, so it keeps one.  Beside the
  // stages, two slots of kWalk floats of three per-row vectors (dK/dV: row
  // max, log row sum, Di; forward and dQ: Mask).
  static constexpr int kStages = kF32 ? 1 : 2;
  static constexpr int kStage = 2 * kWalkTile;
  static constexpr int kVecSlot = (3 * kWalk * 4 + 127) / 128 * 128;
  static constexpr int kRing = kStages * kStage + 2 * kVecSlot;
  // The block's own tiles (forward: Q; dK/dV: K and V; dQ: Q and dO), in
  // big and small halves in fp32, then the ring; fp32 then holds the
  // converted walked tiles (forward: K big and small, V's transpose big and
  // small; dK/dV: Q and dO, each big, small and both transposed; dQ: K big,
  // small and transposed, V big and small)
  static constexpr int own_tiles(Kernel k) { return k == kFwd ? 1 : 2; }
  static constexpr int conv_tiles(Kernel k) { return k == kFwd ? 4 : k == kDkv ? 8 : 6; }
  static constexpr int smem_bytes(Kernel k) {
    return kF32 ? 2 * own_tiles(k) * kRowTile + kRing + conv_tiles(k) * kWalkTile
                : own_tiles(k) * kRowTile + kRing;
  }
  // the epilogue stages each output through a [kBlockRows][DP + 8] tile
  static constexpr int kOutTile = kBlockRows * (DP + 8) * int(sizeof(T));
  static_assert(smem_bytes(kDkv) >= 2 * kOutTile && smem_bytes(kDq) >= kOutTile &&
                    smem_bytes(kFwd) >= kOutTile,
                "the epilogue's tiles must fit in the kernel's shared memory");
};

// Byte offset of element (r, c) of a [R][C] tile whose C runs along the
// 16-byte chunks (CE elements each): chunk (r, c / CE) sits at
// ((r / 8) * (C / CE) + c / CE) * 128 + (r % 8) * 16.
template <int C, int CE>
__device__ __forceinline__ int tile_off(int r, int c) {
  return (((r >> 3) * (C / CE) + c / CE) << 7) + ((r & 7) << 4) + (c % CE) * (16 / CE);
}

// Descriptor of k-step ks of a [R][C] tile read K-major (K along C): core
// matrices 128 bytes apart along K, (C / CE) * 128 apart along M or N; one
// step is 32 bytes of K (tf32 k8, bf16 k16).
template <int C, int CE>
__device__ __forceinline__ uint64_t desc_k(const void* tile, int ks) {
  return wg::desc(static_cast<const char*>(tile) + ks * 256, 128, (C / CE) * 128);
}

// Descriptor of k-step ks of a bf16 [R][C] tile read MN-major (K along R,
// N along C): one step is 16 rows.
template <int C>
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int ks) {
  return wg::desc(static_cast<const char*>(tile) + ks * 2 * (C / 8) * 128, (C / 8) * 128, 128);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + R) of a [S, d] matrix (row stride ss, unit column stride)
// into a [R][DP] tile as they are, zero past S and past d: cp.async where
// `vec`, plain loads otherwise.  Chunk i of the tile is byte 16 i; a warp's
// 32 chunks are 8 rows x 4 chunks, so a warp reads 64 contiguous bytes of
// each of 8 rows and writes 512 contiguous bytes.
template <typename T, int R, int DP, int NT>
__device__ __forceinline__ void load_tile(T* tile, const T* src, long long ss, int r0, int s,
                                          int d, bool vec) {
  constexpr int CE = 16 / int(sizeof(T));
  static_assert(R * DP / CE % NT == 0, "whole chunks a thread");
#pragma unroll
  for (int k = 0; k < R * DP / CE / NT; ++k) {
    const int i = threadIdx.x + k * NT, rest = i >> 3;
    const int row = r0 + (rest / (DP / CE)) * 8 + (i & 7), col = (rest % (DP / CE)) * CE;
    T* dst = tile + i * CE;
    if (vec) {
      const bool ok = row < s && col < d;
      cp_async16(dst, ok ? src + row * ss + col : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < CE; ++e)
        dst[e] = (row < s && col + e < d) ? src[row * ss + col + e] : from_float<T>(0.f);
    }
  }
}

// x = big + small: big is x with the 13 low mantissa bits cleared (an exact
// tf32 value), small = x - big (exact in fp32, at most 2^-10 |x|).  TF32
// wgmma reads small to 11 bits, so a 3xTF32 product keeps about 2^-20 of
// each term: fp32's accuracy to a few ulps.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Chunk i (4 floats) of rows [r0, r0 + R) of a [S, d] fp32 matrix, zero
// past S and past d, in load_tile's order.
template <int DP>
__device__ __forceinline__ float4 fetch4(const float* src, long long ss, int i, int r0, int s,
                                         int d, bool vec) {
  const int rest = i >> 3;
  const int row = r0 + (rest / (DP / 4)) * 8 + (i & 7), col = (rest % (DP / 4)) * 4;
  if (vec) return row < s && col < d ? *reinterpret_cast<const float4*>(src + row * ss + col)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = (row < s && col + e < d) ? src[row * ss + col + e] : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store_split(float* big, float* small, int i, float4 x) {
  uint4 b, sm;
  split_tf32(x.x, b.x, sm.x);
  split_tf32(x.y, b.y, sm.y);
  split_tf32(x.z, b.z, sm.z);
  split_tf32(x.w, b.w, sm.w);
  reinterpret_cast<uint4*>(big)[i] = b;
  reinterpret_cast<uint4*>(small)[i] = sm;
}

// Rows [r0, r0 + R) of two [S, d] fp32 matrices (the block's own rows,
// staged once) into the tf32 halves of two [R][DP] tiles.  The loads go out
// in batches of up to 8 chunks a matrix before any is split and stored, so
// up to 16 are in flight a thread.
template <int R, int DP, int NT>
__device__ __forceinline__ void load_split2(float* big0, float* small0, const float* src0,
                                            long long ss0, float* big1, float* small1,
                                            const float* src1, long long ss1, int r0, int s,
                                            int d, bool vec) {
  constexpr int kPer = R * DP / 4 / NT;  // chunks a thread, each matrix
  constexpr int kBatch = kPer < 8 ? kPer : 8;
  static_assert(kPer % kBatch == 0, "whole batches");
#pragma unroll 1
  for (int b0 = 0; b0 < kPer; b0 += kBatch) {
    float4 x0[kBatch], x1[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = threadIdx.x + (b0 + j) * NT;
      x0[j] = fetch4<DP>(src0, ss0, i, r0, s, d, vec);
      x1[j] = fetch4<DP>(src1, ss1, i, r0, s, d, vec);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = threadIdx.x + (b0 + j) * NT;
      store_split(big0, small0, i, x0[j]);
      store_split(big1, small1, i, x1[j]);
    }
  }
}

// A raw fp32 [R][DP] tile into its tf32 halves (same layout; not with
// kPlain false) and, with kTrans, into the halves of its transpose
// [DP][R].  In the transpose,
// walked row 8 a + r sits at column 8 a + (r / 2) + 4 (r % 2): the order
// that makes logical column c of a k8 step the walked row whose P or dS the
// accumulator fragment holds where TF32's A fragment wants column c.
template <int R, int DP, bool kTrans, int NT, bool kPlain = true>
__device__ __forceinline__ void split_tile(const float* raw, float* big, float* small, float* tbig,
                                           float* tsmall) {
  static_assert(R * DP / 4 % NT == 0, "whole chunks a thread");
#pragma unroll
  for (int k = 0; k < R * DP / 4 / NT; ++k) {
    const int i = threadIdx.x + k * NT;
    const float4 x = reinterpret_cast<const float4*>(raw)[i];
    uint4 b, sm;
    split_tf32(x.x, b.x, sm.x);
    split_tf32(x.y, b.y, sm.y);
    split_tf32(x.z, b.z, sm.z);
    split_tf32(x.w, b.w, sm.w);
    if constexpr (kPlain) {
      reinterpret_cast<uint4*>(big)[i] = b;
      reinterpret_cast<uint4*>(small)[i] = sm;
    }
    if constexpr (kTrans) {
      // chunk i is walked row `row`, columns 4 cc .. 4 cc + 3; in the
      // transpose column 4 cc + e of it is float `base + 4 e` (tile_off)
      const int rr = i & 7, rest = i >> 3, cc = rest % (DP / 4);
      const int row = (rest / (DP / 4)) * 8 + rr;
      const int pos = (row & ~7) | ((rr >> 1) + ((rr & 1) << 2));
      const int base = tile_off<R, 4>(4 * cc, pos) >> 2;
      // a warp's lanes are 8 rows x 4 chunks; in step e each lane writes
      // element (e + rot) % 4 of its chunk, so the 32 scalar stores of a
      // step fall on 32 banks
      const int rot = ((cc >> 1) & 1) + 2 * (rr & 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ee = (e + rot) & 3;
        const uint32_t bv = ee == 0 ? b.x : ee == 1 ? b.y : ee == 2 ? b.z : b.w;
        const uint32_t sv = ee == 0 ? sm.x : ee == 1 ? sm.y : ee == 2 ? sm.z : sm.w;
        tbig[base + 4 * ee] = __uint_as_float(bv);
        tsmall[base + 4 * ee] = __uint_as_float(sv);
      }
    }
  }
}

// The A fragments of the k-steps of a product over the walked rows, from
// the accumulator `acc` (m64 x n kWalk) that holds P or dS.  fp32: tf32
// big and small halves.  bf16: two bf16 halves with kTwo (the backward's P
// and dS), else one rounding (the forward's P), and `small` is unused.
template <typename T, int W, bool kTwo = true>
struct Frags {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kSmall = kF32 || kTwo;
  static constexpr int kSteps = W / (kF32 ? 8 : 16);
  uint32_t big[kSteps][4];
  uint32_t small[kSteps][4];

  __device__ __forceinline__ void make(const float (&acc)[W / 2]) {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if constexpr (kF32) {
        // TF32 A: (row, col t), (row + 8, t), (row, t + 4), (row + 8, t + 4);
        // the accumulator holds (row, 2t), (row, 2t + 1), (row + 8, 2t),
        // (row + 8, 2t + 1): see split_tile for the matching B order
        const int src[4] = {0, 2, 1, 3};
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(acc[4 * ks + src[r]], big[ks][r], small[ks][r]);
      } else {
        // bf16 A for k16 is the accumulator's two n8 blocks as they are:
        // big = bf16(x) and, with kTwo, small = bf16(x - big)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = acc[8 * ks + 2 * r], x1 = acc[8 * ks + 2 * r + 1];
          const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
          big[ks][r] = *reinterpret_cast<const uint32_t*>(&b);
          if constexpr (kTwo) {
            const __nv_bfloat162 sm =
                __floats2bfloat162_rn(x0 - __low2float(b), x1 - __high2float(b));
            small[ks][r] = *reinterpret_cast<const uint32_t*>(&sm);
          }
        }
      }
    }
  }
  __device__ __forceinline__ void keep() {
    wg::keep(big);
    if constexpr (kSmall) wg::keep(small);
  }
};

// acc (m64 x n W) = A (kRows x DP, K-major) . B^T (B: W x DP, K-major):
// the products over D.  fp32: 3xTF32 from the big and small halves.
template <typename T, int DP, int W>
__device__ __forceinline__ void mma_over_d(float (&acc)[W / 2], const T* a_big, const T* a_small,
                                           const T* b_big, const T* b_small) {
  constexpr int CE = 16 / int(sizeof(T));
#pragma unroll
  for (int ks = 0; ks < DP * int(sizeof(T)) / 32; ++ks) {
    const uint64_t ab = desc_k<DP, CE>(a_big, ks), bb = desc_k<DP, CE>(b_big, ks);
    if constexpr (std::is_same<T, float>::value) {
      wg::mma_ss_tf32<W>(acc, desc_k<DP, CE>(a_small, ks), bb, ks > 0);
      wg::mma_ss_tf32<W>(acc, ab, desc_k<DP, CE>(b_small, ks), 1);
      wg::mma_ss_tf32<W>(acc, ab, bb, 1);
    } else {
      wg::mma_ss_bf16<W, 0>(acc, ab, bb, ks > 0);
    }
  }
}

// acc (m64 x n DP) += A (fragments, kRows x W) . B, B over the W walked rows
// and DP columns: fp32 from the transposed halves [DP][W] (K-major), bf16
// from the tile as stored [W][DP] (MN-major).
template <typename T, int DP, int W, bool kTwo = true>
__device__ __forceinline__ void mma_over_walk(float (&acc)[DP / 2], const Frags<T, W, kTwo>& a,
                                              const T* b_big, const T* b_small) {
#pragma unroll
  for (int ks = 0; ks < Frags<T, W, kTwo>::kSteps; ++ks) {
    if constexpr (std::is_same<T, float>::value) {
      const uint64_t bb = desc_k<W, 4>(b_big, ks);
      wg::mma_rs_tf32<DP>(acc, a.small[ks], bb, 1);
      wg::mma_rs_tf32<DP>(acc, a.big[ks], desc_k<W, 4>(b_small, ks), 1);
      wg::mma_rs_tf32<DP>(acc, a.big[ks], bb, 1);
    } else {
      const uint64_t b = desc_mn<DP>(b_big, ks);
      if constexpr (kTwo) wg::mma_rs_bf16<DP, 1>(acc, a.small[ks], b, 1);
      wg::mma_rs_bf16<DP, 1>(acc, a.big[ks], b, 1);
    }
  }
}

// Rows [r0, r0 + NT / 2) of a [S, d] output from the accumulators `acc`
// (m64 x n DP each warpgroup, fragment layout) times `mul`: through the
// [NT / 2][DP + 8] tile `buf` in shared memory (the pad spreads the rows a
// warp writes over the banks), then 16-byte stores along the rows (plain
// ones where not `vec`).  Rows past S are not written.
template <typename T, int DP, int NT>
__device__ __forceinline__ void store_rows(unsigned char* buf, const float (&acc)[DP / 2], float mul,
                                           T* dst, long long ss, int r0, int s, int d, bool vec) {
  constexpr int CE = 16 / int(sizeof(T));
  constexpr int LD = DP + 8;
  constexpr int R = NT / 2;  // 64 rows a warpgroup
  T* tile = reinterpret_cast<T*>(buf);
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  const int row_lo = 16 * (threadIdx.x >> 5) + (lane >> 2);  // warpgroup w's rows: 64 w + ...
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      T* at = tile + (row_lo + 8 * hh) * LD + 8 * j + 2 * t4;
      const float x0 = acc[4 * j + 2 * hh] * mul, x1 = acc[4 * j + 2 * hh + 1] * mul;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(at) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x0, x1);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < R * DP / CE; i += NT) {
    const int r = i / (DP / CE), c = (i % (DP / CE)) * CE, row = r0 + r;
    if (row >= s || c >= d) continue;
    const T* src = tile + r * LD + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst + row * ss + c) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < CE && c + e < d; ++e) dst[row * ss + c + e] = src[e];
    }
  }
}

template <int M>
__device__ __forceinline__ void zero(float (&x)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = 0.f;
}

}  // namespace attn
