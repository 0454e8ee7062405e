// Dropout, training branch, for Hopper (sm_90a): one pass that reads X and
// writes Out and Mask, its random bits drawn in the kernel by a counter-based
// generator.
//
// Replaces what XLA fused on the TPU for the JAX package's `dropout` op (its
// ops/nn_ops.py:322-343: `jax.random.bernoulli` from the op's `seed` attr,
// then the `where`s of the two implementations).  That was no Pallas kernel,
// but written as torch ops the same function takes some 40 elementwise
// launches (the generator's 10 rounds in integer ops) and as many passes over
// memory; this kernel is one.
//
// What it computes, for X of n elements (fp32 or bf16, in row-major order):
//   (w0, w1, w2, w3) = Philox4x32-10(key = (seed, 0), counter = (g lo, g hi, 0, 0))
//                      for g = (offset + i) / 4 (Salmon et al., SC'11, "Random123";
//                      offset, any index >= 0, is that of X's first element in the
//                      global tensor a rank's slice of the batch is part of)
//   keep_i = (w_{(offset + i) mod 4} >> 8) < threshold     (threshold = round((1 - p) 2^24),
//                                                reckoned once on the host)
//   Out_i  = keep_i ? (upscale ? X_i / divisor : X_i) : 0   (divisor = 1 - p in
//                                                X's type; an IEEE division in
//                                                fp32, then rounded to X's type)
//   Mask_i = keep_i ? 1 : 0                      (in X's type)
// So the mask is a pure function of (seed, i): the generic vjp grad op, which
// runs the forward again, redraws the forward's mask, and a CUDA graph that
// captures the launch replays the same bits, with no generator state to
// carry.  The plain version (kernels/dropout.py) computes the same bits with
// torch's int64 ops, and the two agree bit for bit.
//
// What bounds it on an H100 SXM: bytes.  It reads X once and writes Out and
// Mask once, 3 n item bytes (item = 4 fp32, 2 bf16); the generator's 10
// rounds, two 32x32-bit products each, for 4 elements, are some 30 integer
// operations an element, far below the card's integer rate at 3.35 TB/s.
// At the LM's [64, 256, 2048] in bf16: 201 MB, 60 us.
//
// Design: a grid-stride loop over groups of 16 bytes of X (4 fp32 or 8 bf16
// elements, one or two Philox calls), each loaded and stored as one 16-byte
// access when X, Out and Mask are 16-byte aligned; the ragged last group and
// unaligned tensors go element by element.  An offset that is not a multiple
// of 4 shifts every group across a Philox boundary by the same s = offset mod
// 4: the kernel is instantiated for each s, so element j of a group takes word
// (s + j) mod 4 of call (s + j) / 4, both known at compile time, and a group
// makes one Philox call more than it would at s = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox4x32 multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // its key increments (Weyl)
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a torch cast does
}

struct Params {
  long long n;
  unsigned long long ctr0;  // offset / 4 (the shift, offset mod 4, is the kernel's kShift)
  uint32_t seed, threshold;
  float divisor;
  int upscale, vec;
};

template <typename T>
__device__ __forceinline__ void apply(T xv, uint32_t word, const Params& p, T* o, T* m) {
  const bool keep = (word >> 8) < p.threshold;
  const T zero = from_float<T>(0.f);
  *o = keep ? (p.upscale ? from_float<T>(__fdiv_rn(to_float(xv), p.divisor)) : xv) : zero;
  *m = keep ? from_float<T>(1.f) : zero;
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// One thread a group of kVec elements (16 bytes of X) at a time; element j of
// a group is global element offset + base + j, word (kShift + j) mod 4 of the
// group's call (kShift + j) / 4.
template <typename T, int kShift>
__global__ void __launch_bounds__(kThreads) dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                                                         T* __restrict__ mask, Params p) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kCalls = (kShift + kVec + 3) / 4;  // Philox calls a group
  const long long groups = (p.n + kVec - 1) / kVec;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    uint4 w[kCalls];
#pragma unroll
    for (int c = 0; c < kCalls; ++c) {
      // = (offset + g kVec) / 4 + c: kVec is a multiple of 4
      const unsigned long long ctr = p.ctr0 + (unsigned long long)g * (kVec / 4) + c;
      w[c] = philox4x32_10(make_uint4(uint32_t(ctr), uint32_t(ctr >> 32), 0u, 0u), p.seed, 0u);
    }
    const long long base = g * kVec;
    if (p.vec && base + kVec <= p.n) {
      const uint4 xraw = *reinterpret_cast<const uint4*>(x + base);
      uint4 oraw, mraw;
      const T* xe = reinterpret_cast<const T*>(&xraw);
      T* oe = reinterpret_cast<T*>(&oraw);
      T* me = reinterpret_cast<T*>(&mraw);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        apply(xe[j], word_of(w[(kShift + j) / 4], (kShift + j) % 4), p, oe + j, me + j);
      *reinterpret_cast<uint4*>(out + base) = oraw;
      *reinterpret_cast<uint4*>(mask + base) = mraw;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (base + j < p.n)
          apply(x[base + j], word_of(w[(kShift + j) / 4], (kShift + j) % 4), p, out + base + j,
                mask + base + j);
      }
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename T>
cudaError_t launch(const void* x, void* out, void* mask, const Params& p, int shift, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long groups = (p.n + kVec - 1) / kVec;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks an SM; the loop strides over the rest
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  T* mt = static_cast<T*>(mask);
  switch (shift) {
    case 0: dropout_kernel<T, 0><<<int(blocks), kThreads, 0, stream>>>(xt, ot, mt, p); break;
    case 1: dropout_kernel<T, 1><<<int(blocks), kThreads, 0, stream>>>(xt, ot, mt, p); break;
    case 2: dropout_kernel<T, 2><<<int(blocks), kThreads, 0, stream>>>(xt, ot, mt, p); break;
    default: dropout_kernel<T, 3><<<int(blocks), kThreads, 0, stream>>>(xt, ot, mt, p); break;
  }
  return cudaGetLastError();
}

}  // namespace

// x, out, mask: n contiguous elements of type dtype (0 fp32, 1 bf16); offset: the
// global index of x's first element.
// Returns a cudaError_t (0 on a successful launch).
extern "C" int paddle_dropout(const void* x, void* out, void* mask, long long n, long long offset,
                              int dtype, unsigned int seed, unsigned int threshold, int upscale,
                              float divisor, void* stream) {
  if (n < 1 || offset < 0 || (dtype != 0 && dtype != 1) || threshold > (1u << 24))
    return int(cudaErrorInvalidValue);
  Params p;
  p.n = n;
  p.ctr0 = (unsigned long long)offset / 4;
  p.seed = seed;
  p.threshold = threshold;
  p.divisor = divisor;
  p.upscale = upscale ? 1 : 0;
  p.vec = aligned16(x) && aligned16(out) && aligned16(mask) ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int shift = int(offset & 3);
  return int(dtype == 0 ? launch<float>(x, out, mask, p, shift, s)
                        : launch<__nv_bfloat16>(x, out, mask, p, shift, s));
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
