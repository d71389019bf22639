// Order-independent float sums for the per-CTA gradient tables of K3
// (megakernel_grad.cu) and K4 (megakernel_geom.cu).
//
// The Pallas kernels sum their tables in a fixed order. Float atomics add in
// whatever order the threads arrive, so each cell's rounding, and with it the
// gradient's last bits, changed from run to run; an optimisation fed by those
// gradients (the inverse loop of kajo_tpu_torch/inverse_rendering.py, 100 Adam
// steps) then took another path on every run. Integer addition is
// associative: here a cell is a fixed-point number of unit 2^-kFrac held in
// kWords int64 words, every float goes in exactly (rounded to that unit on
// its own), so the cell holds the same sum whatever the order, and it is
// rounded to a float once, when the CTA writes its table. The sums are as
// close to the exact ones as the unit allows, closer than any float order.
//
// Word k of a cell has weight 2^(16 k - kFrac). A float m 2^e (m < 2^24)
// goes whole into the word whose 16 bits its lowest bit falls in: scaled by
// a power of two to that word's unit (exact) and converted to an int64
// (__float2ll_rn: exact, or rounded to even where it is finer than the
// unit), so it costs one 64-bit shared atomic, as a float atomic did (on
// sm_90 both are compare-and-swap loops). A lower word grows by less than
// 2^39 a value, so it holds 2^24 values of its cell before it can overflow,
// the top word (values of 2^23 and more) by less than 2^(24 + kTopShift);
// a CTA adds at most its items times an item's terms to a cell (K3's CTAs
// take at most 6,016 items at caustics 512x384, 16 spp). The range: values
// below half the unit add nothing; values of 2^(kTopShift + 24 + 64 - kFrac)
// = 2^47 and more count as an infinity of their sign. Infinities and NaNs
// set a flag word (atomicOr, also order-independent), so a cell that took
// one comes out NaN or +-inf as a float sum of the same values would.
// (PERF.md has the other layouts that were tried.)
//
// Build: included by the .cu files (nvcc -std=c++17, sm_90a).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace exact_sum {

constexpr int kFrac = 64;      // the unit is 2^-64
constexpr int kWords = 5;      // at bits 0, 16, 32, 48, 64 of the fixed point
constexpr int kTopShift = 23;  // the top word takes values m 2^(s - kFrac) for s - 64 <= 23: < 2^47 of its unit
constexpr int kInfPos = 1, kInfNeg = 2, kNaN = 4;

// Shared bytes of a table of n cells.
__host__ __device__ constexpr size_t bytes(int n) {
  return static_cast<size_t>(n) * (kWords * sizeof(unsigned long long) + sizeof(int));
}

// n cells in shared memory: their words, then their flags.
struct Table {
  unsigned long long* words;  // [n][kWords]
  int* flags;                 // [n]

  static __device__ Table at(void* smem, int n) {
    unsigned long long* w = static_cast<unsigned long long*>(smem);
    return {w, reinterpret_cast<int*>(w + static_cast<size_t>(n) * kWords)};
  }

  // zero the n cells, threads of the CTA together (the caller synchronises)
  __device__ void zero(int n) const {
    for (int i = threadIdx.x; i < n * kWords; i += blockDim.x) words[i] = 0ull;
    for (int i = threadIdx.x; i < n; i += blockDim.x) flags[i] = 0;
  }

  __device__ void add(int c, float v) const {
    const unsigned u = __float_as_uint(v);
    const int ex = static_cast<int>((u >> 23) & 0xffu);
    const int s = ex - 150 + kFrac;  // |v| = m 2^(s - kFrac), m < 2^24 (s < 0: finer than the unit)
    if (ex == 0xff || s > 64 + kTopShift) {
      atomicOr(flags + c, ex == 0xff && (u & 0x7fffffu) ? kNaN : ((u >> 31) ? kInfNeg : kInfPos));
      return;
    }
    const int k = s < 0 ? 0 : (s < 64 ? s >> 4 : 4);
    // v in units of word k: an integer below 2^39 (2^47 in the top word),
    // or rounded to one (to even) where v is finer than the unit; the
    // scaling by a power of two is exact
    const long long a = __float2ll_rn(v * __int_as_float((127 + kFrac - 16 * k) << 23));
    if (a) atomicAdd(words + static_cast<size_t>(c) * kWords + k, static_cast<unsigned long long>(a));
  }

  // the cell rounded to a float (after the CTA's last add and a barrier)
  __device__ float value(int c) const {
    const int f = flags[c];
    if ((f & kNaN) || (f & (kInfPos | kInfNeg)) == (kInfPos | kInfNeg)) return __uint_as_float(0x7fffffffu);
    if (f & kInfPos) return __uint_as_float(0x7f800000u);
    if (f & kInfNeg) return __uint_as_float(0xff800000u);
    long long l[kWords];
    for (int k = 0; k < kWords; ++k) l[k] = static_cast<long long>(words[static_cast<size_t>(c) * kWords + k]);
    for (int k = 0; k + 1 < kWords; ++k) {  // carries: the lower words to [0, 2^16), the sign in the top one
      l[k + 1] += l[k] >> 16;
      l[k] &= 0xffffll;
    }
    double x = 0.0;  // from the top: each term exact, one rounding a step
    for (int k = kWords - 1; k >= 0; --k) x += ldexp(static_cast<double>(l[k]), 16 * k - kFrac);
    return static_cast<float>(x);
  }
};

// Let `kernel` take `bytes` of dynamic shared memory (beyond 48 KB a kernel
// must opt in) -> a cudaError_t as int, 0 on success.
template <class K>
__host__ inline int allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace exact_sum
