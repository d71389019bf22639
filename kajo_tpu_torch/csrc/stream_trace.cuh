// Device helpers of the streaming sphere trace, shared by K5/K6
// (stream_trace.cu) and the nearest-hit designs K7 (stream_trace_v1.cu), K8
// (stream_trace_v2.cu) and K9 (stream_trace_v3.cu): the ray record, the
// rigid and general sphere quadratics, the slab test of a block's box, and,
// for K7-K9, the staging of a block's records in shared memory (rigid
// records with their ray-independent term, see stage_blocks) and the strict
// nearest-hit scan of a staged block, which leaves a sphere before its
// roots where discr < 0 (quadratic_staged; K7 in two passes,
// nearest_in_rows).
//
// One copy on purpose, as kajo_tpu/ops/pallas/stream_trace.py keeps one
// _quadratic_rigid (:74), one _quadratic_general (:91) and one _slab_test
// (:118): every kernel must compute the same float operations in the same
// order, so that each equals its plain PyTorch version in
// kajo_tpu_torch/ops/stream_trace.py (quadratic_rigid, quadratic_general,
// _slab) to the bit, and the designs equal one another on rays near the
// scene. The sources build with -fmad=false (no multiply-add contraction)
// and without fast math.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kajo_stream {

constexpr int kSpheres = 128;  // spheres per packed block, one box each
constexpr int kFRigid = 4;     // cx, cy, cz, r2
constexpr int kFGeneral = 14;  // inv3 row-major (9), invt (3), r2, det
constexpr float BIG = 3.0e38f;

// PyTorch's minimum, maximum and clamp_min on the card: NaN propagates,
// otherwise fminf / fmaxf
__device__ __forceinline__ float tmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float tmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(x != x ? x : fmaxf(x, 0.0f)); }

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float d_dot_o, o2;  // rigid quadratic terms, summed left to right
};

// ray i of o, d [N, 3]; a thread without a ray keeps the zero ray
__device__ __forceinline__ Ray load_ray(const float* __restrict__ ray_o, const float* __restrict__ ray_d, int i,
                                        bool live) {
  Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    r.ox = ray_o[3 * i];
    r.oy = ray_o[3 * i + 1];
    r.oz = ray_o[3 * i + 2];
    r.dx = ray_d[3 * i];
    r.dy = ray_d[3 * i + 1];
    r.dz = ray_d[3 * i + 2];
  }
  r.d_dot_o = r.dx * r.ox + r.dy * r.oy + r.dz * r.oz;
  r.o2 = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  return r;
}

// the roots of the rigid quadratic from b, its constant term and discr
__device__ __forceinline__ bool rigid_roots(float b, float cq, float discr, float& t) {
  const float sq = safe_sqrt(discr);
  const float q = b < 0.0f ? (-b - sq) * 0.5f : (-b + sq) * 0.5f;
  const float t1 = cq / (q == 0.0f ? 1.0f : q);
  const float lo = tmin(q, t1);
  const float hi = tmax(q, t1);
  t = lo < 0.0f ? hi : lo;
  return discr >= 0.0f && hi >= 0.0f && q != 0.0f && t >= 0.0f;
}

// the rigid quadratic's b, constant term and discriminant; k is its
// ray-independent term cx*cx + cy*cy + cz*cz - r2
__device__ __forceinline__ void rigid_terms(float cx, float cy, float cz, float k, const Ray& r, float& b, float& cq,
                                            float& discr) {
  const float d_dot_c = r.dx * cx + r.dy * cy + r.dz * cz;
  const float o_dot_c = r.ox * cx + r.oy * cy + r.oz * cz;
  b = 2.0f * (r.d_dot_o - d_dot_c);
  cq = r.o2 - 2.0f * o_dot_c + k;
  discr = b * b - 4.0f * cq;
}

// world-space stable quadratic with a == 1 (|d| == 1)
__device__ __forceinline__ bool quadratic_rigid(const float* s, const Ray& r, float& t) {
  const float cx = s[0], cy = s[1], cz = s[2], r2 = s[3];
  float b, cq, discr;
  rigid_terms(cx, cy, cz, cx * cx + cy * cy + cz * cz - r2, r, b, cq, discr);
  return rigid_roots(b, cq, discr, t);
}

// the roots of the general quadratic from a, b, its constant term and discr
// -> the object-space t (scaled by det by the caller)
__device__ __forceinline__ bool general_roots(float a, float b, float cq, float discr, float& t_loc) {
  const float sq = safe_sqrt(discr);
  const float q = b < 0.0f ? (-b - sq) * 0.5f : (-b + sq) * 0.5f;
  const float t0 = q / (a == 0.0f ? 1.0f : a);
  const float t1 = cq / (q == 0.0f ? 1.0f : q);
  const float lo = tmin(t0, t1);
  const float hi = tmax(t0, t1);
  t_loc = lo < 0.0f ? hi : lo;
  return discr >= 0.0f && hi >= 0.0f && a != 0.0f && q != 0.0f;
}

// the general quadratic's a, b, constant term and discriminant
__device__ __forceinline__ void general_terms(const float* s, const Ray& r, float& a, float& b, float& cq,
                                              float& discr) {
  const float ox = s[0] * r.ox + s[1] * r.oy + s[2] * r.oz + s[9];
  const float oy = s[3] * r.ox + s[4] * r.oy + s[5] * r.oz + s[10];
  const float oz = s[6] * r.ox + s[7] * r.oy + s[8] * r.oz + s[11];
  const float dx = s[0] * r.dx + s[1] * r.dy + s[2] * r.dz;
  const float dy = s[3] * r.dx + s[4] * r.dy + s[5] * r.dz;
  const float dz = s[6] * r.dx + s[7] * r.dy + s[8] * r.dz;
  const float r2 = s[12];
  a = dx * dx + dy * dy + dz * dz;
  b = 2.0f * (dx * ox + dy * oy + dz * oz);
  cq = ox * ox + oy * oy + oz * oz - r2;
  discr = b * b - 4.0f * a * cq;
}

// object-space stable quadratic with det-scaled t
__device__ __forceinline__ bool quadratic_general(const float* s, const Ray& r, float& t) {
  float a, b, cq, discr, t_loc;
  general_terms(s, r, a, b, cq, discr);
  const bool roots = general_roots(a, b, cq, discr, t_loc);
  t = t_loc * s[13];
  return roots && t >= 0.0f;
}

template <bool RIGID>
__device__ __forceinline__ bool quadratic(const float* s, const Ray& r, float& t) {
  return RIGID ? quadratic_rigid(s, r, t) : quadratic_general(s, r, t);
}

// one axis of the slab test; inv = 1/d, or BIG where d == 0
__device__ __forceinline__ void slab_axis(float o, float d, float inv, float lo, float hi, float& t_enter,
                                          float& t_exit) {
  const bool inside = o >= lo && o <= hi;
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  float near = fminf(t0, t1);
  float far = fmaxf(t0, t1);
  if (d == 0.0f) {
    near = inside ? -BIG : BIG;
    far = inside ? BIG : -BIG;
  }
  t_enter = fmaxf(t_enter, near);
  t_exit = fminf(t_exit, far);
}

__device__ __forceinline__ float inv_dir(float d) { return d == 0.0f ? BIG : 1.0f / d; }

// Whether the ray enters box (lo3, hi3, min det, 0) below its live bound:
// t_enter times the box's min det lower-bounds any det-scaled hit distance
// in it (1 for rigid scenes). BIG, not inf, keeps 0 * (1/d) at 0 on a face.
__device__ __forceinline__ bool box_may_hit(const Ray& r, float ix, float iy, float iz, const float* box,
                                            float t_best) {
  float t_enter = 0.0f, t_exit = BIG;
  slab_axis(r.ox, r.dx, ix, box[0], box[3], t_enter, t_exit);
  slab_axis(r.oy, r.dy, iy, box[1], box[4], t_enter, t_exit);
  slab_axis(r.oz, r.dz, iz, box[2], box[5], t_enter, t_exit);
  return t_exit >= t_enter && t_enter * box[6] < t_best;
}

// K7-K9 stage a rigid record as (cx, cy, cz, k), k = cx*cx + cy*cy +
// cz*cz - r2: the ray-independent term quadratic_rigid adds as one
// parenthesised term, computed once a sphere with the same operations, so
// the same bits. A general record is staged as it is. Stage nb blocks,
// block j from packed block id(j), as nb * 128 consecutive staged records
// of dst, the CTA's threads striding over them (the caller synchronises).
template <bool RIGID, class Id>
__device__ __forceinline__ void stage_blocks(float* dst, const float* __restrict__ packed, int nb, Id id) {
  if constexpr (RIGID) {
    for (int k = threadIdx.x; k < nb * kSpheres; k += blockDim.x) {
      const float* s = packed + (static_cast<size_t>(id(k / kSpheres)) * kSpheres + k % kSpheres) * kFRigid;
      const float cx = s[0], cy = s[1], cz = s[2], r2 = s[3];
      float* out = dst + kFRigid * k;
      out[0] = cx;
      out[1] = cy;
      out[2] = cz;
      out[3] = cx * cx + cy * cy + cz * cz - r2;
    }
  } else {
    constexpr int per = kSpheres * kFGeneral;
    for (int k = threadIdx.x; k < nb * per; k += blockDim.x) {
      dst[k] = packed[static_cast<size_t>(id(k / per)) * per + k % per];
    }
  }
}

// quadratic<RIGID> on a staged record, leaving before the roots (an IEEE
// square root and one or two divisions) where discr >= 0 fails: the hit is
// valid only where it holds (a NaN discr fails it too) and t is not read
// otherwise, so the answer is quadratic's, bit for bit. A warp whose rays
// all miss a sphere, as most do most spheres, skips the roots.
template <bool RIGID>
__device__ __forceinline__ bool quadratic_staged(const float* s, const Ray& r, float& t) {
  if constexpr (RIGID) {
    float b, cq, discr;
    rigid_terms(s[0], s[1], s[2], s[3], r, b, cq, discr);
    if (!(discr >= 0.0f)) return false;
    return rigid_roots(b, cq, discr, t);
  } else {
    float a, b, cq, discr, t_loc;
    general_terms(s, r, a, b, cq, discr);
    if (!(discr >= 0.0f)) return false;
    const bool roots = general_roots(a, b, cq, discr, t_loc);
    t = t_loc * s[13];
    return roots && t >= 0.0f;
  }
}

// The strict in-order scan of one block staged by stage_blocks: a valid hit
// with t < t_best (strict, so the first row wins a tie) becomes t_best, and
// its packed row base + i the winner; for each of a thread's R rays (a
// thread without a ray keeps the zero ray and a t_best of 0, which no hit
// beats)
template <bool RIGID, int R>
__device__ __forceinline__ void nearest_in_staged(const float* sph, int32_t base, const Ray (&r)[R],
                                                  float (&t_best)[R], int32_t (&best)[R]) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  for (int i = 0; i < kSpheres; ++i) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float t;
      if (quadratic_staged<RIGID>(&sph[F * i], r[k], t) && t < t_best[k]) {
        t_best[k] = t;
        best[k] = base + i;
      }
    }
  }
}

// The discriminant of quadratic_staged's quadratic on a staged record (the
// same operations, so the same bits)
template <bool RIGID>
__device__ __forceinline__ float staged_discr(const float* s, const Ray& r) {
  float a, b, cq, discr;
  if constexpr (RIGID) {
    rigid_terms(s[0], s[1], s[2], s[3], r, b, cq, discr);
  } else {
    general_terms(s, r, a, b, cq, discr);
  }
  return discr;
}

// nearest_in_staged's scan of one ray over rows first, first + STRIDE, ...
// of one block, in two passes: every row's discriminant, a bit a row
// where discr >= 0 holds (no branch, so the loads and arithmetic of many
// rows overlap), then quadratic_staged on those rows alone, in row order,
// with the strict rule. A row where discr >= 0 fails is never a valid hit,
// so the answer is the in-order scan's, bit for bit; and a warp takes a
// row's roots as often as its busiest lane has such a row, not at every
// row where some lane of the warp has one.
template <bool RIGID, int STRIDE>
__device__ __forceinline__ void nearest_in_rows(const float* sph, int32_t base, int first, const Ray& r,
                                                float& t_best, int32_t& best) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  constexpr int N = kSpheres / STRIDE;  // rows a lane scans
  static_assert(kSpheres % STRIDE == 0 && N <= 32, "a lane's rows fit one 32-bit mask");
  unsigned rows = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (staged_discr<RIGID>(&sph[F * (first + k * STRIDE)], r) >= 0.0f) rows |= 1u << k;
  }
  while (rows) {
    const int i = first + (__ffs(rows) - 1) * STRIDE;
    rows &= rows - 1u;
    float t;
    if (quadratic_staged<RIGID>(&sph[F * i], r, t) && t < t_best) {
      t_best = t;
      best = base + i;
    }
  }
}

}  // namespace kajo_stream
