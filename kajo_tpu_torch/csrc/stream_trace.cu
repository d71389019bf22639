// K5 and K6 for Hopper (sm_90a): the streaming sphere trace of big scenes.
//
// Replaces the V4 kernel of kajo_tpu/ops/pallas/stream_trace.py
// (_build_kernel_v4, launched by _v4_impl): K5 with occl=False, the nearest
// sphere hit behind nearest_sphere, and K6 with occl=True, the any-hit
// shadow test behind occluded_sphere. Both read rays (o, d [N, 3], a
// per-ray bound [N]) and the packed scene of build_stream_scene: 128-sphere
// blocks of rigid 4-float (cx, cy, cz, r2) or general 14-float (inv3, invt,
// r2, det) records in Morton order, whole blocks ordered front to back,
// with one box record per block (AABB lo3, hi3, min det, 0). The plain
// PyTorch versions are kajo_tpu_torch/ops/stream_trace.py:
// nearest_sphere_plain and occluded_sphere_plain, the same block order and
// box test; every float expression here is written in the same order as
// there, and -fmad=false keeps the two bit-equal on the card. (The box test
// is part of the function: for origins ~1e4 units outside the scene the
// quadratic's constant term loses its precision and reports hits on
// spheres the ray passes units away from, which the box test rejects.)
//
// K5: t_best starts at the ray's bound; a valid sphere hit with t < t_best
// (strict: the first packed row wins a tie) becomes the new t_best and its
// packed row the winner. Out: t_best [N] and the packed row [N] (-1 when
// nothing beat the bound).
// K6: a valid hit strictly below the bound, other than the ray's excluded
// packed row (the queried light), sets the bound to 0 for good. Out: the
// final bound [N] (0 = occluded).
//
// What bounds it on this card: FP32 work, not bytes. The rays and the
// packed scene (1.6 MB rigid at 100k spheres) are read once from device
// memory in a few microseconds at 3.35 TB/s; an exhaustive scan of 50k rays
// against 100k spheres is ~1.5e11 FP32 operations, some milliseconds at
// 67 TFLOP/s. So the design does less work instead of moving fewer bytes:
// one thread per ray, a CTA of 128 rays, and a loop over the blocks in
// packed (front-to-back) order. Each thread slab-tests the block's AABB
// against its live t_best (t_enter times the block's min det, so a
// det-scaled hit distance is never culled; BIG, not inf, so 0 * (1/d) stays
// 0 on a face); __syncthreads_or decides whether the CTA stages the block's
// records in shared memory (2 KB rigid, 7 KB general, read as a broadcast
// by every thread) and scans it; threads whose own test failed skip the
// scan. Front-to-back order shrinks t_best early, so most blocks behind a
// ray's first hit are culled. K6 leaves a block's scan at its first
// occluder and the whole loop once every ray of the CTA is occluded.
// (The TPU kernel's swapped grid, its superblock cull and ray-tile sizing
// are TPU schedules; a second cull level is later, measured work.)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no fast math, no FMA contraction).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRays = 128;     // rays per CTA, one per thread
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

// world-space stable quadratic with a == 1 (|d| == 1)
__device__ __forceinline__ bool quadratic_rigid(const float* s, const Ray& r, float& t) {
  const float cx = s[0], cy = s[1], cz = s[2], r2 = s[3];
  const float d_dot_c = r.dx * cx + r.dy * cy + r.dz * cz;
  const float o_dot_c = r.ox * cx + r.oy * cy + r.oz * cz;
  const float b = 2.0f * (r.d_dot_o - d_dot_c);
  const float cq = r.o2 - 2.0f * o_dot_c + (cx * cx + cy * cy + cz * cz - r2);
  const float discr = b * b - 4.0f * cq;
  const float sq = safe_sqrt(discr);
  const float q = b < 0.0f ? (-b - sq) * 0.5f : (-b + sq) * 0.5f;
  const float t1 = cq / (q == 0.0f ? 1.0f : q);
  const float lo = tmin(q, t1);
  const float hi = tmax(q, t1);
  t = lo < 0.0f ? hi : lo;
  return discr >= 0.0f && hi >= 0.0f && q != 0.0f && t >= 0.0f;
}

// object-space stable quadratic with det-scaled t
__device__ __forceinline__ bool quadratic_general(const float* s, const Ray& r, float& t) {
  const float ox = s[0] * r.ox + s[1] * r.oy + s[2] * r.oz + s[9];
  const float oy = s[3] * r.ox + s[4] * r.oy + s[5] * r.oz + s[10];
  const float oz = s[6] * r.ox + s[7] * r.oy + s[8] * r.oz + s[11];
  const float dx = s[0] * r.dx + s[1] * r.dy + s[2] * r.dz;
  const float dy = s[3] * r.dx + s[4] * r.dy + s[5] * r.dz;
  const float dz = s[6] * r.dx + s[7] * r.dy + s[8] * r.dz;
  const float r2 = s[12], det = s[13];
  const float a = dx * dx + dy * dy + dz * dz;
  const float b = 2.0f * (dx * ox + dy * oy + dz * oz);
  const float cq = ox * ox + oy * oy + oz * oz - r2;
  const float discr = b * b - 4.0f * a * cq;
  const float sq = safe_sqrt(discr);
  const float q = b < 0.0f ? (-b - sq) * 0.5f : (-b + sq) * 0.5f;
  const float t0 = q / (a == 0.0f ? 1.0f : a);
  const float t1 = cq / (q == 0.0f ? 1.0f : q);
  const float lo = tmin(t0, t1);
  const float hi = tmax(t0, t1);
  const float t_loc = lo < 0.0f ? hi : lo;
  t = t_loc * det;
  return discr >= 0.0f && hi >= 0.0f && a != 0.0f && q != 0.0f && t >= 0.0f;
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

template <bool RIGID, bool OCCL>
__global__ void __launch_bounds__(kRays) stream_kernel(const float* __restrict__ ray_o,
                                                        const float* __restrict__ ray_d,
                                                        const float* __restrict__ bound,
                                                        const float* __restrict__ packed,
                                                        const float* __restrict__ boxes,
                                                        const int32_t* __restrict__ excl_in,
                                                        float* __restrict__ t_out,
                                                        int32_t* __restrict__ idx_out, int n, int n_blocks) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  __shared__ float sph[kSpheres * F];

  const int ray = blockIdx.x * kRays + threadIdx.x;
  const bool live = ray < n;
  Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float t_best = 0.0f;  // a dead thread is "occluded" and never needs a block
  int32_t best = -1;
  int32_t excl = -1;
  if (live) {
    r.ox = ray_o[3 * ray];
    r.oy = ray_o[3 * ray + 1];
    r.oz = ray_o[3 * ray + 2];
    r.dx = ray_d[3 * ray];
    r.dy = ray_d[3 * ray + 1];
    r.dz = ray_d[3 * ray + 2];
    t_best = bound[ray];
    if (OCCL) excl = excl_in[ray];
  }
  r.d_dot_o = r.dx * r.ox + r.dy * r.oy + r.dz * r.oz;
  r.o2 = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);

  for (int blk = 0; blk < n_blocks; ++blk) {
    if (OCCL && __syncthreads_and(t_best == 0.0f)) break;  // every ray occluded
    const float* box = boxes + 8 * blk;
    bool may = false;
    if (live) {
      float t_enter = 0.0f, t_exit = BIG;
      slab_axis(r.ox, r.dx, ix, box[0], box[3], t_enter, t_exit);
      slab_axis(r.oy, r.dy, iy, box[1], box[4], t_enter, t_exit);
      slab_axis(r.oz, r.dz, iz, box[2], box[5], t_enter, t_exit);
      // slot 6: the block's min det, a lower bound on det-scaled distances
      may = t_exit >= t_enter && t_enter * box[6] < t_best;
    }
    if (!__syncthreads_or(may)) continue;

    const float* src = packed + static_cast<size_t>(blk) * kSpheres * F;
    for (int k = threadIdx.x; k < kSpheres * F; k += kRays) sph[k] = src[k];
    __syncthreads();
    if (may) {
      const int32_t base = blk * kSpheres;
      for (int i = 0; i < kSpheres; ++i) {
        float t;
        const bool valid = RIGID ? quadratic_rigid(&sph[F * i], r, t) : quadratic_general(&sph[F * i], r, t);
        if (OCCL) {
          if (valid && t < t_best && base + i != excl) {
            t_best = 0.0f;  // sticky: t >= 0 never beats 0
            break;
          }
        } else if (valid && t < t_best) {
          t_best = t;
          best = base + i;
        }
      }
    }
    __syncthreads();  // the next staged block overwrites sph
  }

  if (live) {
    t_out[ray] = t_best;
    if (!OCCL) idx_out[ray] = best;
  }
}

template <bool OCCL>
int launch(const float* o, const float* d, const float* bound, const float* packed, const float* boxes,
           const int32_t* excl, float* t_out, int32_t* idx_out, int n, int n_blocks, int rigid,
           cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kRays - 1) / kRays);
  if (rigid) {
    stream_kernel<true, OCCL><<<grid, kRays, 0, stream>>>(o, d, bound, packed, boxes, excl, t_out, idx_out, n,
                                                          n_blocks);
  } else {
    stream_kernel<false, OCCL><<<grid, kRays, 0, stream>>>(o, d, bound, packed, boxes, excl, t_out, idx_out, n,
                                                           n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5: nearest hit -> t_out [n] (the bound where nothing beat it), idx_out
// [n] packed row or -1. Returns cudaGetLastError() after the launch.
extern "C" int kajo_stream_nearest(const float* o, const float* d, const float* bound, const float* packed,
                                   const float* boxes, float* t_out, int32_t* idx_out, int n, int n_blocks,
                                   int rigid, cudaStream_t stream) {
  return launch<false>(o, d, bound, packed, boxes, nullptr, t_out, idx_out, n, n_blocks, rigid, stream);
}

// K6: any-hit occlusion below the bound, packed row excl [n] skipped ->
// t_out [n] the final bound (0 = occluded).
extern "C" int kajo_stream_occluded(const float* o, const float* d, const float* t_cut, const float* packed,
                                    const float* boxes, float* t_out, const int32_t* excl, int n, int n_blocks,
                                    int rigid, cudaStream_t stream) {
  return launch<true>(o, d, t_cut, packed, boxes, excl, t_out, nullptr, n, n_blocks, rigid, stream);
}
