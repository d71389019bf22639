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
// The quadratics, the slab test, the staging and the nearest-hit scan of a
// block are the helpers of stream_trace.cuh, which K7-K9 share.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no fast math, no FMA contraction).

#include "stream_trace.cuh"

namespace {

using namespace kajo_stream;

constexpr int kRays = 128;  // rays per CTA, one per thread

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
  const Ray r = load_ray(ray_o, ray_d, ray, live);
  float t_best = live ? bound[ray] : 0.0f;  // a dead thread is "occluded" and never needs a block
  int32_t best = -1;
  const int32_t excl = OCCL && live ? excl_in[ray] : -1;
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);

  for (int blk = 0; blk < n_blocks; ++blk) {
    if (OCCL && __syncthreads_and(t_best == 0.0f)) break;  // every ray occluded
    const bool may = live && box_may_hit(r, ix, iy, iz, boxes + 8 * blk, t_best);
    if (!__syncthreads_or(may)) continue;

    stage(sph, packed + static_cast<size_t>(blk) * kSpheres * F, kSpheres * F);
    __syncthreads();
    if (may) {
      const int32_t base = blk * kSpheres;
      if (OCCL) {
        for (int i = 0; i < kSpheres; ++i) {
          float t;
          if (quadratic<RIGID>(&sph[F * i], r, t) && t < t_best && base + i != excl) {
            t_best = 0.0f;  // sticky: t >= 0 never beats 0
            break;
          }
        }
      } else {
        nearest_in_block<RIGID>(sph, base, r, t_best, best);
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
