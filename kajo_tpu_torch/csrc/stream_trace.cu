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
// K5: t_best starts at the ray's bound; blocks in packed order, each
// skipped for a ray whose own slab test against its live t_best fails;
// within a block, the lexicographic minimum of (t, packed row) over the
// valid hits with t < t_best (strict: the first packed row wins a tie)
// becomes t_best and its row the winner. Out: t_best [N] and the packed row
// [N] (-1 when nothing beat the bound).
// K6: a valid hit strictly below the bound, other than the ray's excluded
// packed row (the queried light), sets the bound to 0 for good. Out: the
// final bound [N] (0 = occluded).
//
// What bounds them on this card: FP32 work, not bytes. The rays and the
// packed scene (1.6 MB rigid at 100k spheres) are read once from device
// memory in a few microseconds at 3.35 TB/s; an exhaustive scan of 50k rays
// against 100k spheres is ~1.5e11 FP32 operations, some milliseconds at
// 67 TFLOP/s. The least work is each ray's own blocks: those it enters
// below its answer. What a kernel adds to that is the union a group of rays
// scans together, since a group runs a block while any of its rays needs
// it.
//
// The first design of both was one thread per ray, a CTA of 128
// rays deciding each block with __syncthreads_or and staging its records
// in shared memory: a block ran while any of 128 rays needed it, and every
// block cost two CTA barriers, even one the CTA skipped.
//
// K5 and K6 cut that union, leaving every ray's answer as it was:
//  * the group is a warp, not a CTA: __any_sync over 32 lanes decides a
//    block, and the records come through L1 with __ldg, the lanes that
//    read one row getting it as a broadcast, so no CTA barrier and no
//    staging. Each ray keeps its own box test and its own t_best.
//  * kLanesPerRay = 8 lanes per ray: lane k of a ray scans rows k, k + 8,
//    ... of the block with the strict rule, and three xor shuffles combine
//    the lanes' (t, row) lexicographically, which is exactly the strict
//    in-order scan's answer (torch.min over the block in the plain
//    version). A warp covers 4 consecutive rays of the call, so the union
//    it scans is over 4 rays, not 128, and a call has 8x the threads on
//    the card. On the config-5 calls (H100, PERF.md) 8 lanes per ray beat
//    2, 4, 16 and 32.
//  * the rays come in the caller's order: the wavefront's lanes walk the
//    image in 64-pixel tiles with a pixel's samples on adjacent lanes, so
//    consecutive rays already enter the same blocks. Sorting a call's rays
//    by direction octant and origin Morton cell in the wrapper gave larger
//    4- and 8-ray unions on the rigid calls and cost 0.4-0.7 ms a call
//    (PERF.md), so the kernel takes no permutation. A ray's answer depends
//    on no other ray, so any order gives the same answers.
// And it skips runs of kSuper = 8 blocks at once: before a run, each lane
// tests its ray against the run's superblock (the union box and the min
// det of its blocks, ops/stream_trace.py:v2_superblocks, built once per
// scene), and the warp skips the run when no lane enters it. That never
// skips a block the ray's own test would admit:
//  * float rounding is monotone, so for a containing box, per axis,
//    (lo_S - o) <= (lo_b - o) and (hi_S - o) >= (hi_b - o), and times the
//    same 1/d (either sign, infinities included) near_S <= near_b and
//    far_S >= far_b; hence t_enter_S <= t_enter_b and t_exit_S >= t_exit_b;
//  * where d == 0, o inside the block's slab is inside the superblock's,
//    so the superblock's (near, far) is (-BIG, BIG) whenever the block's
//    is, and otherwise the block's is (BIG, -BIG), which the block rejects;
//  * (lo - o) * (1/d) is NaN only for (lo - o) == 0 times an infinite 1/d
//    (|d| below 2^-128); fminf/fmaxf then drop the NaN in the block's test,
//    which could leave the block's far below the superblock's, so the
//    superblock test lets such an axis constrain nothing;
//  * min det_S <= det_b and t_enter >= 0, so t_enter_S * det_S <=
//    t_enter_b * det_b; and t_best only falls along the scan, so its value
//    at the run's start is >= its value at any block of the run.
// The visit order of the blocks does not change: a ray-dependent order
// would change which of two exactly equal t wins, and the far rays' box
// decisions.
//
// The quadratics, the slab test, the staging and the nearest-hit scan of a
// block are the helpers of stream_trace.cuh, which K7-K9 share.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no fast math, no FMA contraction).

#include "stream_trace.cuh"

namespace {

using namespace kajo_stream;

constexpr int kLanesPerRay = 8;   // K5: lanes that share one ray's scan of a block
constexpr int kOccLanes = 8;      // K6: lanes that share one ray's any-hit test of a block
constexpr int kThreads = 128;     // K5, K6: threads per CTA
constexpr int kSuper = 8;         // K5, K6: blocks per superblock (ops/stream_trace.py:V2_SUPER / 128)
constexpr unsigned kFull = 0xFFFFFFFFu;

// one axis of the superblock's slab test: slab_axis's operations, but an
// axis whose t0 or t1 is NaN constrains nothing (see the note at the top)
__device__ __forceinline__ void super_axis(float o, float d, float inv, float lo, float hi, float& t_enter,
                                           float& t_exit) {
  const bool inside = o >= lo && o <= hi;
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  float near = fminf(t0, t1);
  float far = fmaxf(t0, t1);
  if (t0 != t0 || t1 != t1) {
    near = -BIG;
    far = BIG;
  }
  if (d == 0.0f) {
    near = inside ? -BIG : BIG;
    far = inside ? BIG : -BIG;
  }
  t_enter = fmaxf(t_enter, near);
  t_exit = fminf(t_exit, far);
}

// whether the ray may enter a block of the superblock (lo3, hi3, min det, 0)
// below its live bound: never false where a member block's box_may_hit is true
__device__ __forceinline__ bool super_may_hit(const Ray& r, float ix, float iy, float iz, const float* box,
                                              float t_best) {
  float t_enter = 0.0f, t_exit = BIG;
  super_axis(r.ox, r.dx, ix, box[0], box[3], t_enter, t_exit);
  super_axis(r.oy, r.dy, iy, box[1], box[4], t_enter, t_exit);
  super_axis(r.oz, r.dz, iz, box[2], box[5], t_enter, t_exit);
  return t_exit >= t_enter && t_enter * box[6] < t_best;
}

// record `row` of the packed scene, read through L1 (the lanes of a warp
// that read one row get it as a broadcast)
template <bool RIGID>
__device__ __forceinline__ void load_record(const float* __restrict__ packed, int32_t row, float* s) {
  if (RIGID) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(packed) + row);
    s[0] = v.x;
    s[1] = v.y;
    s[2] = v.z;
    s[3] = v.w;
  } else {
#pragma unroll
    for (int f = 0; f < kFGeneral; ++f) s[f] = __ldg(packed + static_cast<size_t>(row) * kFGeneral + f);
  }
}

template <bool RIGID>
__global__ void __launch_bounds__(kThreads) nearest_kernel(const float* __restrict__ ray_o,
                                                            const float* __restrict__ ray_d,
                                                            const float* __restrict__ bound,
                                                            const float* __restrict__ packed,
                                                            const float* __restrict__ boxes,
                                                            const float* __restrict__ sboxes,
                                                            float* __restrict__ t_out,
                                                            int32_t* __restrict__ idx_out, int n, int n_blocks) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int ray = tid / kLanesPerRay;
  const int sub = tid % kLanesPerRay;  // this lane's rows of a block: sub, sub + 8, ...
  const bool live = ray < n;
  const Ray r = load_ray(ray_o, ray_d, ray, live);
  float t_best = live ? bound[ray] : 0.0f;  // a dead lane never needs a block
  int32_t best = -1;
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);

  for (int sb = 0; sb * kSuper < n_blocks; ++sb) {
    const bool may_s = live && super_may_hit(r, ix, iy, iz, sboxes + 8 * sb, t_best);
    if (!__any_sync(kFull, may_s)) continue;
    const int end = min(n_blocks, (sb + 1) * kSuper);
    for (int blk = sb * kSuper; blk < end; ++blk) {
      const bool may = live && box_may_hit(r, ix, iy, iz, boxes + 8 * blk, t_best);
      if (!__any_sync(kFull, may)) continue;
      // this lane's strict in-order scan of its rows, from the ray's t_best
      float tc = t_best;
      int32_t rc = -1;
      if (may) {
        const int32_t base = blk * kSpheres;
#pragma unroll 1  // unrolled, the rigid scan spilled 16 bytes at 40 registers, and ran no faster
        for (int i = sub; i < kSpheres; i += kLanesPerRay) {
          float rec[F];
          load_record<RIGID>(packed, base + i, rec);
          float t;
          if (quadratic<RIGID>(rec, r, t) && t < tc) {
            tc = t;
            rc = base + i;
          }
        }
      }
      // the lexicographic minimum of (t, row) over the ray's lanes; a lane
      // without a hit holds (t_best, -1), and any hit has t < t_best
#pragma unroll
      for (int off = 1; off < kLanesPerRay; off <<= 1) {
        const float t2 = __shfl_xor_sync(kFull, tc, off);
        const int32_t r2 = __shfl_xor_sync(kFull, rc, off);
        if (t2 < tc || (t2 == tc && r2 < rc)) {
          tc = t2;
          rc = r2;
        }
      }
      if (rc >= 0) {
        t_best = tc;
        best = rc;
      }
    }
  }

  if (live && sub == 0) {
    t_out[ray] = t_best;
    idx_out[ray] = best;
  }
}


// K6: nearest_kernel's warp, lanes and superblocks, for an any-hit answer.
// A ray's output is its cut or 0, and t_best only ever goes from the cut to
// 0, for good; so the ray is occluded exactly when some block whose box it
// enters below the cut holds a valid hit below the cut on a row other than
// excl (the superblock test never rejects such a block, by the argument
// above), and neither the order of the blocks, nor which lane finds the
// hit, nor a stop at the first one changes a bit. Lane k of a ray tests rows
// k, k + kOccLanes, ... of a block and stops at its first occluder; one
// ballot ORs the ray's lanes; the warp leaves the loop once all its rays
// are occluded (a ray with a zero cut, or a dead lane, counts from the
// start).
template <bool RIGID>
__global__ void __launch_bounds__(kThreads) occluded_kernel(const float* __restrict__ ray_o,
                                                             const float* __restrict__ ray_d,
                                                             const float* __restrict__ bound,
                                                             const float* __restrict__ packed,
                                                             const float* __restrict__ boxes,
                                                             const float* __restrict__ sboxes,
                                                             const int32_t* __restrict__ excl_in,
                                                             float* __restrict__ t_out, int n, int n_blocks) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  constexpr unsigned kRayMask = kOccLanes == 32 ? kFull : (1u << kOccLanes) - 1u;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int ray = tid / kOccLanes;
  const int sub = tid % kOccLanes;  // this lane's rows of a block: sub, sub + kOccLanes, ...
  const int first = (threadIdx.x & 31) & ~(kOccLanes - 1);  // the ray's first lane in the warp
  const bool live = ray < n;
  const Ray r = load_ray(ray_o, ray_d, ray, live);
  float t_best = live ? bound[ray] : 0.0f;  // a dead lane is "occluded" and never needs a block
  const int32_t excl = live ? excl_in[ray] : -1;
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);

  for (int sb = 0; sb * kSuper < n_blocks; ++sb) {
    if (__all_sync(kFull, t_best == 0.0f)) break;  // every ray of the warp occluded
    const bool may_s = live && super_may_hit(r, ix, iy, iz, sboxes + 8 * sb, t_best);
    if (!__any_sync(kFull, may_s)) continue;
    const int end = min(n_blocks, (sb + 1) * kSuper);
    for (int blk = sb * kSuper; blk < end; ++blk) {
      const bool may = live && box_may_hit(r, ix, iy, iz, boxes + 8 * blk, t_best);
      if (!__any_sync(kFull, may)) continue;
      bool hit = false;
      if (may) {
        const int32_t base = blk * kSpheres;
#pragma unroll 1
        for (int i = sub; i < kSpheres; i += kOccLanes) {
          float rec[F];
          load_record<RIGID>(packed, base + i, rec);
          float t;
          if (quadratic<RIGID>(rec, r, t) && t < t_best && base + i != excl) {
            hit = true;  // this lane's first occluder
            break;
          }
        }
      }
      const unsigned hits = __ballot_sync(kFull, hit);
      if (hits) {  // the same for every lane of the warp
        if ((hits >> first) & kRayMask) t_best = 0.0f;  // sticky: t >= 0 never beats 0
        if (__all_sync(kFull, t_best == 0.0f)) break;
      }
    }
  }

  if (live && sub == 0) t_out[ray] = t_best;
}

}  // namespace

// K5: nearest hit -> t_out [n] (the bound where nothing beat it), idx_out
// [n] packed row or -1; sboxes [ceil(n_blocks / 8), 8] are the superblocks.
// Returns cudaGetLastError() after the launch.
extern "C" int kajo_stream_nearest(const float* o, const float* d, const float* bound, const float* packed,
                                   const float* boxes, const float* sboxes, float* t_out, int32_t* idx_out, int n,
                                   int n_blocks, int rigid, cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(n) * kLanesPerRay + kThreads - 1) / kThreads));
  if (rigid) {
    nearest_kernel<true><<<grid, kThreads, 0, stream>>>(o, d, bound, packed, boxes, sboxes, t_out, idx_out, n,
                                                        n_blocks);
  } else {
    nearest_kernel<false><<<grid, kThreads, 0, stream>>>(o, d, bound, packed, boxes, sboxes, t_out, idx_out, n,
                                                         n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6: any-hit occlusion below the bound, packed row excl [n] skipped ->
// t_out [n] the final bound (0 = occluded); sboxes as for K5.
extern "C" int kajo_stream_occluded(const float* o, const float* d, const float* t_cut, const float* packed,
                                    const float* boxes, const float* sboxes, float* t_out, const int32_t* excl, int n,
                                    int n_blocks, int rigid, cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(n) * kOccLanes + kThreads - 1) / kThreads));
  if (rigid) {
    occluded_kernel<true><<<grid, kThreads, 0, stream>>>(o, d, t_cut, packed, boxes, sboxes, excl, t_out, n,
                                                         n_blocks);
  } else {
    occluded_kernel<false><<<grid, kThreads, 0, stream>>>(o, d, t_cut, packed, boxes, sboxes, excl, t_out, n,
                                                          n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
