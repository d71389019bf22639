// K7 for Hopper (sm_90a): the V1 nearest-hit design of the streaming trace.
//
// Replaces the V1 kernel of kajo_tpu/ops/pallas/stream_trace.py
// (_build_kernel :141, launched at :465 by _nearest_fwd_impl when KERNEL_V4
// is off). Its function: rays (o, d [N, 3], a per-ray bound [N]) are cut
// into tiles of kTile consecutive rays; each tile walks a list of 128-sphere
// blocks of the packed scene of build_stream_scene (packed order, or a
// per-tile list: the frustum candidates or the near-to-far order that
// ops/stream_trace.py builds on the host). For each block, every ray of the
// tile slab-tests the block's box against its live t_best (t_enter times the
// block's min det); if ANY ray of the tile may hit, EVERY ray of the tile
// tests all 128 spheres with a strict t < t_best (the first packed row wins
// a tie). That missing per-ray gate is what sets V1 apart from K5. Out: t
// [N] (the bound where nothing beat it) and the packed row [N] (-1).
//
// The vote makes a ray's answer depend on the other rays of its tile where
// the quadratic is imprecise (origins ~1e4 units out, ROADMAP Queue 3), so
// the tile is part of the function: kTile here equals V1_TILE of
// ops/stream_trace.py, and the plain version nearest_v1_plain votes over the
// same tiles with the same lanes (only the call's rays; a partial last tile
// has no padding lanes). Kernel and plain version are then equal to the bit
// on every ray. kajo_tpu's tile is 4096 rays; on rays near the scene the
// answers do not depend on the tile.
//
// Design: one CTA per tile, one thread per ray. Per listed block, each
// thread's slab test, __syncthreads_or for the tile's verdict, then the CTA
// stages the block's records in shared memory (2 KB rigid, 7 KB general)
// and every thread scans them. The TPU's tail repeats of a list (which
// exist so Pallas elides a DMA) are gone: a list is block ids plus a count.
// What bounds it on this card is FP32 work, as for K5 (csrc/stream_trace.cu):
// the scene is 1.6 MB rigid at 100k spheres, read in microseconds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no fast math, no FMA contraction).

#include "stream_trace.cuh"

namespace {

using namespace kajo_stream;

constexpr int kTile = 128;  // rays per tile: one CTA, one thread per ray (V1_TILE)

template <bool RIGID>
__global__ void __launch_bounds__(kTile) nearest_v1(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                                                    const float* __restrict__ bound,
                                                    const float* __restrict__ packed,
                                                    const float* __restrict__ boxes,
                                                    const int32_t* __restrict__ order,
                                                    const int32_t* __restrict__ count, float* __restrict__ t_out,
                                                    int32_t* __restrict__ idx_out, int n, int n_blocks) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  __shared__ float sph[kSpheres * F];

  const int tile = blockIdx.x;
  const int ray = tile * kTile + threadIdx.x;
  const bool live = ray < n;
  const Ray r = load_ray(ray_o, ray_d, ray, live);
  float t_best = live ? bound[ray] : 0.0f;
  int32_t best = -1;
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
  // no list: every block in packed order
  const int32_t* list = order ? order + static_cast<size_t>(tile) * n_blocks : nullptr;
  const int steps = order ? count[tile] : n_blocks;

  for (int s = 0; s < steps; ++s) {
    const int blk = list ? list[s] : s;
    const bool may = live && box_may_hit(r, ix, iy, iz, boxes + 8 * blk, t_best);
    if (!__syncthreads_or(may)) continue;
    stage(sph, packed + static_cast<size_t>(blk) * kSpheres * F, kSpheres * F);
    __syncthreads();
    if (live) nearest_in_block<RIGID>(sph, blk * kSpheres, r, t_best, best);
    __syncthreads();  // the next staged block overwrites sph
  }

  if (live) {
    t_out[ray] = t_best;
    idx_out[ray] = best;
  }
}

}  // namespace

// K7: nearest hit over each tile's list of blocks -> t_out [n], idx_out [n]
// packed row or -1. order [ceil(n / kTile), n_blocks] int32 block ids, the
// first count[tile] of each row visited in order; order == nullptr visits
// every block in packed order. Returns cudaGetLastError() after the launch.
extern "C" int kajo_stream_nearest_v1(const float* o, const float* d, const float* bound, const float* packed,
                                      const float* boxes, const int32_t* order, const int32_t* count, float* t_out,
                                      int32_t* idx_out, int n, int n_blocks, int rigid, cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile);
  if (rigid) {
    nearest_v1<true><<<grid, kTile, 0, stream>>>(o, d, bound, packed, boxes, order, count, t_out, idx_out, n,
                                                 n_blocks);
  } else {
    nearest_v1<false><<<grid, kTile, 0, stream>>>(o, d, bound, packed, boxes, order, count, t_out, idx_out, n,
                                                  n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
