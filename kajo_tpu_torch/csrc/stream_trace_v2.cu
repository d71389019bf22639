// K8 for Hopper (sm_90a): the V2 nearest-hit design of the streaming trace.
//
// Replaces the V2 kernel of kajo_tpu/ops/pallas/stream_trace.py
// (_build_kernel_v2 :516, launched at :710 by _nearest_v2_impl when
// KERNEL_V2 is on). Its function: the packed scene of build_stream_scene is
// cut into superblocks of kChunks consecutive 128-sphere blocks (1024
// spheres), each with the union box of its blocks and their min det. Rays
// (o, d [N, 3], a per-ray bound [N]) are cut into tiles of kTile
// consecutive rays; each tile walks its candidate superblocks near to far
// (the lists ops/stream_trace.py builds on the host: a reachability cull
// and a sort by distance from the tile's mean origin). Per candidate, every
// ray of the tile slab-tests the superblock's box against its live t_best;
// if ANY ray may hit, EVERY ray of the tile tests the superblock's blocks in
// order, strict t < t_best. That equals V2's per-128-chunk minimum with the
// lowest lane on ties. Out: t [N] (the bound where nothing beat it), packed
// row [N] (-1).
//
// The tile is part of the function (ROADMAP Queue 3: for rays ~1e4 units
// out the vote decides hits), so kTile equals V2_TILE of
// ops/stream_trace.py and nearest_v2_plain votes over the same tiles and
// lanes (a partial last tile has no padding lanes); kajo_tpu's tile is also
// 512 rays.
//
// Design: one CTA per tile, one thread per ray. Per candidate, each
// thread's slab test and __syncthreads_or; on a yes the CTA stages the
// superblock one 128-sphere block at a time (7 KB general records, rather
// than 57 KB for the whole superblock, above the 48 KB default of shared
// memory) and every thread scans each. kajo_tpu pads the scene to a
// multiple of 1024 spheres with unhittable rows; here the blocks past the
// scene's last are simply not scanned (an unhittable row never wins), and
// the TPU's lane-major copy of the scene and the tail repeats of the lists
// are gone. What bounds it on this card is FP32 work, as for K5.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no fast math, no FMA contraction).

#include "stream_trace.cuh"

namespace {

using namespace kajo_stream;

constexpr int kTile = 512;  // rays per tile: one CTA, one thread per ray (V2_TILE)
constexpr int kChunks = 8;  // 128-sphere blocks per superblock (V2_SUPER / 128)

template <bool RIGID>
__global__ void __launch_bounds__(kTile) nearest_v2(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                                                    const float* __restrict__ bound,
                                                    const float* __restrict__ packed,
                                                    const float* __restrict__ sboxes,
                                                    const int32_t* __restrict__ cand,
                                                    const int32_t* __restrict__ count, float* __restrict__ t_out,
                                                    int32_t* __restrict__ idx_out, int n, int n_blocks, int n_super) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  __shared__ float sph[kSpheres * F];

  const int tile = blockIdx.x;
  const int ray = tile * kTile + threadIdx.x;
  const bool live = ray < n;
  const Ray r = load_ray(ray_o, ray_d, ray, live);
  float t_best = live ? bound[ray] : 0.0f;
  int32_t best = -1;
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
  const int32_t* list = cand + static_cast<size_t>(tile) * n_super;

  for (int s = 0; s < count[tile]; ++s) {
    const int sb = list[s];
    const bool may = live && box_may_hit(r, ix, iy, iz, sboxes + 8 * sb, t_best);
    if (!__syncthreads_or(may)) continue;
    for (int c = 0; c < kChunks; ++c) {
      const int blk = sb * kChunks + c;
      if (blk >= n_blocks) break;  // past the scene's last block
      stage(sph, packed + static_cast<size_t>(blk) * kSpheres * F, kSpheres * F);
      __syncthreads();
      if (live) nearest_in_block<RIGID>(sph, blk * kSpheres, r, t_best, best);
      __syncthreads();  // the next staged block overwrites sph
    }
  }

  if (live) {
    t_out[ray] = t_best;
    idx_out[ray] = best;
  }
}

}  // namespace

// K8: nearest hit over each tile's candidate superblocks -> t_out [n],
// idx_out [n] packed row or -1. sboxes [n_super, 8] (union lo3, hi3, min
// det, 0); cand [ceil(n / kTile), n_super] int32 superblock ids, the first
// count[tile] of each row visited in order. Returns cudaGetLastError() after
// the launch.
extern "C" int kajo_stream_nearest_v2(const float* o, const float* d, const float* bound, const float* packed,
                                      const float* sboxes, const int32_t* cand, const int32_t* count, float* t_out,
                                      int32_t* idx_out, int n, int n_blocks, int n_super, int rigid,
                                      cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile);
  if (rigid) {
    nearest_v2<true><<<grid, kTile, 0, stream>>>(o, d, bound, packed, sboxes, cand, count, t_out, idx_out, n,
                                                 n_blocks, n_super);
  } else {
    nearest_v2<false><<<grid, kTile, 0, stream>>>(o, d, bound, packed, sboxes, cand, count, t_out, idx_out, n,
                                                  n_blocks, n_super);
  }
  return static_cast<int>(cudaGetLastError());
}
