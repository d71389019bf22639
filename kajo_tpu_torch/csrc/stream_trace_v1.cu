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
// What bounds it on this card is FP32 work, as for K5 (csrc/stream_trace.cu):
// the scene is 1.6 MB rigid at 100k spheres, read in microseconds; the own
// bound of a config-5 call is 0.025-0.033 ms (PERF.md). The first design
// ran a tile in one CTA of 128 threads, one thread a ray: per listed block
// a dependent load of its id and box, a slab test and __syncthreads_or,
// and on a yes every thread scanned all 128 spheres with full roots (an
// IEEE square root and divisions on every sphere, though ~0.2% of the
// tests have discr >= 0). A call ended with its busiest tile (mean 15-20
// admitted blocks a tile, the busiest 105-136), one thread a ray walking
// ~29 us a block with 4 warps to hide latency: 3.0-4.0 ms a call.
//
// Design: one CTA per tile, kLanes = 8 lanes a ray (1024 threads). The
// vote stays the tile's: one __syncthreads_or over its 128 rays a block.
//  * Batched votes: the list is walked in chunks of kChunk = 32 entries.
//    One coalesced copy brings a chunk's block ids and boxes to shared
//    memory; each lane votes every eighth entry for its ray at the chunk's
//    first t_best, and the warps OR their bits into one mask. The vote is
//    monotone: box_may_hit is t_exit >= t_enter && t_enter * min det <
//    t_best, t_best only falls, and a NaN compares false both times, so a
//    block the mask refuses is one the live vote refuses too. Each block
//    of the mask is voted again at the live t_best before it is scanned,
//    so the blocks scanned are exactly those of the one-block-at-a-time
//    walk. The 782-step chain of packed order becomes 25 chunk votes.
//  * The scan of an admitted block: its records staged in shared memory
//    (rigid records with their ray-independent term, stage_blocks),
//    double-buffered, so two barriers a block; lane k scans rows k, k + 8,
//    ... in two passes (nearest_in_rows): the 16 discriminants first, with
//    no branch, then the roots of the rows where discr >= 0 alone, in row
//    order with the strict rule; three xor shuffles merge the lanes'
//    (t, row) lexicographically, which is the in-order scan's answer (as
//    K5's lanes do).
// On the config-5 calls (NVIDIA H100 80GB HBM3, 700 W; PERF.md) this took
// 0.37-0.55 ms a rigid call against the first design's 3.0-4.0, and the
// busiest tile alone is still 0.74-0.90 of a call at ~3.1-3.5 us a block.
// Without the batched votes it was 2.2-2.7x slower on the long lists, with
// the one-pass scan of K8 and K9 1.2-1.3x; 4 lanes a ray in CTAs of 512 (3
// an SM) were up to 1.7x slower on the heavy general calls; a cluster of 2
// CTAs a tile, each scanning half the rows and exchanging (t, row) through
// distributed shared memory, sped the busiest tile alone up to 1.3x but
// slowed the calls up to 1.2x (twice the CTAs no longer fit one wave). The
// TPU's tail repeats of a list (which exist so Pallas elides a DMA) are
// gone: a list is block ids plus a count.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no fast math, no FMA contraction).

#include "stream_trace.cuh"

namespace {

using namespace kajo_stream;

constexpr int kTile = 128;  // rays per tile: one CTA (V1_TILE)
constexpr int kLanes = 8;   // lanes that share one ray's scan of a block
constexpr int kThreads = kTile * kLanes;
constexpr int kChunk = 32;  // list entries voted together, a bit each
constexpr unsigned kFull = 0xFFFFFFFFu;

template <bool RIGID>
__global__ void __launch_bounds__(kThreads, 1) nearest_v1(const float* __restrict__ ray_o,
                                                          const float* __restrict__ ray_d,
                                                          const float* __restrict__ bound,
                                                          const float* __restrict__ packed,
                                                          const float* __restrict__ boxes,
                                                          const int32_t* __restrict__ order,
                                                          const int32_t* __restrict__ count,
                                                          float* __restrict__ t_out, int32_t* __restrict__ idx_out,
                                                          int n, int n_blocks) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  __shared__ __align__(16) float sph[2][kSpheres * F];  // double-buffered: no barrier after a scan

  const int tile = blockIdx.x;
  const int sub = threadIdx.x % kLanes;  // this lane's rows of a block: sub, sub + kLanes, ...
  const int ray = tile * kTile + threadIdx.x / kLanes;
  const bool live = ray < n;
  const Ray r = load_ray(ray_o, ray_d, ray, live);
  float t_best = live ? bound[ray] : 0.0f;
  int32_t best = -1;
  const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
  // no list: every block in packed order
  const int32_t* list = order ? order + static_cast<size_t>(tile) * n_blocks : nullptr;
  const int steps = order ? count[tile] : n_blocks;

  __shared__ float cbox[kChunk * 8];  // a chunk of the list: its boxes and block ids
  __shared__ int32_t cid[kChunk];
  __shared__ unsigned admit[2];  // the chunk's votes at its first t_best, a bit an entry, by chunk parity
  if (threadIdx.x < 2) admit[threadIdx.x] = 0u;

  int buf = 0;
  for (int c0 = 0, par = 0; c0 < steps; c0 += kChunk, par ^= 1) {
    const int nc = min(kChunk, steps - c0);
    if (threadIdx.x < 8 * nc) {
      const int j = threadIdx.x / 8;
      const int blk = list ? list[c0 + j] : c0 + j;
      cbox[threadIdx.x] = boxes[8 * blk + threadIdx.x % 8];
      if (threadIdx.x % 8 == 0) cid[j] = blk;
    }
    __syncthreads();
    // lane sub votes entries sub, sub + kLanes, ... of the chunk for its ray, at the chunk's first t_best
    unsigned m = 0u;
    if (live) {
      for (int j = sub; j < nc; j += kLanes) {
        if (box_may_hit(r, ix, iy, iz, cbox + 8 * j, t_best)) m |= 1u << j;
      }
    }
    m = __reduce_or_sync(kFull, m);
    if (threadIdx.x % 32 == 0 && m) atomicOr(&admit[par], m);
    __syncthreads();
    unsigned mask = admit[par];
    if (threadIdx.x == 0) admit[par ^ 1] = 0u;  // every thread read it before this chunk's first barrier
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1u;
      // the tile's vote at the live t_best; also no thread still scans the buffer staged two blocks ago
      const bool may = live && box_may_hit(r, ix, iy, iz, cbox + 8 * j, t_best);
      if (!__syncthreads_or(may)) continue;
      const int blk = cid[j];
      stage_blocks<RIGID>(sph[buf], packed, 1, [blk](int) { return blk; });
      __syncthreads();
      // this lane's strict in-order scan of its rows, from the ray's t_best
      float tc = t_best;
      int32_t rc = -1;
      nearest_in_rows<RIGID, kLanes>(sph[buf], blk * kSpheres, sub, r, tc, rc);
      // the lexicographic minimum of (t, row) over the ray's lanes; a lane
      // without a hit holds (t_best, -1), and any hit has t < t_best
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1) {
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
      buf ^= 1;
    }
  }

  if (live && sub == 0) {
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
    nearest_v1<true><<<grid, kThreads, 0, stream>>>(o, d, bound, packed, boxes, order, count, t_out, idx_out, n,
                                                     n_blocks);
  } else {
    nearest_v1<false><<<grid, kThreads, 0, stream>>>(o, d, bound, packed, boxes, order, count, t_out, idx_out, n,
                                                      n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
