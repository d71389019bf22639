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
// 512 rays. The vote is sequential: candidate s is scanned iff some ray
// passes its test against the t_best left by candidates 0..s-1, so the
// candidates cannot be split between independent CTAs without changing
// the far rays' answers.
//
// What bounds it on this card: FP32 work, as for K5. The first design ran a
// tile in one CTA, one thread a ray, and staged and scanned a candidate's 8
// blocks in turn: one SM walked the tile's whole chain of candidates, and
// every call took ~23 ms whatever its number of tiles.
//
// Design: a thread-block cluster of kCluster CTAs a tile, a thread kRays
// rays in each. Per candidate, every CTA of the cluster computes the same vote
// (the same rays, the same t_best, the same superblock; __syncthreads_or);
// on a yes, CTA k stages blocks k * kPer .. (k + 1) * kPer - 1 of the
// superblock (rigid records with their ray-independent term, see
// stage_blocks) and scans them for all the tile's rays from the ray's
// t_best, with the strict rule and the early exit of quadratic_staged. The
// CTAs then exchange per-ray (t, row) through distributed shared memory
// (one cluster barrier, a double-buffered exchange), and every CTA takes
// the CTAs' answers in rank order, that is block order, where t < t_best
// (strict), as K5's lanes combine theirs: the in-order scan's answer, so
// every CTA holds the same t_best for the next vote. On the config-5 calls
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md) this took 3.0-3.3 ms a call
// against the first design's 23; clusters of 8 beat 4 and 2, 2 rays a thread
// beat 1 and 4, and the early exit and the staged rigid term gave ~2.3x and
// ~1.15x. kajo_tpu pads the scene to a multiple of 1024 spheres with
// unhittable rows; here the blocks past the scene's last are simply not
// scanned (an unhittable row never wins).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no fast math, no FMA contraction).

#include <cooperative_groups.h>

#include "stream_trace.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace kajo_stream;

constexpr int kTile = 512;  // rays per tile (V2_TILE), in each CTA of its cluster
constexpr int kRays = 2;    // rays a thread
constexpr int kThreads = kTile / kRays;
constexpr int kChunks = 8;   // 128-sphere blocks per superblock (V2_SUPER / 128)
constexpr int kCluster = 8;  // CTAs a tile
constexpr int kPer = kChunks / kCluster;  // blocks of a superblock per CTA
static_assert(kChunks % kCluster == 0, "a superblock's blocks split evenly over the cluster");

template <bool RIGID>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    nearest_v2(const float* __restrict__ ray_o, const float* __restrict__ ray_d, const float* __restrict__ bound,
               const float* __restrict__ packed, const float* __restrict__ sboxes, const int32_t* __restrict__ cand,
               const int32_t* __restrict__ count, float* __restrict__ t_out, int32_t* __restrict__ idx_out, int n,
               int n_blocks, int n_super) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  __shared__ __align__(16) float sph[kPer * kSpheres * F];
  __shared__ float xt[2][kTile];  // this CTA's (t, row) per ray, double-buffered
  __shared__ int32_t xi[2][kTile];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / kCluster;
  Ray r[kRays];  // rays threadIdx.x + k * kThreads of the tile
  float t_best[kRays], ix[kRays], iy[kRays], iz[kRays];
  int32_t best[kRays];
  for (int k = 0; k < kRays; ++k) {
    const int ray = tile * kTile + threadIdx.x + k * kThreads;
    r[k] = load_ray(ray_o, ray_d, ray, ray < n);
    t_best[k] = ray < n ? bound[ray] : 0.0f;
    best[k] = -1;
    ix[k] = inv_dir(r[k].dx);
    iy[k] = inv_dir(r[k].dy);
    iz[k] = inv_dir(r[k].dz);
  }
  const int32_t* list = cand + static_cast<size_t>(tile) * n_super;

  int buf = 0;
  for (int s = 0; s < count[tile]; ++s) {
    const int sb = list[s];
    bool may = false;
    for (int k = 0; k < kRays; ++k) {
      const bool live = tile * kTile + threadIdx.x + k * kThreads < n;
      may = may || (live && box_may_hit(r[k], ix[k], iy[k], iz[k], sboxes + 8 * sb, t_best[k]));
    }
    if (!__syncthreads_or(may)) continue;  // the same verdict in every CTA of the cluster
    const int blk0 = sb * kChunks + rank * kPer;
    const int nb = max(0, min(kPer, n_blocks - blk0));  // none past the scene's last block
    stage_blocks<RIGID>(sph, packed, nb, [&](int j) { return blk0 + j; });
    __syncthreads();
    float t_mine[kRays];
    int32_t row_mine[kRays];
    for (int k = 0; k < kRays; ++k) {
      t_mine[k] = t_best[k];
      row_mine[k] = best[k];
    }
    for (int j = 0; j < nb; ++j) {
      nearest_in_staged<RIGID>(sph + j * kSpheres * F, (blk0 + j) * kSpheres, r, t_mine, row_mine);
    }
    for (int k = 0; k < kRays; ++k) {
      xt[buf][threadIdx.x + k * kThreads] = t_mine[k];
      xi[buf][threadIdx.x + k * kThreads] = row_mine[k];
    }
    cluster.sync();  // every CTA's answers written; also no CTA restages sph before all have scanned
    for (int c = 0; c < kCluster; ++c) {
      const float* their_t = cluster.map_shared_rank(&xt[buf][0], c);
      const int32_t* their_i = cluster.map_shared_rank(&xi[buf][0], c);
      for (int k = 0; k < kRays; ++k) {
        const float t = their_t[threadIdx.x + k * kThreads];
        if (t < t_best[k]) {
          t_best[k] = t;
          best[k] = their_i[threadIdx.x + k * kThreads];
        }
      }
    }
    buf ^= 1;  // a CTA writes this buffer again only after the next cluster barrier
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory

  for (int k = 0; k < kRays; ++k) {
    const int ray = tile * kTile + threadIdx.x + k * kThreads;
    if (ray < n && rank == 0) {
      t_out[ray] = t_best[k];
      idx_out[ray] = best[k];
    }
  }
}

}  // namespace

// K8: nearest hit over each tile's candidate superblocks -> t_out [n],
// idx_out [n] packed row or -1. sboxes [n_super, 8] (union lo3, hi3, min
// det, 0); cand [ceil(n / kTile), n_super] int32 superblock ids, the first
// count[tile] of each row visited in order. Returns cudaGetLastError()
// after the launch.
extern "C" int kajo_stream_nearest_v2(const float* o, const float* d, const float* bound, const float* packed,
                                      const float* sboxes, const int32_t* cand, const int32_t* count, float* t_out,
                                      int32_t* idx_out, int n, int n_blocks, int n_super, int rigid,
                                      cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile * kCluster);
  if (rigid) {
    nearest_v2<true><<<grid, kThreads, 0, stream>>>(o, d, bound, packed, sboxes, cand, count, t_out, idx_out, n,
                                                    n_blocks, n_super);
  } else {
    nearest_v2<false><<<grid, kThreads, 0, stream>>>(o, d, bound, packed, sboxes, cand, count, t_out, idx_out, n,
                                                     n_blocks, n_super);
  }
  return static_cast<int>(cudaGetLastError());
}
