// K9 for Hopper (sm_90a): the V3 nearest-hit design of the streaming trace.
//
// Replaces the V3 kernel of kajo_tpu/ops/pallas/stream_trace.py
// (_build_kernel_v3 :757, launched at :888 by _nearest_v3_impl when
// KERNEL_V3 is on and the packed scene is at most V3_RESIDENT_BYTES). Its
// function: rays (o, d [N, 3], a per-ray bound [N]) are cut into tiles of
// kTile consecutive rays. Per tile, from its live rays (d != 0): the box of
// the origins, the box of the directions and the largest bound. An interval
// slab test of (origin box x direction box x [0, largest bound)) against
// every 128-sphere block's box (:772-812; the lower bound scaled by the
// block's min det) marks the blocks some ray of the tile could hit; the
// marked blocks are then scanned in ascending order by EVERY ray of the
// tile, strict t < t_best (the first packed row wins a tie). No per-ray
// gate. Out: t [N] (the bound where nothing beat it), packed row [N] (-1).
//
// The tile is part of the function (its bounds decide the marks; for rays
// ~1e4 units out the quadratic reports hits the marks would have ruled out,
// ROADMAP Queue 3): kTile equals V3_TILE of ops/stream_trace.py, and
// nearest_v3_plain uses the same tiles and lanes (a partial last tile has
// no padding lanes). kajo_tpu's tile is also 512 rays.
//
// Design: one CTA per tile, one thread per ray. A CTA-wide min/max reduction
// (warp shuffles, then shared memory) gives the tile's bounds; the threads
// stride over the blocks' boxes and write one byte of mask each into
// dynamic shared memory (the scene's block count: 782 bytes at 100k
// spheres); then the CTA walks the mask, stages each marked block's records
// (2 KB rigid, 7 KB general) and every thread scans them. The TPU's padding
// of the boxes to a multiple of 8 was a layout artefact and is gone. The
// packed scene stays in device memory (1.6 MB rigid, 5.6 MB general at
// 100k spheres; the card's L2 holds it). What bounds it on this card is
// FP32 work, as for K5.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no fast math, no FMA contraction).

#include "stream_trace.cuh"

namespace {

using namespace kajo_stream;

constexpr int kTile = 512;  // rays per tile: one CTA, one thread per ray (V3_TILE)
constexpr int kWarps = kTile / 32;
// the tile's bounds, all as minima: lo of o and d (0-5), minus hi of o and
// d (6-11), minus the largest bound (12)
constexpr int kBounds = 13;

// One axis of the interval slab test: crossing times of the box's two
// planes over every origin in [olo, ohi] and direction in [dlo, dhi];
// unbounded where the direction interval holds 0 (ops/stream_trace.py
// interval_div, the same operations in the same order) -> (max(near, 0), far).
__device__ __forceinline__ void axis_interval(float blo, float bhi, float olo, float ohi, float dlo, float dhi,
                                              float& near, float& far) {
  const bool c0 = dlo <= 0.0f && dhi >= 0.0f;
  const float sdl = c0 ? 1.0f : dlo;
  const float sdh = c0 ? 1.0f : dhi;
  const float n1l = blo - ohi, n1h = blo - olo;
  const float n2l = bhi - ohi, n2h = bhi - olo;
  const float q1l = fminf(fminf(n1l / sdl, n1l / sdh), fminf(n1h / sdl, n1h / sdh));
  const float q1h = fmaxf(fmaxf(n1l / sdl, n1l / sdh), fmaxf(n1h / sdl, n1h / sdh));
  const float q2l = fminf(fminf(n2l / sdl, n2l / sdh), fminf(n2h / sdl, n2h / sdh));
  const float q2h = fmaxf(fmaxf(n2l / sdl, n2l / sdh), fmaxf(n2h / sdl, n2h / sdh));
  near = fmaxf(c0 ? -BIG : fminf(q1l, q2l), 0.0f);
  far = c0 ? BIG : fmaxf(q1h, q2h);
}

template <bool RIGID>
__global__ void __launch_bounds__(kTile) nearest_v3(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                                                    const float* __restrict__ bound,
                                                    const float* __restrict__ packed,
                                                    const float* __restrict__ boxes, float* __restrict__ t_out,
                                                    int32_t* __restrict__ idx_out, int n, int n_blocks) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  __shared__ float sph[kSpheres * F];
  __shared__ float part[kWarps][kBounds];
  __shared__ float tile_bounds[kBounds];
  extern __shared__ unsigned char mask[];  // [n_blocks]

  const int ray = blockIdx.x * kTile + threadIdx.x;
  const bool in_call = ray < n;
  const Ray r = load_ray(ray_o, ray_d, ray, in_call);
  float t_best = in_call ? bound[ray] : 0.0f;
  int32_t best = -1;
  const bool live = in_call && (r.dx != 0.0f || r.dy != 0.0f || r.dz != 0.0f);

  // the tile's bounds over its live rays (min and max are exact in any order)
  float v[kBounds] = {r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, -r.ox, -r.oy, -r.oz, -r.dx, -r.dy, -r.dz, -t_best};
  for (int k = 0; k < kBounds; ++k) {
    if (!live) v[k] = k < 12 ? BIG : -0.0f;  // the largest bound of a tile without live rays is 0
    for (int off = 16; off > 0; off >>= 1) v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  }
  if (threadIdx.x % 32 == 0) {
    for (int k = 0; k < kBounds; ++k) part[threadIdx.x / 32][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < kBounds) {
    float m = part[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) m = fminf(m, part[w][threadIdx.x]);
    tile_bounds[threadIdx.x] = m;
  }
  __syncthreads();

  // every block's mark
  const float olo[3] = {tile_bounds[0], tile_bounds[1], tile_bounds[2]};
  const float dlo[3] = {tile_bounds[3], tile_bounds[4], tile_bounds[5]};
  const float ohi[3] = {-tile_bounds[6], -tile_bounds[7], -tile_bounds[8]};
  const float dhi[3] = {-tile_bounds[9], -tile_bounds[10], -tile_bounds[11]};
  const float tmx = -tile_bounds[12];
  for (int b = threadIdx.x; b < n_blocks; b += kTile) {
    const float* box = boxes + 8 * b;
    float lb = 0.0f, ub = BIG;
    for (int ax = 0; ax < 3; ++ax) {
      float near, far;
      axis_interval(box[ax], box[3 + ax], olo[ax], ohi[ax], dlo[ax], dhi[ax], near, far);
      lb = ax == 0 ? near : fmaxf(lb, near);
      ub = ax == 0 ? far : fminf(ub, far);
    }
    mask[b] = lb <= ub && lb * box[6] < tmx;
  }
  __syncthreads();

  for (int b = 0; b < n_blocks; ++b) {
    if (!mask[b]) continue;  // the same for every thread of the CTA
    stage(sph, packed + static_cast<size_t>(b) * kSpheres * F, kSpheres * F);
    __syncthreads();
    if (in_call) nearest_in_block<RIGID>(sph, b * kSpheres, r, t_best, best);
    __syncthreads();  // the next staged block overwrites sph
  }

  if (in_call) {
    t_out[ray] = t_best;
    idx_out[ray] = best;
  }
}

}  // namespace

// K9: nearest hit over each tile's marked blocks -> t_out [n], idx_out [n]
// packed row or -1; n_blocks bytes of dynamic shared memory per CTA (the
// wrapper keeps n_blocks within the 48 KB default). Returns
// cudaGetLastError() after the launch.
extern "C" int kajo_stream_nearest_v3(const float* o, const float* d, const float* bound, const float* packed,
                                      const float* boxes, float* t_out, int32_t* idx_out, int n, int n_blocks,
                                      int rigid, cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile);
  const size_t smem = static_cast<size_t>(n_blocks);
  if (rigid) {
    nearest_v3<true><<<grid, kTile, smem, stream>>>(o, d, bound, packed, boxes, t_out, idx_out, n, n_blocks);
  } else {
    nearest_v3<false><<<grid, kTile, smem, stream>>>(o, d, bound, packed, boxes, t_out, idx_out, n, n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
