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
// What bounds it on this card: FP32 work. With no per-ray gate a bounce
// call of config 5 (~26k rays, nearly all 782 blocks marked) is ~2.6e9
// sphere tests whatever the design. The first design ran a tile's whole
// scan in one CTA, one thread a ray: ~52 CTAs on 132 SMs, 26 ms.
//
// Design: the answer is the lexicographic minimum of (t, packed row) over
// the valid hits below the bound in the marked blocks, so the marked
// blocks can be cut into ranges scanned apart and the ranges' answers
// merged by that minimum. Three launches:
//  1. v3_marks, a CTA a tile: the tile's bounds (warp shuffles, then shared
//     memory), every block's mark, and the marked blocks' ids compacted in
//     ascending order (warp ballots) into the tile's row of a list in
//     device memory, with their count; each ray's key set to "no hit";
//  2. v3_scan, a CTA a (tile, range of kRange listed blocks), a thread kRays
//     rays of the tile: stages one block at a time in shared memory (rigid
//     records with their ray-independent term, see stage_blocks) and scans
//     it from the ray's bound with the strict rule and the early exit of
//     quadratic_staged; a ray that found a hit in the range takes one
//     64-bit atomicMin of hit_key(t, row) on its key. A CTA past its tile's
//     count exits at once;
//  3. v3_unpack, a thread a ray: the key back to (t, row), (bound, -1)
//     where no range found a hit.
// The key orders (t, row) as the in-order scan does: t's bits with -0.0
// read as +0.0 (a valid t is >= 0, where the bits order as the floats), then
// the row, then whether t was -0.0, so the winner keeps its own t bits. A hit
// reaches the key only if it beat the ray's bound (strict), so a hit equal
// to the bound never wins. Scratch: the lists (4 bytes a tile and block) and
// one 8-byte key a ray.
// Rays with d == 0 and the rays of a tile without live rays still scan every
// marked block; a tile without live rays marks none (largest bound 0). The
// packed scene stays in device memory (1.6 MB rigid, 5.6 MB general at 100k
// spheres; the card's L2 holds it). On the config-5 calls (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md) this took 0.6 / 2.9 ms (primary / bounce call)
// against the first design's 12 / 26; the early exit gave ~2.5x, the staged
// rigid term ~1.15x, 2 rays a thread 4-6%. Ranges of 4 blocks were 10%
// faster than 8 on the primary call and equal on the bounces; ranges of 16
// and 32 were slower on the primary call (32 was 5% faster on the bounces);
// 4 blocks staged a barrier were within 1.5% of 1 (all measured with a
// partial answer a range and an in-order merge in place of the keys).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no fast math, no FMA contraction).

#include "stream_trace.cuh"

namespace {

using namespace kajo_stream;

constexpr int kTile = 512;  // rays per tile: one thread per ray (V3_TILE)
constexpr int kWarps = kTile / 32;
constexpr int kRays = 2;  // rays a thread in v3_scan
constexpr int kScanThreads = kTile / kRays;
constexpr int kRange = 8;  // listed blocks a v3_scan CTA scans
constexpr int kUnpackThreads = 256;
constexpr unsigned long long kNoHit = ~0ull;  // NaN bits: no hit's key
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

__global__ void __launch_bounds__(kTile) v3_marks(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                                                  const float* __restrict__ bound, const float* __restrict__ boxes,
                                                  int32_t* __restrict__ list, int32_t* __restrict__ count,
                                                  unsigned long long* __restrict__ key, int n, int n_blocks) {
  __shared__ float part[kWarps][kBounds];
  __shared__ float tile_bounds[kBounds];
  __shared__ int warp_marks[kWarps];

  const int ray = blockIdx.x * kTile + threadIdx.x;
  const bool in_call = ray < n;
  const Ray r = load_ray(ray_o, ray_d, ray, in_call);
  const float t_best = in_call ? bound[ray] : 0.0f;
  const bool live = in_call && (r.dx != 0.0f || r.dy != 0.0f || r.dz != 0.0f);
  if (in_call) key[ray] = kNoHit;

  // the tile's bounds over its live rays (min and max are exact in any order)
  float v[kBounds] = {r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, -r.ox, -r.oy, -r.oz, -r.dx, -r.dy, -r.dz, -t_best};
  for (int k = 0; k < kBounds; ++k) {
    if (!live) v[k] = k < 12 ? BIG : -0.0f;  // the largest bound of a tile without live rays is 0
    for (int off = 16; off > 0; off >>= 1) v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    for (int k = 0; k < kBounds; ++k) part[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < kBounds) {
    float m = part[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) m = fminf(m, part[w][threadIdx.x]);
    tile_bounds[threadIdx.x] = m;
  }
  __syncthreads();

  // every block's mark; the marked ids in ascending order
  const float olo[3] = {tile_bounds[0], tile_bounds[1], tile_bounds[2]};
  const float dlo[3] = {tile_bounds[3], tile_bounds[4], tile_bounds[5]};
  const float ohi[3] = {-tile_bounds[6], -tile_bounds[7], -tile_bounds[8]};
  const float dhi[3] = {-tile_bounds[9], -tile_bounds[10], -tile_bounds[11]};
  const float tmx = -tile_bounds[12];
  int32_t* out = list + static_cast<size_t>(blockIdx.x) * n_blocks;
  int total = 0;  // the same in every thread
  for (int b0 = 0; b0 < n_blocks; b0 += kTile) {
    const int b = b0 + threadIdx.x;
    bool mark = false;
    if (b < n_blocks) {
      const float* box = boxes + 8 * b;
      float lb = 0.0f, ub = BIG;
      for (int ax = 0; ax < 3; ++ax) {
        float near, far;
        axis_interval(box[ax], box[3 + ax], olo[ax], ohi[ax], dlo[ax], dhi[ax], near, far);
        lb = ax == 0 ? near : fmaxf(lb, near);
        ub = ax == 0 ? far : fminf(ub, far);
      }
      mark = lb <= ub && lb * box[6] < tmx;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mark);
    if (lane == 0) warp_marks[warp] = __popc(ballot);
    __syncthreads();
    int at = total;
    for (int w = 0; w < warp; ++w) at += warp_marks[w];
    if (mark) out[at + __popc(ballot & ((1u << lane) - 1u))] = b;
    for (int w = 0; w < kWarps; ++w) total += warp_marks[w];
    __syncthreads();  // warp_marks is rewritten by the next round
  }
  if (threadIdx.x == 0) count[blockIdx.x] = total;
}

// (t, row) as one key whose unsigned order is the in-order scan's (above)
__device__ __forceinline__ unsigned long long hit_key(float t, int32_t row) {
  const uint32_t bits = __float_as_uint(t);
  const uint32_t neg_zero = bits >> 31;  // a valid t is >= 0: only -0.0 has the sign bit
  return (static_cast<unsigned long long>(neg_zero ? 0u : bits) << 32) |
         (static_cast<unsigned long long>(static_cast<uint32_t>(row)) << 1) | neg_zero;
}

template <bool RIGID>
__global__ void __launch_bounds__(kScanThreads) v3_scan(const float* __restrict__ ray_o,
                                                        const float* __restrict__ ray_d,
                                                        const float* __restrict__ bound,
                                                        const float* __restrict__ packed,
                                                        const int32_t* __restrict__ list,
                                                        const int32_t* __restrict__ count,
                                                        unsigned long long* __restrict__ key, int n, int n_blocks) {
  constexpr int F = RIGID ? kFRigid : kFGeneral;
  __shared__ __align__(16) float sph[kSpheres * F];

  const int tile = blockIdx.x;
  const int first = blockIdx.y * kRange;
  const int last = min(first + kRange, count[tile]);
  if (first >= last) return;  // past the tile's marked blocks: the same for the whole CTA
  const int32_t* ids = list + static_cast<size_t>(tile) * n_blocks;

  Ray r[kRays];  // rays threadIdx.x + k * kScanThreads of the tile
  float t_best[kRays];
  int32_t best[kRays];
  for (int k = 0; k < kRays; ++k) {
    const int ray = tile * kTile + threadIdx.x + k * kScanThreads;
    r[k] = load_ray(ray_o, ray_d, ray, ray < n);
    t_best[k] = ray < n ? bound[ray] : 0.0f;
    best[k] = -1;
  }
  for (int k0 = first; k0 < last; ++k0) {
    const int blk = ids[k0];
    stage_blocks<RIGID>(sph, packed, 1, [&](int) { return blk; });
    __syncthreads();
    nearest_in_staged<RIGID>(sph, blk * kSpheres, r, t_best, best);
    __syncthreads();  // the next staged block overwrites sph
  }
  for (int k = 0; k < kRays; ++k) {  // a thread without a ray found nothing below its 0
    if (best[k] >= 0) atomicMin(&key[tile * kTile + threadIdx.x + k * kScanThreads], hit_key(t_best[k], best[k]));
  }
}

__global__ void __launch_bounds__(kUnpackThreads) v3_unpack(const float* __restrict__ bound,
                                                            const unsigned long long* __restrict__ key,
                                                            float* __restrict__ t_out, int32_t* __restrict__ idx_out,
                                                            int n) {
  const int ray = blockIdx.x * kUnpackThreads + threadIdx.x;
  if (ray >= n) return;
  const unsigned long long k = key[ray];
  const bool hit = k != kNoHit;
  t_out[ray] = hit ? __uint_as_float(static_cast<uint32_t>(k >> 32) | (static_cast<uint32_t>(k & 1u) << 31))
                   : bound[ray];
  idx_out[ray] = hit ? static_cast<int32_t>(static_cast<uint32_t>(k) >> 1) : -1;
}

}  // namespace

// K9: nearest hit over each tile's marked blocks -> t_out [n], idx_out [n]
// packed row or -1. Scratch from the caller: list [ceil(n / kTile),
// n_blocks] and count [ceil(n / kTile)] int32, key [n] 64-bit. Returns the
// first cudaGetLastError() after the three launches that is not 0.
extern "C" int kajo_stream_nearest_v3(const float* o, const float* d, const float* bound, const float* packed,
                                      const float* boxes, int32_t* list, int32_t* count, unsigned long long* key,
                                      float* t_out, int32_t* idx_out, int n, int n_blocks, int rigid,
                                      cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n + kTile - 1) / kTile;
  v3_marks<<<n_tiles, kTile, 0, stream>>>(o, d, bound, boxes, list, count, key, n, n_blocks);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid(n_tiles, (n_blocks + kRange - 1) / kRange);
  if (rigid) {
    v3_scan<true><<<grid, kScanThreads, 0, stream>>>(o, d, bound, packed, list, count, key, n, n_blocks);
  } else {
    v3_scan<false><<<grid, kScanThreads, 0, stream>>>(o, d, bound, packed, list, count, key, n, n_blocks);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  v3_unpack<<<(n + kUnpackThreads - 1) / kUnpackThreads, kUnpackThreads, 0, stream>>>(bound, key, t_out, idx_out, n);
  return static_cast<int>(cudaGetLastError());
}
