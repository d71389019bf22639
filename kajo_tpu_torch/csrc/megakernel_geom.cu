// Sphere geometry gradients of the fused pass for Hopper (sm_90a): K4.
//
// Replaces kajo_tpu/ops/pallas/megakernel_geom.py:_build_geom_kernel (:124),
// the Pallas kernel behind geometry_grads (:923). A path's radiance depends
// on the geometry of the few distinct spheres it hits (visibility is discrete,
// so detached), so per lane and sample the function needs:
//  * the sample walked once on floats (csrc/walk.cuh), recording up to
//    TRACK_SLOTS = 8 distinct non-light spheres it hits and, with NEE on, a
//    flag per light whose NEE term counted or which it hit (:715-742);
//  * for each filled slot j (the order of :769-815: the discovered ones, then
//    one per flagged light), the same path (same PCG4D stream, the same
//    branches) replayed with the tangents of sphere j's four directions p in
//    (cx, cy, cz, r^2) injected into its records: the rigid record's field p,
//    or the general record's invt (d invt/dc = -inv3) and r^2, and, when j is
//    a light, its light record (centre, and the radius through sqrt(r^2));
//  * g . d(radiance)/dp of each replay added to table[j][p].
// The shadow ray is traced on values (detached, :576-577). The plain PyTorch
// twin is reverse-mode autodiff of kajo_tpu_torch/ops/megakernel.py:
// trace_lanes_plain through the scene's packing
// (ops/megakernel_geom.py:geometry_grads_plain).
//
// What bounds it on this card: divergent per-thread ALU work on registers,
// not bytes (the packed scene is a few KB, read through L1). One thread per
// lane would give 12,288 threads at the gradient path's 128x96, 16 spp (96
// CTAs of 4 warps on 132 SMs), each looping over its 16 samples, and one
// scalar-Dual replay per direction would compute the same value part
// (nearest scan, shadow rays, PCG4D, shading) four times per slot.
//
// This design:
//  * one replay per slot carries all four directions: the walk runs on
//    walk::Dual4 (a value and four tangents, each tangent rounding as a
//    scalar Dual walk of that direction would), so the value part is
//    computed once per slot;
//  * one work item per (lane, sample): 196,608 threads at the gradient
//    path's shape. A CTA takes kItems consecutive items (a lane's samples
//    are adjacent), walks each item's discovery on its own thread, and
//    pushes one entry per filled slot into a queue in shared memory; then
//    the CTA's threads take the queue's entries in turn, one Dual4 replay
//    each. The entries of one item are adjacent, so a warp replays the same
//    few paths, and threads whose item tracked fewer spheres do not idle
//    while another item's slots run;
//  * a grid of at most kMaxCtas CTAs, each striding over the chunks of
//    kItems, so the per-CTA tables stay small at any size.
// The table is a per-CTA [S, 4] in shared memory, each cell an exact
// fixed-point sum (csrc/exact_sum.cuh: 44 bytes a cell, 90 KB at S = 512; the
// queue adds 4 bytes per item and slot, at most 20 KB), added to with shared
// integer atomics and rounded to a float once; each CTA writes its own to
// out[blockIdx.x] and one torch.sum finishes it. So neither the order of the
// replays nor that of the queue's entries changes a bit of the result, and
// the same inputs give the same bits on every run. The per-light flags are
// a 32-bit mask: the wrapper refuses NEE scenes of more than 31 lights, as
// the reference's int32 mask cannot hold them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC

#include "exact_sum.cuh"
#include "walk.cuh"

namespace {

using namespace walk;

constexpr int TRACK_SLOTS = 8;

// packed values; the tangents are the four one-hot directions (cx, cy, cz,
// r^2) of sphere `jsel` (-1: none)
struct InjectReader {
  Layout s;
  int jsel;
  __device__ Dual4 plane(int i, int f) const { return mk<Dual4>(__ldg(s.planes + i * PL + f)); }
  __device__ Dual4 sphere(int i, int f) const {
    const float* rec = s.spheres + i * (s.rigid ? SP : SPG);
    Dual4 x = mk<Dual4>(__ldg(rec + f));
    if (i == jsel) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (s.rigid)
          x.d[p] = f == p ? 1.0f : 0.0f;
        else if (f >= 9 && f < 12 && p < 3)
          x.d[p] = -__ldg(rec + 3 * (f - 9) + p);  // invt = -inv3 c
        else if (f == 12 && p == 3)
          x.d[p] = 1.0f;
      }
    }
    return x;
  }
  __device__ Dual4 mat(int i, int f) const { return mk<Dual4>(__ldg(s.mats + i * MA + f)); }
  __device__ Dual4 light(int i, int f) const {
    const float v = __ldg(s.lights + i * LI + f);
    Dual4 x = mk<Dual4>(v);
    if (jsel >= 0 && light_obj(s, i) == s.P + jsel) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (f < 3)
          x.d[p] = f == p ? 1.0f : 0.0f;
        else if (f == 3 && p == 3)  // radius = sqrt(r^2): the clamped rule
          x.d[p] = v * v > 0.0f ? 0.5f * rsqrtf(fmaxf(v * v, 1e-12f)) : 0.0f;
      }
    }
    return x;
  }
  __device__ Dual4 bg(int f) const { return mk<Dual4>(__ldg(s.bg + f)); }
  __device__ Dual4 cam(int f) const { return mk<Dual4>(__ldg(s.cam + f)); }
};

// the discovery walk: the distinct spheres hit, the lights touched
struct Discovery : NoHooks {
  const Layout* s;
  bool nee_on;
  int slots[TRACK_SLOTS];
  uint32_t lflags;

  __device__ void hit(int obj) {
    if (obj < s->P) return;
    if (nee_on) {
      for (int li = 0; li < s->L; ++li)
        if (light_obj(*s, li) == obj) {
          lflags |= 1u << li;
          return;
        }
    }
    const int sid = obj - s->P;
    for (int k = 0; k < TRACK_SLOTS; ++k) {
      if (slots[k] == sid) return;
      if (slots[k] < 0) {
        slots[k] = sid;
        return;
      }
    }
  }
  __device__ void nee_light(int li, int, bool ok, const Shade<float>&, float, const V3<float>&, float,
                            const V3<float>&) {
    if (ok) lflags |= 1u << li;
  }

  // the lowest filled slot >= from (slots, then flagged lights) -> slot and
  // sphere, or -1
  __device__ int first_valid(int from, int& j) const {
    for (int c = from; c < TRACK_SLOTS; ++c)
      if (slots[c] >= 0) {
        j = slots[c];
        return c;
      }
    if (nee_on)
      for (int li = (from > TRACK_SLOTS ? from - TRACK_SLOTS : 0); li < s->L; ++li)
        if (lflags & (1u << li)) {
          j = light_obj(*s, li) - s->P;
          return TRACK_SLOTS + li;
        }
    return -1;
  }
};

// a replay: g . d(radiance)/dp summed over the walk, for the four directions
struct Replay : NoHooks {
  V3<float> g;
  float dL[4];
  __device__ void term(const V3<Dual4>& t) {
#pragma unroll
    for (int p = 0; p < 4; ++p) dL[p] = dL[p] + (g.x * t.x.d[p] + g.y * t.y.d[p] + g.z * t.z.d[p]);
  }
  __device__ void miss(const V3<Dual4>&, const V3<Dual4>& t) { term(t); }
  __device__ void nee_sum(const V3<Dual4>& t) { term(t); }
  __device__ void emission(int, const V3<Dual4>&, const V3<Dual4>& t) { term(t); }
};

constexpr int kItems = 128;      // (lane, sample) items per CTA chunk, one discovery walk per thread
constexpr int kMaxCtas = 4096;   // ops/megakernel_geom.py sizes out[] with the same rule (MAX_CTAS)

// out[] holds one table per CTA of this grid
__host__ __device__ inline int n_ctas(const MegaParams& p) {
  const long long chunks = (static_cast<long long>(p.n_lanes) * p.eff + kItems - 1) / kItems;
  return static_cast<int>(chunks < kMaxCtas ? chunks : kMaxCtas);
}

// 4 CTAs an SM: ptxas then fits the Dual4 walk in 128 registers with spills
// to L1 (1,200 bytes of stores); at 255 registers (2 CTAs, 88 bytes) and at
// 168 (3 CTAs) the kernel ran 9% and 2% slower (H100, PERF.md)
__global__ void __launch_bounds__(kItems, 4) geometry_grads(const float* __restrict__ scn, const float* __restrict__ g,
                                                         float* __restrict__ out, const MegaParams p) {
  extern __shared__ unsigned long long smem[];  // the table's [S, 4] cells, then the queue: int [kItems * slots]
  const exact_sum::Table tab = exact_sum::Table::at(smem, p.n_spheres * 4);
  int* queue = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + exact_sum::bytes(p.n_spheres * 4));
  __shared__ int queued;
  tab.zero(p.n_spheres * 4);

  const Layout s = layout(scn, p);
  const ValueReader vr = {s};
  const int n = p.n_lanes;
  const long long n_items = static_cast<long long>(n) * p.eff;
  const long long n_chunks = (n_items + kItems - 1) / kItems;
  for (long long chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    if (threadIdx.x == 0) queued = 0;
    __syncthreads();  // the table's zeros and the queue's count are in place
    // discovery: the item's distinct spheres and lights -> one queue entry
    // per filled slot, (thread << 16) | sphere, the item's entries adjacent
    const long long item = chunk * kItems + threadIdx.x;
    if (item < n_items) {
      const int idx = static_cast<int>(item / p.eff), sample = static_cast<int>(item % p.eff);
      const uint32_t lane = static_cast<uint32_t>(p.lane0 + idx);
      Discovery disc;
      disc.s = &s;
      disc.nee_on = p.nee_on != 0;
      for (int k = 0; k < TRACK_SLOTS; ++k) disc.slots[k] = -1;
      disc.lflags = 0u;
      State<float> st;
      start(p, vr, lane, sample, st);
      while (bounce(p, s, vr, disc, lane, sample, st)) {
      }
      int j = -1, filled = 0;
      for (int slot = disc.first_valid(0, j); slot >= 0; slot = disc.first_valid(slot + 1, j)) ++filled;
      int at = atomicAdd(&queued, filled);
      for (int slot = disc.first_valid(0, j); slot >= 0; slot = disc.first_valid(slot + 1, j))
        queue[at++] = (static_cast<int>(threadIdx.x) << 16) | j;
    }
    __syncthreads();
    // replays: one Dual4 walk per queued (item, sphere)
    const int total = queued;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int entry = queue[e];
      const int jsel = entry & 0xFFFF;
      const long long it = chunk * kItems + (entry >> 16);
      const int idx = static_cast<int>(it / p.eff), sample = static_cast<int>(it % p.eff);
      const uint32_t lane = static_cast<uint32_t>(p.lane0 + idx);
      const InjectReader rd = {s, jsel};
      Replay rep;
      rep.g = {g[idx], g[n + idx], g[2 * n + idx]};
#pragma unroll
      for (int q = 0; q < 4; ++q) rep.dL[q] = 0.0f;
      State<Dual4> sd;
      start(p, rd, lane, sample, sd);
      while (bounce(p, s, rd, rep, lane, sample, sd)) {
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) tab.add(jsel * 4 + q, rep.dL[q]);
    }
    __syncthreads();  // the queue is read before the next chunk refills it
  }
  float* mine = out + static_cast<size_t>(blockIdx.x) * p.n_spheres * 4;
  for (int i = threadIdx.x; i < p.n_spheres * 4; i += blockDim.x) mine[i] = tab.value(i);
}

}  // namespace

// Launch K4 on `stream`: g[3, n_lanes] is the cotangent of the lanes' sums;
// out[n_ctas, S, 4] receives one table (d/dcx, d/dcy, d/dcz, d/d(r^2) per
// sphere) per CTA, n_ctas = min(ceil(n_lanes * eff / 128), 4096). Returns
// cudaGetLastError() (0 on success).
extern "C" int kajo_geometry_grads(const float* scene, const float* g, float* out, const MegaParams* params,
                                   void* stream) {
  const MegaParams p = *params;
  if (p.n_lanes > 0 && p.n_spheres > 0 && p.eff > 0) {
    const int slots = TRACK_SLOTS + (p.nee_on ? p.n_lights : 0);
    const size_t shared = exact_sum::bytes(p.n_spheres * 4) + static_cast<size_t>(kItems) * slots * sizeof(int);
    const int err = exact_sum::allow_shared(geometry_grads, shared);
    if (err) return err;
    geometry_grads<<<n_ctas(p), kItems, shared, static_cast<cudaStream_t>(stream)>>>(scene, g, out, p);
  }
  return static_cast<int>(cudaGetLastError());
}
