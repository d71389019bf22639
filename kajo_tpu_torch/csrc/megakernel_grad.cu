// Material gradients of the fused pass for Hopper (sm_90a): K3, Path Replay
// Backpropagation, one thread per (lane, sample) item.
//
// Replaces kajo_tpu/ops/pallas/megakernel_grad.py:_build_grad_kernel (:94),
// the Pallas kernel behind material_grads (:841). Each item walks its sample
// twice with the same PCG4D stream (csrc/walk.cuh's walk on floats): walk 1
// sums the sample's radiance L; walk 2 replays the path with R_rem, the
// radiance still to come, and peels off each term. Every radiance term is
// linear in the colour it carries (f cos = colour * s for all four BSDFs),
// so the gradient of a colour c in a throughput factor is g * R_rem / c (0
// for c == 0); NEE, emission and background terms give their coefficients
// directly. The coin probabilities are detached, and, like the Pallas
// kernel, the walks never cull by throughput (the wrapper passes
// regen_threshold 0). The plain PyTorch twin is reverse-mode autodiff of
// kajo_tpu_torch/ops/megakernel.py:trace_lanes_plain
// (ops/megakernel_grad.py:material_grads_plain).
//
// Accumulation: a per-CTA table of (K+1) x 9 cells in shared memory (cols
// 0-2 diffuse, 3-5 specular, 6-8 emission, row K the background), each an
// exact fixed-point sum (csrc/exact_sum.cuh: 44 bytes a cell, 4.8 KB at the
// test scene's K = 11, 203 KB at K = 512, where one CTA fits an SM), added
// to with shared integer atomics in any order and rounded to a float once.
// Each CTA writes its table to out[blockIdx.x]; one torch.sum over the CTAs
// finishes the reduction, so no global atomics, and the same inputs give
// the same bits on every run. The Pallas kernel's two table layouts
// (unrolled planes below 25 objects, a VMEM table above) are one here.
//
// What bounds it on this card: as K1, divergent per-item ALU work (two walks
// per sample), not bytes: it reads the scene and 12 bytes of cotangent per
// lane, and writes (K+1) x 36 bytes per CTA. One thread per lane would give
// 12,288 threads at the gradient path's 128x96, 16 spp (96 CTAs of 4 warps
// on 132 SMs), each walking its 16 samples in series. So one thread walks
// one (lane, sample) item, both its walks, and adds to its CTA's table; a
// warp holds one sample of 32 adjacent lanes (items interleaved by lane,
// item_at). Up to kMaxCtas CTAs of kItems items, each thread walks one item,
// its walk 2 in step with the warp's walk 2s (it retraces walk 1, so it
// diverges no more than walk 1 did). Beyond, where items outnumber a grid
// of that size (caustics 512x384, 16 spp: 3.1 M items), a warp that waited
// for its longest path walk after walk ran 3.6x slower than the per-lane
// design (H100, PERF.md); there the grid is kResidentCtas CTAs, all
// resident at once, and each thread walks its items through one bounce call
// site, a walk starting as soon as its last one ended, so the warp stays
// busy. ops/megakernel_grad.py sizes out[] with the same rule (n_ctas).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC

#include "exact_sum.cuh"
#include "walk.cuh"

namespace {

using namespace walk;

struct PathReplay : NoHooks {
  exact_sum::Table tab;  // shared (K+1) x 9
  int K;
  V3<float> g;        // this lane's cotangent / divisor
  bool grading;       // walk 2
  V3<float> lcur;     // walk 1: the radiance so far
  V3<float> rrem;     // walk 2: the radiance still to come
  V3<float> pm;       // the colour in the pending throughput factor
  int pmobj, pmcol;   // its object and column (0 diffuse, 3 specular; -1 none)

  // cells (row, col .. col + 2) += v
  __device__ void add3(int row, int col, const V3<float>& v) {
    const int cell = row * 9 + col;
    tab.add(cell, v.x);
    tab.add(cell + 1, v.y);
    tab.add(cell + 2, v.z);
  }

  // the colour's share of everything still to come: g * R_rem / colour
  __device__ void factor(int row, int col, V3<float> colour) {
    add3(row, col, {colour.x != 0.0f ? g.x * rrem.x / colour.x : 0.0f,
                    colour.y != 0.0f ? g.y * rrem.y / colour.y : 0.0f,
                    colour.z != 0.0f ? g.z * rrem.z / colour.z : 0.0f});
  }

  __device__ void term(const V3<float>& t) {
    if (grading)
      rrem = sub(rrem, t);
    else
      lcur = add(lcur, t);
  }

  __device__ void deferred() {
    if (grading && pmcol >= 0) factor(pmobj, pmcol, pm);
  }
  __device__ void miss(const V3<float>& t3, const V3<float>& t) {
    if (grading) add3(K, 0, {g.x * t3.x, g.y * t3.y, g.z * t3.z});
    term(t);
  }
  __device__ void nee_light(int, int obj_id, bool ok, const Shade<float>& sh, float wl, const V3<float>& fcos_l,
                            float s_sel, const V3<float>& le) {
    if (!grading || !ok) return;
    const V3<float> base = {g.x * sh.t3.x * wl, g.y * sh.t3.y * wl, g.z * sh.t3.z * wl};
    add3(obj_id, 6, {base.x * fcos_l.x, base.y * fcos_l.y, base.z * fcos_l.z});
    if (sh.lam || sh.ph)
      add3(sh.obj, sh.lam ? 0 : 3, {base.x * s_sel * le.x, base.y * s_sel * le.y, base.z * s_sel * le.z});
  }
  __device__ void nee_sum(const V3<float>& t) { term(t); }
  __device__ void transmit(int obj, const V3<float>& ms) {
    if (grading) factor(obj, 3, ms);
  }
  __device__ void emission(int obj, const V3<float>& t_em, const V3<float>& t) {
    if (grading) add3(obj, 6, {g.x * t_em.x, g.y * t_em.y, g.z * t_em.z});
    term(t);
  }
  __device__ void vertex_end(bool sc, bool lam, int obj, const V3<float>& colour) {
    pm = sc ? colour : V3<float>{1.0f, 1.0f, 1.0f};
    pmobj = sc ? obj : -1;
    pmcol = sc ? (lam ? 0 : 3) : -1;
  }
};

constexpr int kItems = 128;          // (lane, sample) items per CTA chunk
constexpr int kMaxCtas = 4096;       // one chunk a CTA up to this many chunks
constexpr int kResidentCtas = 528;   // beyond: 132 SMs x 4 CTAs of <= 128 registers, all resident at once
constexpr int kLaneGroup = 32;       // lanes whose same sample a warp walks
// ops/megakernel_grad.py sizes out[] with the same rule (n_ctas)

// items, lane-group by lane-group: n_lanes rounded up to kLaneGroup, x eff
__host__ __device__ inline long long n_items(const MegaParams& p) {
  return (static_cast<long long>(p.n_lanes) + kLaneGroup - 1) / kLaneGroup * kLaneGroup * p.eff;
}

// out[] holds one table per CTA of this grid
__host__ __device__ inline int n_ctas(const MegaParams& p) {
  const long long chunks = (n_items(p) + kItems - 1) / kItems;
  return static_cast<int>(chunks <= kMaxCtas ? chunks : kResidentCtas);
}

// item -> (lane index, sample): the eff samples of a group of kLaneGroup
// lanes, sample-major (a lane index >= n_lanes walks nothing)
__device__ inline void item_at(long long item, int eff, int& idx, int& sample) {
  const long long per_group = static_cast<long long>(kLaneGroup) * eff;
  const int r = static_cast<int>(item % per_group);
  idx = static_cast<int>(item / per_group) * kLaneGroup + r % kLaneGroup;
  sample = r / kLaneGroup;
}

// kOneItem: one item a thread, its two walks each in step with the warp's
// (walk 2 retraces walk 1, so it diverges as walk 1 did); else a thread
// walks items item, item + stride, ... through one bounce call site, a
// walk starting as soon as the thread's last one ended
template <bool kOneItem>
__global__ void __launch_bounds__(kItems) material_grads(const float* __restrict__ scn,
                                                         const float* __restrict__ g, float* __restrict__ out,
                                                         const MegaParams p) {
  extern __shared__ unsigned long long smem[];
  const int rows = p.n_planes + p.n_spheres + 1;
  const exact_sum::Table tab = exact_sum::Table::at(smem, rows * 9);
  tab.zero(rows * 9);
  __syncthreads();

  const Layout s = layout(scn, p);
  const ValueReader rd = {s};
  const int n = p.n_lanes;
  const long long items = n_items(p), stride = static_cast<long long>(gridDim.x) * kItems;
  long long item = static_cast<long long>(blockIdx.x) * kItems + threadIdx.x;
  int idx = 0, sample = 0;
  uint32_t lane = 0;
  PathReplay hk;
  hk.tab = tab;
  hk.K = rows - 1;
  hk.vertex_end(false, false, -1, V3<float>{1.0f, 1.0f, 1.0f});
  State<float> st;
  const auto seek = [&]() {  // the first item from `item` on with a lane (items: none)
    for (; item < items; item += stride) {
      item_at(item, p.eff, idx, sample);
      if (idx < n) return;
    }
  };
  const auto begin = [&]() {  // walk 1 of the item: L
    lane = static_cast<uint32_t>(p.lane0 + idx);
    hk.g = {g[idx], g[n + idx], g[2 * n + idx]};
    hk.grading = false;
    hk.lcur = {0.0f, 0.0f, 0.0f};
    start(p, rd, lane, sample, st);
  };
  const auto replay = [&]() {  // walk 2: the same path, peeling R_rem
    hk.grading = true;
    hk.rrem = hk.lcur;
    start(p, rd, lane, sample, st);
  };
  seek();
  if (kOneItem) {
    if (item < items) {
      begin();
      while (bounce(p, s, rd, hk, lane, sample, st)) {
      }
      replay();
      while (bounce(p, s, rd, hk, lane, sample, st)) {
      }
    }
  } else {
    if (item < items) begin();
    while (item < items) {
      if (bounce(p, s, rd, hk, lane, sample, st)) continue;
      if (!hk.grading) {
        replay();
      } else {  // the next item
        item += stride;
        seek();
        if (item < items) begin();
      }
    }
  }
  __syncthreads();
  float* mine = out + static_cast<size_t>(blockIdx.x) * rows * 9;
  for (int i = threadIdx.x; i < rows * 9; i += blockDim.x) mine[i] = tab.value(i);
}

}  // namespace

// Launch K3 on `stream`: g[3, n_lanes] is the cotangent of the lanes' sums;
// out[n_ctas, K+1, 9] receives one gradient table per CTA: n_ctas =
// ceil(ceil(n_lanes / 32) * 32 * eff / 128) if that is at most 4096, else
// 528. Returns
// cudaGetLastError() (0 on success).
extern "C" int kajo_material_grads(const float* scene, const float* g, float* out, const MegaParams* params,
                                   void* stream) {
  const MegaParams p = *params;
  if (p.n_lanes > 0 && p.eff > 0) {
    const size_t shared = exact_sum::bytes((p.n_planes + p.n_spheres + 1) * 9);
    const int ctas = n_ctas(p);
    const auto kernel = static_cast<long long>(ctas) * kItems >= n_items(p) ? material_grads<true>
                                                                            : material_grads<false>;
    const int err = exact_sum::allow_shared(kernel, shared);
    if (err) return err;
    kernel<<<ctas, kItems, shared, static_cast<cudaStream_t>(stream)>>>(scene, g, out, p);
  }
  return static_cast<int>(cudaGetLastError());
}
