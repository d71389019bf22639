// Material gradients of the fused pass for Hopper (sm_90a): K3, Path Replay
// Backpropagation, one thread per lane.
//
// Replaces kajo_tpu/ops/pallas/megakernel_grad.py:_build_grad_kernel (:94),
// the Pallas kernel behind material_grads (:841). Each lane walks each of its
// samples twice with the same PCG4D stream (csrc/walk.cuh's walk on floats):
// walk 1 sums the sample's radiance L; walk 2 replays the path with R_rem,
// the radiance still to come, and peels off each term. Every radiance term
// is linear in the colour it carries (f cos = colour * s for all four BSDFs),
// so the gradient of a colour c in a throughput factor is g * R_rem / c (0 for
// c == 0); NEE, emission and background terms give their coefficients
// directly. The coin probabilities are detached, and, like the Pallas
// kernel, the walks never cull by throughput (the wrapper passes
// regen_threshold 0). The plain PyTorch twin is reverse-mode autodiff of
// kajo_tpu_torch/ops/megakernel.py:trace_lanes_plain
// (ops/megakernel_grad.py:material_grads_plain).
//
// Accumulation: a per-CTA table of (K+1) x 9 floats in shared memory (cols
// 0-2 diffuse, 3-5 specular, 6-8 emission, row K the background; 18.5 KB at
// K = 512), added to with shared atomics. Each CTA writes its table to
// out[blockIdx.x]; one torch.sum over the CTAs finishes the reduction, so no
// global float atomics, and sums reproducible up to the order of the shared
// atomics within a CTA. The Pallas kernel's two table layouts (unrolled
// planes below 25 objects, a VMEM table above) are one here.
//
// What bounds it on this card: as K1, divergent per-lane ALU work (two walks
// per sample), not bytes: it reads the scene and 12 bytes of cotangent per
// lane, and writes (K+1) x 36 bytes per CTA.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC

#include "walk.cuh"

namespace {

using namespace walk;

struct PathReplay : NoHooks {
  float* tab;  // shared (K+1) x 9
  int K;
  V3<float> g;        // this lane's cotangent / divisor
  bool grading;       // walk 2
  V3<float> lcur;     // walk 1: the radiance so far
  V3<float> rrem;     // walk 2: the radiance still to come
  V3<float> pm;       // the colour in the pending throughput factor
  int pmobj, pmcol;   // its object and column (0 diffuse, 3 specular; -1 none)

  __device__ void add_to(int row, int col, float v) { atomicAdd(tab + row * 9 + col, v); }

  // the colour's share of everything still to come: g * R_rem / colour
  __device__ void factor(int row, int col, V3<float> colour) {
    const float c[3] = {colour.x, colour.y, colour.z};
    const float gg[3] = {g.x, g.y, g.z};
    const float rr[3] = {rrem.x, rrem.y, rrem.z};
    for (int k = 0; k < 3; ++k)
      if (c[k] != 0.0f) add_to(row, col + k, gg[k] * rr[k] / c[k]);
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
    if (grading) {
      add_to(K, 0, g.x * t3.x);
      add_to(K, 1, g.y * t3.y);
      add_to(K, 2, g.z * t3.z);
    }
    term(t);
  }
  __device__ void nee_light(int, int obj_id, bool ok, const Shade<float>& sh, float wl, const V3<float>& fcos_l,
                            float s_sel, const V3<float>& le) {
    if (!grading || !ok) return;
    const V3<float> base = {g.x * sh.t3.x * wl, g.y * sh.t3.y * wl, g.z * sh.t3.z * wl};
    add_to(obj_id, 6, base.x * fcos_l.x);
    add_to(obj_id, 7, base.y * fcos_l.y);
    add_to(obj_id, 8, base.z * fcos_l.z);
    if (sh.lam || sh.ph) {
      const int col = sh.lam ? 0 : 3;
      add_to(sh.obj, col, base.x * s_sel * le.x);
      add_to(sh.obj, col + 1, base.y * s_sel * le.y);
      add_to(sh.obj, col + 2, base.z * s_sel * le.z);
    }
  }
  __device__ void nee_sum(const V3<float>& t) { term(t); }
  __device__ void transmit(int obj, const V3<float>& ms) {
    if (grading) factor(obj, 3, ms);
  }
  __device__ void emission(int obj, const V3<float>& t_em, const V3<float>& t) {
    if (grading) {
      add_to(obj, 6, g.x * t_em.x);
      add_to(obj, 7, g.y * t_em.y);
      add_to(obj, 8, g.z * t_em.z);
    }
    term(t);
  }
  __device__ void vertex_end(bool sc, bool lam, int obj, const V3<float>& colour) {
    pm = sc ? colour : V3<float>{1.0f, 1.0f, 1.0f};
    pmobj = sc ? obj : -1;
    pmcol = sc ? (lam ? 0 : 3) : -1;
  }
};

__global__ void __launch_bounds__(kBlock) material_grads(const float* __restrict__ scn,
                                                         const float* __restrict__ g, float* __restrict__ out,
                                                         const MegaParams p) {
  extern __shared__ float tab[];
  const int rows = p.n_planes + p.n_spheres + 1;
  for (int i = threadIdx.x; i < rows * 9; i += blockDim.x) tab[i] = 0.0f;
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < p.n_lanes) {
    const uint32_t lane = static_cast<uint32_t>(p.lane0 + idx);
    const Layout s = layout(scn, p);
    const ValueReader rd = {s};
    const int n = p.n_lanes;
    PathReplay hk;
    hk.tab = tab;
    hk.K = rows - 1;
    hk.g = {g[idx], g[n + idx], g[2 * n + idx]};
    hk.grading = false;
    hk.lcur = hk.rrem = {0.0f, 0.0f, 0.0f};
    hk.vertex_end(false, false, -1, hk.lcur);
    State<float> st;
    int sample = 0;
    start(p, rd, lane, sample, st);
    while (sample < p.eff) {
      if (bounce(p, s, rd, hk, lane, sample, st)) continue;
      if (!hk.grading) {  // walk 1 done: replay the same sample
        hk.grading = true;
        hk.rrem = hk.lcur;
      } else {  // walk 2 done: next sample
        hk.grading = false;
        hk.lcur = {0.0f, 0.0f, 0.0f};
        ++sample;
      }
      start(p, rd, lane, sample, st);
    }
  }
  __syncthreads();
  float* mine = out + static_cast<size_t>(blockIdx.x) * rows * 9;
  for (int i = threadIdx.x; i < rows * 9; i += blockDim.x) mine[i] = tab[i];
}

}  // namespace

// Launch K3 on `stream`: g[3, n_lanes] is the cotangent of the lanes' sums;
// out[n_cta, K+1, 9] receives one gradient table per CTA of 128 lanes.
// Returns cudaGetLastError() (0 on success).
extern "C" int kajo_material_grads(const float* scene, const float* g, float* out, const MegaParams* params,
                                   void* stream) {
  const MegaParams p = *params;
  if (p.n_lanes > 0) {
    const int blocks = (p.n_lanes + kBlock - 1) / kBlock;
    const size_t shared = static_cast<size_t>(p.n_planes + p.n_spheres + 1) * 9 * sizeof(float);
    material_grads<<<blocks, kBlock, shared, static_cast<cudaStream_t>(stream)>>>(scene, g, out, p);
  }
  return static_cast<int>(cudaGetLastError());
}
