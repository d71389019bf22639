// Forward mode of the fused pass for Hopper (sm_90a): K2, one thread per
// (lane, sample) item at the gradient path's shape, one per lane where the
// lanes fill the card.
//
// Replaces kajo_tpu/ops/pallas/megakernel.py:_build_kernel(jvp=True), the
// Pallas kernel behind render_pass_megakernel_jvp (megakernel.py:939): K1's
// walk with every scene read carrying a tangent, {packed[i], packed_dot[i]},
// the CUDA form of the Pallas kernel's v + e * v_tan injection (:804-822).
// Each lane returns its RGB sum and the sum's derivative along the tangent.
// The walk is csrc/walk.cuh's on a Dual scalar; its values round as K1's.
// The plain PyTorch twin is forward-mode autodiff of
// kajo_tpu_torch/ops/megakernel.py:trace_lanes_plain (trace_lanes_plain_jvp).
//
// What bounds it on this card: as K1, divergent per-thread ALU work and
// registers, not bytes; a Dual doubles the live floats of the shading (the
// trace runs on values and recomputes only the winner as a Dual). Each lane
// writes 24 bytes once. One thread per lane gives 12,288 threads at the
// gradient path's 128x96, 16 spp (96 CTAs of 4 warps on 132 SMs), each
// walking its 16 samples in series: the card is mostly idle. One thread per
// (lane, sample) fills it, but a warp then waits for its longest path, where
// a thread that walks several samples starts the next one as soon as a path
// ends (one bounce call site, so the warp stays converged): at caustics
// 512x384, 16 spp, whose 196,608 lanes fill the card, per-sample threads ran
// 1.57x slower than per-lane ones (H100, PERF.md).
//
// This design: a lane's eff samples split into blocks of consecutive
// samples, one thread a block, walking them in series: one sample a block
// where the lanes alone would leave some of the card's resident threads
// idle (the gradient path's 12,288 lanes; at 256x192, 49,152 lanes, still
// 16% faster than a thread a lane), else one block of eff samples, one
// thread a lane (caustics 512x384: 196,608 lanes); a thread per four
// samples at 256x192 ran slower than either (H100, PERF.md). The plan
// (jvp_plan: sample_plan.cuh with K2's threshold and shared-byte rule,
// mirrored by ops/megakernel.py:jvp_plan) decides. K2's image must equal
// K1's bit for bit, so a lane's first block keeps K1's running sum and the
// later ones log their terms' values (miss, NEE sum, emission; zeros too)
// to be added in (sample, term) order, as sample_plan.cuh describes and K1
// does below its own threshold. The tangent is held to a relative gap, not
// to bits, so each block sums its own tangent terms and the lane adds the
// per-block sums.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC

#include "sample_plan.cuh"
#include "walk.cuh"

namespace {

using namespace walk;

// {packed[i], packed_dot[i]} for every field
struct TangentReader {
  Layout s, t;
  __device__ Dual plane(int i, int f) const { return {__ldg(s.planes + i * PL + f), __ldg(t.planes + i * PL + f)}; }
  __device__ Dual sphere(int i, int f) const {
    const int k = i * (s.rigid ? SP : SPG) + f;
    return {__ldg(s.spheres + k), __ldg(t.spheres + k)};
  }
  __device__ Dual mat(int i, int f) const { return {__ldg(s.mats + i * MA + f), __ldg(t.mats + i * MA + f)}; }
  __device__ Dual light(int i, int f) const { return {__ldg(s.lights + i * LI + f), __ldg(t.lights + i * LI + f)}; }
  __device__ Dual bg(int f) const { return {__ldg(s.bg + f), __ldg(t.bg + f)}; }
  __device__ Dual cam(int f) const { return {__ldg(s.cam + f), __ldg(t.cam + f)}; }
};

// K2's shared-byte rule (sample_plan.cuh): a thread keeps its value and
// tangent sums and its term count (7 floats), a lane its running value and
// tangent sums (6); a thread a sample below 132 SMs x 4 CTAs x 128 threads
constexpr int kResidentThreads = 67584;
constexpr int kThreadFloats = 7, kLaneFloats = 6;
using sample_plan::kMaxThreads;
using Plan = sample_plan::Plan;

__host__ inline Plan jvp_plan(int n_lanes, int eff, int max_depth) {
  return sample_plan::plan(n_lanes, eff, max_depth, kResidentThreads, kThreadFloats, kLaneFloats);
}

// a block's radiance terms: the lane's first block sums their values in
// order, a later one logs them to its column of the CTA's log; both sum the
// tangents in order
struct TermLog : NoHooks {
  float* col;   // entry (channel c, term k) at col[(c * terms + k) * stride]
  int terms, stride, k;
  bool logging;
  V3<float> vsum, dsum;
  __device__ void add_term(const V3<Dual>& t) {
    if (logging) {
      col[k * stride] = t.x.v;
      col[(terms + k) * stride] = t.y.v;
      col[(2 * terms + k) * stride] = t.z.v;
      ++k;
    } else {
      vsum = {vsum.x + t.x.v, vsum.y + t.y.v, vsum.z + t.z.v};
    }
    dsum = {dsum.x + t.x.d, dsum.y + t.y.d, dsum.z + t.z.d};
  }
  __device__ void miss(const V3<Dual>&, const V3<Dual>& term) { add_term(term); }
  __device__ void nee_sum(const V3<Dual>& term) { add_term(term); }
  __device__ void emission(int, const V3<Dual>&, const V3<Dual>& term) { add_term(term); }
};

// 4 CTAs an SM: ptxas then fits the Dual walk in 128 registers with spills
// to L1 (296 bytes of stores); at 168 registers (3 CTAs) the kernel ran
// 9-13% slower at 128x96, 16 spp and at 512x384 (H100, PERF.md)
__global__ void __launch_bounds__(kMaxThreads, 4) megakernel_jvp(const float* __restrict__ scn,
                                                              const float* __restrict__ scn_dot,
                                                              float* __restrict__ out, const MegaParams p,
                                                              const Plan q) {
  extern __shared__ float sm[];
  const int nt = q.threads, T = q.log_terms;
  float* logs = sm;                                          // [3][T][nt]
  float* sums = logs + 3 * T * nt;                           // [6][nt]: value sums, tangent sums
  int* counts = reinterpret_cast<int*>(sums + 6 * nt);       // [nt]
  float* run = reinterpret_cast<float*>(counts + nt);        // [2][3][lanes_per_cta]: running value, tangent sums
  const int units = 3 * q.lanes_per_cta;                     // (lane, channel) sums
  for (int u = threadIdx.x; u < 2 * units; u += nt) run[u] = 0.0f;

  const int t = threadIdx.x;
  const int idx = blockIdx.x * q.lanes_per_cta + t / q.wave;
  const Layout s = layout(scn, p);
  const TangentReader rd = {s, layout(scn_dot, p)};
  for (int w = 0; w < q.waves; ++w) {
    const int block = w * q.wave + t % q.wave;
    TermLog hk;
    hk.col = logs + t;
    hk.terms = T;
    hk.stride = nt;
    hk.k = 0;
    hk.logging = block > 0;
    hk.vsum = hk.dsum = {0.0f, 0.0f, 0.0f};
    int sample = block * q.per_block;
    const int end = min(sample + q.per_block, p.eff);
    if (idx < p.n_lanes && sample < end) {
      const uint32_t lane = static_cast<uint32_t>(p.lane0 + idx);
      State<Dual> st;
      start(p, rd, lane, sample, st);
      while (sample < end) {  // one bounce call site: a thread whose path ended starts its next sample
        if (!bounce(p, s, rd, hk, lane, sample, st) && ++sample < end) start(p, rd, lane, sample, st);
      }
    }
    counts[t] = hk.k;
    sums[t] = hk.vsum.x;
    sums[nt + t] = hk.vsum.y;
    sums[2 * nt + t] = hk.vsum.z;
    sums[3 * nt + t] = hk.dsum.x;
    sums[4 * nt + t] = hk.dsum.y;
    sums[5 * nt + t] = hk.dsum.z;
    __syncthreads();  // the wave's sums and logs are complete (and run's zeros in place)
    // each (lane, channel) continues its running sums in (sample, term) order
    for (int u = t; u < units; u += nt) {
      const int l = u / 3, c = u % 3;
      float v = run[u], d = run[units + u];
      for (int j = 0; j < q.wave && w * q.wave + j < q.blocks; ++j) {
        const int thread = l * q.wave + j;
        if (w == 0 && j == 0) {
          v = sums[c * nt + thread];  // the first block's own running sum
        } else {
          const float* col = logs + c * T * nt + thread;
          const int n_terms = counts[thread];
          for (int k = 0; k < n_terms; ++k) v = v + col[k * nt];
        }
        d = d + sums[(3 + c) * nt + thread];
      }
      run[u] = v;
      run[units + u] = d;
    }
    __syncthreads();  // the logs are read before the next wave writes them
  }
  const int n = p.n_lanes;
  for (int u = t; u < units; u += nt) {
    const int i = blockIdx.x * q.lanes_per_cta + u / 3, c = u % 3;
    if (i < n) {
      out[c * n + i] = run[u];
      out[(3 + c) * n + i] = run[units + u];
    }
  }
}

}  // namespace

// Launch one forward-mode pass on `stream`: out[2, 3, n_lanes] receives the
// RGB sums of lanes lane0 .. lane0 + n_lanes - 1 (out[0]) and their tangents
// (out[1]). Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a max_depth whose log does not fit in a CTA.
extern "C" int kajo_megakernel_jvp(const float* scene, const float* scene_dot, float* out, const MegaParams* params,
                                   void* stream) {
  const MegaParams p = *params;
  if (p.n_lanes > 0 && p.eff > 0) {
    const Plan q = jvp_plan(p.n_lanes, p.eff, p.max_depth);
    if (q.threads < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (q.shared > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(megakernel_jvp, cudaFuncAttributeMaxDynamicSharedMemorySize, q.shared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int blocks = (p.n_lanes + q.lanes_per_cta - 1) / q.lanes_per_cta;
    megakernel_jvp<<<blocks, q.threads, q.shared, static_cast<cudaStream_t>(stream)>>>(scene, scene_dot, out, p, q);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2's plan constants (sample_plan::constants) into out[5].
extern "C" void kajo_megakernel_jvp_plan_constants(int* out) {
  sample_plan::constants(out, kResidentThreads, kThreadFloats, kLaneFloats);
}
