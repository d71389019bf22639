// Forward mode of the fused pass for Hopper (sm_90a): K2, one thread per lane.
//
// Replaces kajo_tpu/ops/pallas/megakernel.py:_build_kernel(jvp=True), the
// Pallas kernel behind render_pass_megakernel_jvp (megakernel.py:939): K1's
// walk with every scene read carrying a tangent, {packed[i], packed_dot[i]},
// the CUDA form of the Pallas kernel's v + e * v_tan injection (:804-822).
// Each lane returns its RGB sum and the sum's derivative along the tangent.
// The walk is csrc/walk.cuh's on a Dual scalar; its values round as K1's, so
// K2's image equals K1's bit for bit. The plain PyTorch twin is forward-mode
// autodiff of kajo_tpu_torch/ops/megakernel.py:trace_lanes_plain
// (trace_lanes_plain_jvp).
//
// What bounds it on this card: as K1, divergent per-lane ALU work and
// registers, not bytes; a Dual doubles the live floats of the shading (the
// trace runs on values and recomputes only the winner as a Dual). Each lane
// writes 24 bytes once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC

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

// sums the radiance terms in K1's order
struct Radiance : NoHooks {
  V3<Dual> r3;
  __device__ void add_term(const V3<Dual>& term) { r3 = add(r3, term); }
  __device__ void miss(const V3<Dual>&, const V3<Dual>& term) { add_term(term); }
  __device__ void nee_sum(const V3<Dual>& term) { add_term(term); }
  __device__ void emission(int, const V3<Dual>&, const V3<Dual>& term) { add_term(term); }
};

__global__ void __launch_bounds__(kBlock) megakernel_jvp(const float* __restrict__ scn,
                                                         const float* __restrict__ scn_dot, float* __restrict__ out,
                                                         const MegaParams p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n_lanes) return;
  const uint32_t lane = static_cast<uint32_t>(p.lane0 + idx);
  const Layout s = layout(scn, p);
  const TangentReader rd = {s, layout(scn_dot, p)};
  Radiance hk;
  hk.r3 = vconst<Dual>(0.0f, 0.0f, 0.0f);
  State<Dual> st;
  int sample = 0;
  start(p, rd, lane, sample, st);
  while (sample < p.eff) {
    if (!bounce(p, s, rd, hk, lane, sample, st)) start(p, rd, lane, ++sample, st);
  }
  const int n = p.n_lanes;
  out[idx] = hk.r3.x.v;
  out[n + idx] = hk.r3.y.v;
  out[2 * n + idx] = hk.r3.z.v;
  out[3 * n + idx] = hk.r3.x.d;
  out[4 * n + idx] = hk.r3.y.d;
  out[5 * n + idx] = hk.r3.z.d;
}

}  // namespace

// Launch one forward-mode pass on `stream`: out[2, 3, n_lanes] receives the
// RGB sums of lanes lane0 .. lane0 + n_lanes - 1 (out[0]) and their tangents
// (out[1]). Returns cudaGetLastError() (0 on success).
extern "C" int kajo_megakernel_jvp(const float* scene, const float* scene_dot, float* out, const MegaParams* params,
                                   void* stream) {
  const MegaParams p = *params;
  if (p.n_lanes > 0) {
    const int blocks = (p.n_lanes + kBlock - 1) / kBlock;
    megakernel_jvp<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(scene, scene_dot, out, p);
  }
  return static_cast<int>(cudaGetLastError());
}
