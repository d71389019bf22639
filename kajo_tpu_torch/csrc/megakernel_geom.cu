// Sphere geometry gradients of the fused pass for Hopper (sm_90a): K4, one
// thread per lane.
//
// Replaces kajo_tpu/ops/pallas/megakernel_geom.py:_build_geom_kernel (:124),
// the Pallas kernel behind geometry_grads (:923). A path's radiance depends
// on the geometry of the few distinct spheres it hits (visibility is discrete,
// so detached), so each lane, per sample:
//  * walks the sample once on floats (csrc/walk.cuh), recording up to
//    TRACK_SLOTS = 8 distinct non-light spheres it hits and, with NEE on, a
//    flag per light whose NEE term counted or which it hit (:715-742);
//  * replays the same path (same PCG4D stream, the same branches) as a Dual
//    walk for each filled slot j and each direction p in (cx, cy, cz, r^2),
//    the tangent injected only into sphere j's records: the rigid record's
//    field p, or the general record's invt (d invt/dc = -inv3) and r^2, and,
//    when j is a light, its light record (centre, and the radius through
//    sqrt(r^2)). The slots come in the order of :769-815: the discovered
//    ones, then one per flagged light; only filled slots are replayed.
//  * adds g . d(radiance)/dp of each replay to table[j][p].
// The shadow ray is traced on values (detached, :576-577). The table is a
// per-CTA [S, 4] in shared memory (8 KB at S = 512), added to with shared
// atomics; each CTA writes its own to out[blockIdx.x] and one torch.sum
// finishes it. The plain PyTorch twin is reverse-mode autodiff of
// kajo_tpu_torch/ops/megakernel.py:trace_lanes_plain through the scene's
// packing (ops/megakernel_geom.py:geometry_grads_plain).
//
// What bounds it on this card: divergent per-lane ALU work, about 4 Dual
// walks per distinct sphere a path touches, not bytes. The per-light flags
// are a 32-bit mask: the wrapper refuses NEE scenes of more than 31 lights,
// as the reference's int32 mask cannot hold them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC

#include "walk.cuh"

namespace {

using namespace walk;

constexpr int TRACK_SLOTS = 8;

// packed values; the tangent is the one-hot direction `dirp` of sphere
// `jsel` (-1: none)
struct InjectReader {
  Layout s;
  int jsel, dirp;
  __device__ Dual plane(int i, int f) const { return {__ldg(s.planes + i * PL + f), 0.0f}; }
  __device__ Dual sphere(int i, int f) const {
    const float* rec = s.spheres + i * (s.rigid ? SP : SPG);
    float d = 0.0f;
    if (i == jsel) {
      if (s.rigid)
        d = f == dirp ? 1.0f : 0.0f;
      else if (f >= 9 && f < 12 && dirp < 3)
        d = -__ldg(rec + 3 * (f - 9) + dirp);  // invt = -inv3 c
      else if (f == 12 && dirp == 3)
        d = 1.0f;
    }
    return {__ldg(rec + f), d};
  }
  __device__ Dual mat(int i, int f) const { return {__ldg(s.mats + i * MA + f), 0.0f}; }
  __device__ Dual light(int i, int f) const {
    const float v = __ldg(s.lights + i * LI + f);
    float d = 0.0f;
    if (jsel >= 0 && light_obj(s, i) == s.P + jsel) {
      if (f < 3)
        d = f == dirp ? 1.0f : 0.0f;
      else if (f == 3 && dirp == 3)  // radius = sqrt(r^2): the clamped rule
        d = v * v > 0.0f ? 0.5f * rsqrtf(fmaxf(v * v, 1e-12f)) : 0.0f;
    }
    return {v, d};
  }
  __device__ Dual bg(int f) const { return {__ldg(s.bg + f), 0.0f}; }
  __device__ Dual cam(int f) const { return {__ldg(s.cam + f), 0.0f}; }
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

// a replay: g . d(radiance) summed over the walk
struct Replay : NoHooks {
  V3<float> g;
  float dL;
  __device__ void term(const V3<Dual>& t) { dL = dL + (g.x * t.x.d + g.y * t.y.d + g.z * t.z.d); }
  __device__ void miss(const V3<Dual>&, const V3<Dual>& t) { term(t); }
  __device__ void nee_sum(const V3<Dual>& t) { term(t); }
  __device__ void emission(int, const V3<Dual>&, const V3<Dual>& t) { term(t); }
};

__global__ void __launch_bounds__(kBlock) geometry_grads(const float* __restrict__ scn,
                                                         const float* __restrict__ g, float* __restrict__ out,
                                                         const MegaParams p) {
  extern __shared__ float tab[];  // [S, 4]
  for (int i = threadIdx.x; i < p.n_spheres * 4; i += blockDim.x) tab[i] = 0.0f;
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < p.n_lanes) {
    const uint32_t lane = static_cast<uint32_t>(p.lane0 + idx);
    const Layout s = layout(scn, p);
    const ValueReader vr = {s};
    const int n = p.n_lanes;
    Discovery disc;
    disc.s = &s;
    disc.nee_on = p.nee_on != 0;
    Replay rep;
    rep.g = {g[idx], g[n + idx], g[2 * n + idx]};
    for (int sample = 0; sample < p.eff; ++sample) {
      for (int k = 0; k < TRACK_SLOTS; ++k) disc.slots[k] = -1;
      disc.lflags = 0u;
      State<float> st;
      start(p, vr, lane, sample, st);
      while (bounce(p, s, vr, disc, lane, sample, st)) {
      }
      int j = -1;
      for (int slot = disc.first_valid(0, j); slot >= 0; slot = disc.first_valid(slot + 1, j)) {
        for (int dirp = 0; dirp < 4; ++dirp) {
          const InjectReader rd = {s, j, dirp};
          State<Dual> sd;
          start(p, rd, lane, sample, sd);
          rep.dL = 0.0f;
          while (bounce(p, s, rd, rep, lane, sample, sd)) {
          }
          atomicAdd(tab + j * 4 + dirp, rep.dL);
        }
      }
    }
  }
  __syncthreads();
  float* mine = out + static_cast<size_t>(blockIdx.x) * p.n_spheres * 4;
  for (int i = threadIdx.x; i < p.n_spheres * 4; i += blockDim.x) mine[i] = tab[i];
}

}  // namespace

// Launch K4 on `stream`: g[3, n_lanes] is the cotangent of the lanes' sums;
// out[n_cta, S, 4] receives one table (d/dcx, d/dcy, d/dcz, d/d(r^2) per
// sphere) per CTA of 128 lanes. Returns cudaGetLastError() (0 on success).
extern "C" int kajo_geometry_grads(const float* scene, const float* g, float* out, const MegaParams* params,
                                   void* stream) {
  const MegaParams p = *params;
  if (p.n_lanes > 0 && p.n_spheres > 0) {
    const int blocks = (p.n_lanes + kBlock - 1) / kBlock;
    const size_t shared = static_cast<size_t>(p.n_spheres) * 4 * sizeof(float);
    geometry_grads<<<blocks, kBlock, shared, static_cast<cudaStream_t>(stream)>>>(scene, g, out, p);
  }
  return static_cast<int>(cudaGetLastError());
}
