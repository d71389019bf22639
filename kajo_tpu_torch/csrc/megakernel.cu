// The fused path-tracing pass for Hopper (sm_90a): K1.
//
// Replaces kajo_tpu/ops/pallas/megakernel.py:_build_kernel (jvp=False), the
// Pallas TPU kernel behind render_pass_megakernel and
// render_passes_megakernel. Each lane (one pixel) runs the whole
// regenerating path-trace loop: stratified camera ray, nearest hit over
// planes and spheres (rigid 4-float or general 23-float records), Russian
// roulette, the 4-BSDF lottery, next-event estimation over all lights or
// one, the deferred MIS weight, emission and background, until it has taken
// its eff = floor(sqrt(spp))^2 samples. The plain PyTorch twin is
// kajo_tpu_torch/ops/megakernel.py:trace_lanes_plain; every float
// expression here is written in the same order as there. The gradient
// kernels share this walk through csrc/walk.cuh, which computes the same
// bits; K1 keeps its own copy because built on walk.cuh (its templated loop,
// or only its helpers) it took 0.2-2.6% longer per pass on an H100 and more
// registers (PERF.md; tools/torch_k1_ab.py measures such variants).
//
// What bounds it on this card: divergent per-lane ALU work and registers, not
// bytes. Lanes take different numbers of bounces and branches (roulette, the
// BSDF lottery, shadow rays), and each lane writes only its 12-byte RGB sum
// once per pass. The TPU kernel's masked lane loop becomes SIMT branches: a
// thread computes only the branch it takes, and the shadow trace runs only
// where its NEE term can be nonzero. Two regimes, picked by the launch from
// the pass's shape (sample_plan.cuh, mirrored by ops/megakernel.py:k1_plan):
//  * where the lanes fill the card (the main path's 196,608 lanes at
//    512x384), a thread a lane walks its samples in series through one
//    bounce call site, so a thread whose path ended starts its next sample
//    at once (megakernel_lanes);
//  * below one wave of that kernel (the gradient path's 12,288 lanes at
//    128x96 are 96 CTAs on 132 SMs), a thread a (lane, sample): the lane's
//    first sample keeps the running sum, the others log their terms' values
//    to shared memory, and one thread per (lane, channel) continues the sum
//    in (sample, term) order, so the sums equal the lane kernel's and the
//    plain twin's bit for bit (megakernel_items; K2 does the same).
// The walk is instantiated per record type and NEE mode, the scene is read
// from shared memory where it fits in 16 KB (else as L1 broadcasts: every
// thread of a warp reads the same record at the same time), and each
// regime's launch bounds trade registers for resident warps; a grid of
// resident CTAs taking warps of lanes from a counter ran no faster (H100,
// PERF.md).
//
// Random numbers: PCG4D(lane, sample, salt, seed) with salt = depth * ncalls
// + call, exactly the TPU kernel's stream: us[0] roulette, us[1] transmit,
// us[2] diffuse vs specular, us[3..4] continuation, then all-lights NEE
// us[5+3l .. 7+3l], or one-light NEE us[5] select and us[6..8] sample; the
// camera uses salt CAM_SALT. A uniform is computed when it is needed (L may
// be 512), one PCG4D call serving four consecutive indices.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (no fast math; no FMA contraction, so
// the kernel rounds as its plain twin does).

#include <cstdint>
#include <cuda_runtime.h>

#include "sample_plan.cuh"

// Runtime parameters of one pass; mirrors MegaParams in ops/megakernel.py.
struct MegaParams {
  uint32_t seed;
  int32_t lane0, n_lanes, width, height, grid_n, eff;
  int32_t n_planes, n_spheres, n_lights, rigid;
  int32_t max_depth;
  float eps;
  int32_t emit_after_scatter, nee_on, one_light, ncalls, full_mis;
  float regen_threshold;
};

namespace {

constexpr int kBlock = 128;
// __launch_bounds__' CTAs per SM of the two regimes: a thread a lane fits
// in 96 registers (a few spilled), a thread a (lane, sample) in 80; each ran
// faster than 4 and 6, and than 4, 5 and 8, CTAs (H100, PERF.md)
constexpr int kLaneCtas = 5, kItemCtas = 6;
// a thread a (lane, sample) below one wave of the lane kernel: 132 SMs x
// kLaneCtas CTAs x 128 threads
constexpr int kResidentThreads = 132 * kLaneCtas * kBlock;
// K1's shared-byte rule (sample_plan.cuh): a thread keeps its value sum and
// its term count, a lane its running sum
constexpr int kThreadFloats = 4, kLaneFloats = 3;
constexpr int kStageFloats = 4096;  // the scenes staged in shared memory: up to 16 KB
// packed-buffer record sizes (ops/megakernel.py)
constexpr int PL = 8;    // plane: nrow4, det, normal3
constexpr int SP = 4;    // rigid sphere: cx, cy, cz, r2
constexpr int SPG = 23;  // general sphere: inv3 (9), invt (3), r2, det, fwd3 (9)
constexpr int MA = 14;   // material: diffuse3, specular3, emission3, transparency3, exp, ior
constexpr int LI = 8;    // light: cx, cy, cz, radius, er, eg, eb, obj_id

constexpr float FLT_EPS = 1.1920928955078125e-07f;
constexpr float BIG = 3.0e38f;
constexpr float PI = 3.14159265358979323846f;
constexpr float TWO_PI = 2.0f * PI;  // exact: a power-of-two multiple
constexpr uint32_t CAM_SALT = 0x7FFFFFFFu;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// unit vector; 0 for a zero vector
__device__ __forceinline__ V3 normalize(V3 a) {
  const float n2 = dot(a, a);
  if (!(n2 > 0.0f)) return {0.0f, 0.0f, 0.0f};
  return scale(a, rsqrtf(n2));
}

__device__ __forceinline__ V3 reflect(V3 v, V3 n) { return sub(v, scale(n, 2.0f * dot(n, v))); }

__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(fmaxf(x, 0.0f)); }

// x**n as exp(n log x); 0 for x <= 0, except 1 when n == 0
__device__ __forceinline__ float safe_pow(float x, float n) {
  if (x > 0.0f) return expf(n * logf(x));
  return n == 0.0f ? 1.0f : 0.0f;
}

__device__ __forceinline__ void pcg4d(uint32_t a, uint32_t b, uint32_t c, uint32_t d, uint32_t out[4]) {
  uint32_t x = a * 1664525u + 1013904223u;
  uint32_t y = b * 1664525u + 1013904223u;
  uint32_t z = c * 1664525u + 1013904223u;
  uint32_t w = d * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  out[0] = x;
  out[1] = y;
  out[2] = z;
  out[3] = w;
}

// top 24 bits -> [0, 1); exact
__device__ __forceinline__ float unit(uint32_t u) { return static_cast<float>(u >> 8) * (1.0f / 16777216.0f); }

// The bounce's uniforms us[k]: PCG4D call k/4 of (lane, sample, salt0 + k/4,
// seed), component k%4. Keeps the last call, since indices come in order.
struct Uniforms {
  uint32_t lane, sample, salt0, seed;
  int cached;
  float u[4];

  __device__ float operator()(int k) {
    const int call = k >> 2;
    if (call != cached) {
      uint32_t w[4];
      pcg4d(lane, sample, salt0 + static_cast<uint32_t>(call), seed, w);
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = unit(w[i]);
      cached = call;
    }
    const int j = k & 3;
    return j == 0 ? u[0] : j == 1 ? u[1] : j == 2 ? u[2] : u[3];
  }
};

struct Layout {
  const float* __restrict__ planes;
  const float* __restrict__ spheres;
  const float* __restrict__ mats;
  const float* __restrict__ lights;
  const float* __restrict__ bg;   // background rgb, then the camera: origin, p1, du, dv
  int P, S, L;
};

// the packed scene's records from `scn` (global or shared memory)
__device__ __forceinline__ Layout layout(const float* scn, const MegaParams& p) {
  Layout s;
  s.P = p.n_planes;
  s.S = p.n_spheres;
  s.L = p.n_lights;
  s.planes = scn;
  s.spheres = s.planes + s.P * PL;
  s.mats = s.spheres + s.S * (p.rigid ? SP : SPG);
  s.lights = s.mats + (s.P + s.S) * MA;
  s.bg = s.lights + s.L * LI;
  return s;
}

// floats of the packed scene (ops/megakernel.py:pack_scene)
__host__ __device__ inline int scene_floats(const MegaParams& p) {
  return p.n_planes * PL + p.n_spheres * (p.rigid ? SP : SPG) + (p.n_planes + p.n_spheres) * MA + p.n_lights * LI +
         3 + 12;
}

// floats of shared memory a staged scene takes, whole 16-byte words
__host__ __device__ inline int staged_floats(const MegaParams& p) { return (scene_floats(p) + 3) / 4 * 4; }

// How a launch reads the scene and which estimator branches it compiles:
// the record type and the NEE mode (NEE: 0 off, 1 every light, 2 one light)
// are template constants, so a scene's kernel holds only the branches it
// takes, and takes fewer registers; the six instantiations of each regime
// are one build, and the launch picks one from the pass's parameters.
// STAGED: the packed scene is copied into shared memory at the start and
// read from there; else it is read through L1 (__ldg), every thread of a
// warp reading the same record at the same time, a broadcast. Deciding this
// at run time instead, a plain load through a pointer to either, ran 1-3%
// slower a thread a sample and 5-7% a thread a lane (H100, PERF.md).
template <bool RIGID, int NEE, bool STAGED>
struct Fixed {
  bool full_mis_;
  static constexpr bool staged = STAGED;
  __device__ bool rigid() const { return RIGID; }
  __device__ bool nee() const { return NEE != 0; }
  __device__ bool one_light() const { return NEE == 2; }
  __device__ bool full_mis() const { return full_mis_; }
  __device__ float ld(const float* p) const { return STAGED ? *p : __ldg(p); }
};

struct Hit {
  float t;
  int obj;
  V3 n;
};

// General-transform sphere hit: object-space stable quadratic with
// determinant-scaled t; the normal is the object-space hit point rotated by
// the forward matrix, normalized.
template <class C>
__device__ __forceinline__ bool sphere_hit_general(const C& c, const float* __restrict__ rec, V3 o, V3 d,
                                                   float& t_out, V3& n_out, bool need_normal) {
  float r[SPG];
#pragma unroll
  for (int j = 0; j < 14; ++j) r[j] = c.ld(rec + j);
  const float ox = r[0] * o.x + r[1] * o.y + r[2] * o.z + r[9];
  const float oy = r[3] * o.x + r[4] * o.y + r[5] * o.z + r[10];
  const float oz = r[6] * o.x + r[7] * o.y + r[8] * o.z + r[11];
  const float dx = r[0] * d.x + r[1] * d.y + r[2] * d.z;
  const float dy = r[3] * d.x + r[4] * d.y + r[5] * d.z;
  const float dz = r[6] * d.x + r[7] * d.y + r[8] * d.z;
  const float r2 = r[12], det = r[13];
  const float a = dx * dx + dy * dy + dz * dz;
  const float b = 2.0f * (dx * ox + dy * oy + dz * oz);
  const float cq = ox * ox + oy * oy + oz * oz - r2;
  const float discr = b * b - 4.0f * a * cq;
  const float sq = safe_sqrt(discr);
  const float q = b < 0.0f ? (-b - sq) * 0.5f : (-b + sq) * 0.5f;
  const float t0 = q / (a == 0.0f ? 1.0f : a);
  const float t1 = cq / (q == 0.0f ? 1.0f : q);
  const float lo = fminf(t0, t1);
  const float hi = fmaxf(t0, t1);
  const float t_loc = lo < 0.0f ? hi : lo;
  const float t = t_loc * det;
  t_out = t;
  const bool valid = (discr >= 0.0f) && (hi >= 0.0f) && (a != 0.0f) && (q != 0.0f) && (t >= 0.0f);
  if (valid && need_normal) {
#pragma unroll
    for (int j = 14; j < SPG; ++j) r[j] = c.ld(rec + j);
    const V3 nl = {ox + dx * t_loc, oy + dy * t_loc, oz + dz * t_loc};
    n_out = normalize({r[14] * nl.x + r[15] * nl.y + r[16] * nl.z, r[17] * nl.x + r[18] * nl.y + r[19] * nl.z,
                       r[20] * nl.x + r[21] * nl.y + r[22] * nl.z});
  }
  return valid;
}

// Nearest hit over planes then spheres; a later object needs a strictly
// smaller t. NEED_NORMAL=false for shadow rays, which use only the object.
template <bool NEED_NORMAL, class C>
__device__ Hit trace(const C& c, const Layout& s, V3 o, V3 d) {
  Hit h = {BIG, -1, {0.0f, 0.0f, 0.0f}};
  for (int i = 0; i < s.P; ++i) {
    const float* r = s.planes + i * PL;
    const float r0 = c.ld(r), r1 = c.ld(r + 1), r2 = c.ld(r + 2);
    const float denom = d.x * r0 + d.y * r1 + d.z * r2;
    const float onum = o.x * r0 + o.y * r1 + o.z * r2 + c.ld(r + 3);
    const float t_loc = -onum / (denom == 0.0f ? 1.0f : denom);
    const float t = t_loc * c.ld(r + 4);
    if (fabsf(denom) >= FLT_EPS && t_loc >= 0.0f && t >= 0.0f && t < h.t) {
      h.t = t;
      h.obj = i;
      if (NEED_NORMAL) h.n = {c.ld(r + 5), c.ld(r + 6), c.ld(r + 7)};
    }
  }
  if (!c.rigid()) {
    for (int i = 0; i < s.S; ++i) {
      float t;
      V3 n;
      if (sphere_hit_general(c, s.spheres + i * SPG, o, d, t, n, NEED_NORMAL) && t < h.t) {
        h.t = t;
        h.obj = s.P + i;
        if (NEED_NORMAL) h.n = n;
      }
    }
    return h;
  }
  const float d_dot_o = dot(d, o);
  const float o2 = dot(o, o);
  for (int i = 0; i < s.S; ++i) {
    const float* r = s.spheres + i * SP;
    const float cx = c.ld(r), cy = c.ld(r + 1), cz = c.ld(r + 2), r2 = c.ld(r + 3);
    const float d_dot_c = d.x * cx + d.y * cy + d.z * cz;
    const float o_dot_c = o.x * cx + o.y * cy + o.z * cz;
    const float b = 2.0f * (d_dot_o - d_dot_c);
    const float cq = o2 - 2.0f * o_dot_c + (cx * cx + cy * cy + cz * cz - r2);
    const float discr = b * b - 4.0f * cq;
    const float sq = safe_sqrt(discr);
    const float q = b < 0.0f ? (-b - sq) * 0.5f : (-b + sq) * 0.5f;
    const float t1 = cq / (q == 0.0f ? 1.0f : q);
    const float lo = fminf(q, t1);
    const float hi = fmaxf(q, t1);
    const float t = lo < 0.0f ? hi : lo;
    if (discr >= 0.0f && hi >= 0.0f && q != 0.0f && t >= 0.0f && t < h.t) {
      h.t = t;
      h.obj = s.P + i;
      if (NEED_NORMAL) h.n = normalize(sub(add(o, scale(d, t)), {cx, cy, cz}));
    }
  }
  return h;
}

__device__ __forceinline__ float solid_angle(float dist, float rad) {
  const float x = fminf(fmaxf(rad / fmaxf(dist, 1e-30f), 0.0f), 1.0f);
  // x^2/(1+sqrt(1-x^2)) == 1-sqrt(1-x^2) without the cancellation that
  // rounds the solid angle to 0 for far-grazing x
  const float omega = TWO_PI * (x * x) / (1.0f + safe_sqrt(1.0f - x * x));
  return dist < rad ? 4.0f * PI : omega;
}

// sum over lights of the solid-angle pdf of the light the continuation ray
// hit, seen from the previous vertex (not the vertex's own object)
template <class C>
__device__ float light_pdf_from(const C& c, const Layout& s, V3 pos, int prev_obj, int hit_obj) {
  float pdf = 0.0f;
  for (int li = 0; li < s.L; ++li) {
    const float* r = s.lights + li * LI;
    const int obj_id = static_cast<int>(c.ld(r + 7));
    if (hit_obj == obj_id && prev_obj != obj_id) {
      const V3 delta = sub({c.ld(r), c.ld(r + 1), c.ld(r + 2)}, pos);
      pdf = pdf + 1.0f / solid_angle(safe_sqrt(dot(delta, delta)), c.ld(r + 3));
    }
  }
  return pdf;
}

// What one vertex's NEE needs from the surface it shades.
struct Shade {
  V3 pos, normal, refl, md, ms;
  float mexp, eps;
  int obj;
  bool lam, ph;
};

// One light's NEE term: solid-angle sample, shadow trace, per-light MIS
// weight scale / (pdf_b + pdf_l). The shadow ray is traced only where the
// term can be nonzero.
template <class C>
__device__ V3 nee_light(const C& c, const Layout& s, const Shade& sh, const float* __restrict__ r, float u1, float u2,
                        float u3, float scale_) {
  const float rad = c.ld(r + 3);
  const float sx = rad * sqrtf(u1) * cosf(TWO_PI * u2);
  const float sy = rad * sqrtf(u1) * sinf(TWO_PI * u2);
  const float sz = safe_sqrt(rad * rad - sx * sx - sy * sy) * sinf(PI * (u3 - 0.5f));
  const V3 ctr = {c.ld(r), c.ld(r + 1), c.ld(r + 2)};
  const V3 dl = normalize(sub(add(ctr, {sx, sy, sz}), sh.pos));
  const V3 delta = sub(ctr, sh.pos);
  const float dist = safe_sqrt(dot(delta, delta));
  const float pdf_l = 1.0f / solid_angle(dist, rad);
  const int obj_id = static_cast<int>(c.ld(r + 7));
  const float cosl = dot(sh.normal, dl);
  const float lobe_l = (sh.mexp + 1.0f) / TWO_PI * safe_pow(fmaxf(dot(sh.refl, dl), 0.0f), sh.mexp);
  const float pdf_b_l = sh.lam ? cosl / PI : (sh.ph ? lobe_l : 0.0f);
  const V3 zero = {0.0f, 0.0f, 0.0f};
  const V3 fcos_l = sh.lam ? scale(sh.md, fmaxf(cosl, 0.0f) / PI)
                           : (sh.ph ? scale(sh.ms, lobe_l * fmaxf(cosl, 0.0f)) : zero);
  bool ok = sh.obj != obj_id && pdf_b_l != 0.0f && pdf_l > 0.0f;
  if (ok) ok = trace<false>(c, s, add(sh.pos, scale(dl, sh.eps)), dl).obj == obj_id;
  const float wl = ok ? scale_ / (pdf_b_l + pdf_l) : 0.0f;
  return scale(mul(fcos_l, {c.ld(r + 4), c.ld(r + 5), c.ld(r + 6)}), wl);
}

// Permutation-trick tangent frame (planes and spheres alike).
__device__ __forceinline__ void tangent_frame(V3 n, V3& tangent, V3& binormal) {
  const float smallest = fminf(n.z, fminf(n.x, n.y));
  const bool mx = n.x == smallest;
  const bool my = n.y == smallest;
  V3 t = mx ? V3{0.0f, -n.z, n.y} : (my ? V3{-n.z, 0.0f, n.x} : V3{-n.y, n.x, 0.0f});
  const bool flat = fabsf(n.y) < 0.9f;
  const V3 up = {flat ? 0.0f : 1.0f, flat ? 1.0f : 0.0f, 0.0f};
  if (dot(t, t) < 1e-12f) t = cross(n, up);
  tangent = normalize(t);
  binormal = cross(n, tangent);
}

// The walk of one lane's samples sample .. end - 1, every radiance term
// handed to acc.take(term) in the order K1's running sum adds it (miss,
// NEE sum, emission). Every float expression is the plain twin's.
template <class C, class Acc>
__device__ __forceinline__ void walk(const C& c, const MegaParams& p, const Layout& s, int lane_i, int sample,
                                     const int end, Acc& acc) {
  const uint32_t lane = static_cast<uint32_t>(lane_i);
  const float* cam = s.bg + 3;
  const V3 bg = {c.ld(s.bg), c.ld(s.bg + 1), c.ld(s.bg + 2)};
  const V3 origin0 = {c.ld(cam), c.ld(cam + 1), c.ld(cam + 2)};
  const V3 p1 = {c.ld(cam + 3), c.ld(cam + 4), c.ld(cam + 5)};
  const V3 du = {c.ld(cam + 6), c.ld(cam + 7), c.ld(cam + 8)};
  const V3 dv = {c.ld(cam + 9), c.ld(cam + 10), c.ld(cam + 11)};

  const float px = static_cast<float>(lane_i % p.width);
  const float py = static_cast<float>(lane_i / p.width);
  const float fgrid = static_cast<float>(p.grid_n);
  const float fw = static_cast<float>(p.width);
  const float fh = static_cast<float>(p.height);

  // stratified camera ray of sample `sample`
  auto camera_ray = [&](int sample, V3& o, V3& d) {
    const float gx = static_cast<float>(sample % p.grid_n);
    const float gy = static_cast<float>(sample / p.grid_n);
    uint32_t w[4];
    pcg4d(lane, static_cast<uint32_t>(sample), CAM_SALT, p.seed, w);
    const float u1 = unit(w[0]), u2 = unit(w[1]);
    const float sx = (px + (gx + u1) / fgrid) / fw;
    const float sy = ((fh - py) + (gy + u2) / fgrid) / fh;
    d = normalize(sub(add(p1, add(scale(du, sx), scale(dv, sy))), origin0));
    o = origin0;
  };

  int depth = 0;
  V3 o, d;
  camera_ray(sample, o, d);
  const V3 one = {1.0f, 1.0f, 1.0f};
  V3 t3 = one;
  bool emit = true, misp = false, pdelta = false;
  float ppdf = 1.0f;
  V3 pfcos = one;
  int prev_obj = -1;
  V3 prev_pos = {0.0f, 0.0f, 0.0f};

  // a path ends: next sample, fresh camera ray and state
  auto regenerate = [&]() {
    ++sample;
    depth = 0;
    t3 = one;
    emit = true;
    misp = false;
    ppdf = 1.0f;
    pfcos = one;
    pdelta = false;
    prev_obj = -1;
    prev_pos = {0.0f, 0.0f, 0.0f};
    if (sample < end) camera_ray(sample, o, d);
  };

  while (sample < end) {
    Uniforms us = {lane, static_cast<uint32_t>(sample), static_cast<uint32_t>(depth) * static_cast<uint32_t>(p.ncalls),
                   p.seed, -1, {0.0f, 0.0f, 0.0f, 0.0f}};
    const Hit h = trace<true>(c, s, o, d);
    const bool was_hit = h.obj >= 0;
    const V3 pos_hit = add(o, scale(d, was_hit ? h.t : 0.0f));

    // deferred MIS weight from the previous vertex
    float pdf_l_vis = s.L ? light_pdf_from(c, s, prev_pos, prev_obj, h.obj) : 0.0f;
    if (c.full_mis() && pdelta) pdf_l_vis = 0.0f;
    const float denom = pdf_l_vis + ppdf;
    const float w = 1.0f / (denom == 0.0f ? 1.0f : denom);
    if (misp) t3 = mul(t3, scale(pfcos, w));

    if (!was_hit) {  // miss -> background, and the path ends
      acc.take(mul(t3, bg));
      regenerate();
      continue;
    }

    const float* m = s.mats + h.obj * MA;
    const V3 md = {c.ld(m), c.ld(m + 1), c.ld(m + 2)};
    const V3 ms = {c.ld(m + 3), c.ld(m + 4), c.ld(m + 5)};
    const V3 me = {c.ld(m + 6), c.ld(m + 7), c.ld(m + 8)};
    const V3 mt = {c.ld(m + 9), c.ld(m + 10), c.ld(m + 11)};
    const float mexp = c.ld(m + 12);
    const float mior = c.ld(m + 13);

    // Russian roulette (+ depth limit)
    const float p_rr = fmaxf(fmaxf(fmaxf(md.x, ms.x), fmaxf(md.y, ms.y)),
                             fmaxf(fmaxf(md.z, ms.z), fmaxf(fmaxf(mt.x, mt.y), mt.z)));
    const bool cont = p_rr > 0.0f && us(0) <= p_rr;
    const float prob_rr = cont ? p_rr : 1.0f - p_rr;
    t3 = scale(t3, 1.0f / prob_rr);
    const V3 tk = t3;
    const bool emitter = emit;
    const bool survive = cont && depth < p.max_depth;

    // BSDF lottery
    const float sum_d = md.x + md.y + md.z;
    const float sum_s = ms.x + ms.y + ms.z;
    const float sum_t = mt.x + mt.y + mt.z;
    const float total = sum_d + sum_s + sum_t;
    const float p_t = total > 0.0f ? sum_t / (total == 0.0f ? 1.0f : total) : 0.0f;
    const bool transmit = p_t > 0.0f && us(1) <= p_t;
    const float prob_t = transmit ? p_t : 1.0f - p_t;
    if (survive) t3 = scale(t3, 1.0f / prob_t);
    const float dsum = sum_d + sum_s;
    const float p_d = dsum > 0.0f ? sum_d / (dsum == 0.0f ? 1.0f : dsum) : 0.0f;
    const bool diffc = p_d > 0.0f && us(2) <= p_d;
    const float prob_d = diffc ? p_d : 1.0f - p_d;
    if (survive && !transmit) t3 = scale(t3, 1.0f / prob_d);

    const bool m_trans = survive && transmit;
    const bool m_lam = survive && !transmit && diffc;
    const bool m_ph = survive && !transmit && !diffc && mexp > 0.0f;
    const bool m_mir = survive && !transmit && !diffc && mexp <= 0.0f;
    const bool scatter = m_lam || m_ph || m_mir;

    const V3 view = d;
    const V3 normal = h.n;
    const V3 refl = reflect(view, normal);

    if (c.nee() && scatter) {
      const Shade sh = {pos_hit, normal, refl, md, ms, mexp, p.eps, h.obj, m_lam, m_ph};
      V3 nee;
      if (c.one_light()) {
        // one uniformly chosen light, scaled by L: us[5] selects, us[6..8] sample
        const int li = min(static_cast<int>(us(5) * static_cast<float>(s.L)), s.L - 1);
        nee = nee_light(c, s, sh, s.lights + li * LI, us(6), us(7), us(8), static_cast<float>(s.L));
      } else {
        nee = {0.0f, 0.0f, 0.0f};
        for (int li = 0; li < s.L; ++li)
          nee = add(nee,
                    nee_light(c, s, sh, s.lights + li * LI, us(5 + 3 * li), us(6 + 3 * li), us(7 + 3 * li), 1.0f));
      }
      acc.take(mul(t3, nee));
    }

    // continuation sample: only the branch the lottery chose is evaluated
    const float u1 = us(3), u2 = us(4);
    const V3 zero = {0.0f, 0.0f, 0.0f};
    V3 new_d = refl, fcos;
    float pdf_b = 1.0f;
    if (m_trans) {
      const float cos_a = dot(view, normal);
      const bool entering = cos_a < 0.0f;
      const V3 n_eff = entering ? normal : scale(normal, -1.0f);
      const float eta = entering ? 1.0f / mior : mior;
      const float ci = dot(view, n_eff);
      const float kk = 1.0f - eta * eta * (1.0f - ci * ci);
      const V3 refr = sub(scale(view, eta), scale(n_eff, eta * ci + safe_sqrt(kk)));
      new_d = kk < 0.0f ? reflect(view, n_eff) : refr;
      fcos = ms;
    } else if (m_lam) {
      V3 tangent, binormal;
      tangent_frame(normal, tangent, binormal);
      const float rl = sqrtf(u1);
      const float phi = u2 * 2.0f * PI;
      const float lz = safe_sqrt(1.0f - u1);
      new_d = add(add(scale(tangent, rl * cosf(phi)), scale(binormal, rl * sinf(phi))), scale(normal, lz));
      pdf_b = lz / PI;
      fcos = scale(md, fmaxf(dot(normal, new_d), 0.0f) / PI);
    } else if (m_ph) {
      const float phi = u2 * 2.0f * PI;
      V3 uax = cross({0.0f, 0.0f, 1.0f}, refl);
      const bool degen = dot(uax, uax) < 1e-12f;
      uax = normalize(degen ? cross({0.0f, 1.0f, 0.0f}, refl) : uax);
      const V3 vax = cross(uax, refl);
      const float cos_ph = safe_pow(u1, 1.0f / (mexp + 1.0f));
      const float sin_ph = safe_sqrt(1.0f - cos_ph * cos_ph);
      new_d = add(add(scale(uax, sin_ph * cosf(phi)), scale(vax, sin_ph * sinf(phi))), scale(refl, cos_ph));
      pdf_b = (mexp + 1.0f) / TWO_PI * safe_pow(cos_ph, mexp);
      const float lobe_c = (mexp + 1.0f) / TWO_PI * safe_pow(fmaxf(dot(refl, new_d), 0.0f), mexp);
      fcos = scale(ms, lobe_c * fmaxf(dot(normal, new_d), 0.0f));
    } else {  // mirror, or a path that did not survive
      fcos = dot(normal, new_d) > 0.0f ? ms : zero;
    }

    if (m_trans) t3 = mul(t3, fcos);
    if (emitter) acc.take(mul(survive ? t3 : tk, me));
    bool continuing = survive && (m_trans || pdf_b != 0.0f);
    if (p.regen_threshold > 0.0f && continuing)
      continuing = fmaxf(fmaxf(t3.x, t3.y), t3.z) >= p.regen_threshold;

    if (!continuing) {
      regenerate();
      continue;
    }
    o = add(pos_hit, scale(new_d, p.eps));
    d = new_d;
    ++depth;
    if (scatter) emit = p.emit_after_scatter != 0;
    misp = scatter;
    ppdf = scatter ? pdf_b : 1.0f;
    pfcos = scatter ? fcos : one;
    pdelta = m_mir;
    prev_obj = scatter ? h.obj : -1;
    prev_pos = scatter ? pos_hit : zero;
  }
}

// a lane's running RGB sum, K1's r3
struct RunningSum {
  V3 r;
  __device__ void take(V3 t) { r = add(r, t); }
};

// The scene the walk reads: the packed buffer itself, or its copy in the
// first floats of the CTA's dynamic shared memory (the caller synchronises).
template <class C>
__device__ __forceinline__ Layout scene(const C&, const float* __restrict__ scn, float* sm, const MegaParams& p) {
  if (!C::staged) return layout(scn, p);
  const int n = scene_floats(p);
  for (int k = threadIdx.x; k < n; k += blockDim.x) sm[k] = __ldg(scn + k);
  return layout(sm, p);
}

// One thread a lane, walking its eff samples in series (one bounce call
// site: a thread whose path ended starts its next sample at once).
template <class C>
__global__ void __launch_bounds__(kBlock, kLaneCtas) megakernel_lanes(const float* __restrict__ scn,
                                                                     float* __restrict__ out, const MegaParams p,
                                                                     const C c) {
  extern __shared__ float sm[];
  const Layout s = scene(c, scn, sm, p);
  if (C::staged) __syncthreads();
  const int n = p.n_lanes;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  RunningSum acc = {{0.0f, 0.0f, 0.0f}};
  walk(c, p, s, p.lane0 + idx, 0, p.eff, acc);
  out[idx] = acc.r.x;
  out[n + idx] = acc.r.y;
  out[2 * n + idx] = acc.r.z;
}

// a block's radiance terms: the lane's first block sums them in order, a
// later one logs them to its column of the CTA's log
struct TermLog {
  float* col;  // entry (channel c, term k) at col[(c * terms + k) * stride]
  int terms, stride, k;
  bool logging;
  V3 sum;
  __device__ void take(V3 t) {
    if (logging) {
      col[k * stride] = t.x;
      col[(terms + k) * stride] = t.y;
      col[(2 * terms + k) * stride] = t.z;
      ++k;
    } else {
      sum = add(sum, t);
    }
  }
};

// One thread a (lane, sample) block of the plan q (sample_plan.cuh): each
// thread walks its block, the first block of a lane keeps the running sum,
// the later ones log their terms, and one thread per (lane, channel)
// continues the sum over the logs in (sample, term) order, wave by wave.
template <class C>
__global__ void __launch_bounds__(kBlock, kItemCtas) megakernel_items(const float* __restrict__ scn,
                                                                    float* __restrict__ out, const MegaParams p,
                                                                    const sample_plan::Plan q, const C c) {
  extern __shared__ float sm[];
  const Layout s = scene(c, scn, sm, p);
  const int nt = q.threads, T = q.log_terms;
  float* logs = sm + (C::staged ? staged_floats(p) : 0);                  // [3][T][nt]
  float* sums = logs + 3 * T * nt;                                        // [3][nt]: the blocks' own sums
  int* counts = reinterpret_cast<int*>(sums + 3 * nt);                    // [nt]
  float* run = reinterpret_cast<float*>(counts + nt);                     // [3][lanes_per_cta]: running sums
  const int units = 3 * q.lanes_per_cta;                                  // (lane, channel) sums
  for (int u = threadIdx.x; u < units; u += nt) run[u] = 0.0f;
  if (C::staged) __syncthreads();

  const int t = threadIdx.x;
  const int idx = blockIdx.x * q.lanes_per_cta + t / q.wave;
  for (int w = 0; w < q.waves; ++w) {
    const int block = w * q.wave + t % q.wave;
    TermLog hk = {logs + t, T, nt, 0, block > 0, {0.0f, 0.0f, 0.0f}};
    const int sample = block * q.per_block;
    const int end = min(sample + q.per_block, p.eff);
    if (idx < p.n_lanes && sample < end) walk(c, p, s, p.lane0 + idx, sample, end, hk);
    counts[t] = hk.k;
    sums[t] = hk.sum.x;
    sums[nt + t] = hk.sum.y;
    sums[2 * nt + t] = hk.sum.z;
    __syncthreads();  // the wave's sums and logs are complete (and run's zeros in place)
    for (int u = t; u < units; u += nt) {
      const int l = u / 3, ch = u % 3;
      float v = run[u];
      for (int j = 0; j < q.wave && w * q.wave + j < q.blocks; ++j) {
        const int thread = l * q.wave + j;
        if (w == 0 && j == 0) {
          v = sums[ch * nt + thread];  // the first block's own running sum
        } else {
          const float* col = logs + ch * T * nt + thread;
          const int n_terms = counts[thread];
          for (int k = 0; k < n_terms; ++k) v = v + col[k * nt];
        }
      }
      run[u] = v;
    }
    __syncthreads();  // the logs are read before the next wave writes them
  }
  const int n = p.n_lanes;
  for (int u = t; u < units; u += nt) {
    const int i = blockIdx.x * q.lanes_per_cta + u / 3, ch = u % 3;
    if (i < n) out[ch * n + i] = run[u];
  }
}

sample_plan::Plan k1_plan(const MegaParams& p) {
  return sample_plan::plan(p.n_lanes, p.eff, p.max_depth, kResidentThreads, kThreadFloats, kLaneFloats);
}

template <class K>
int allow_shared(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// Launch the regime the plan picks with the configuration C.
template <class C>
int launch(const float* scn, float* out, const MegaParams& p, const C& c, cudaStream_t stream) {
  const int staged = C::staged ? staged_floats(p) * static_cast<int>(sizeof(float)) : 0;
  const sample_plan::Plan q = k1_plan(p);
  if (q.threads > 0 && q.blocks > 1) {
    const int bytes = staged + q.shared;
    const int err = allow_shared(megakernel_items<C>, bytes);
    if (err) return err;
    const int blocks = (p.n_lanes + q.lanes_per_cta - 1) / q.lanes_per_cta;
    megakernel_items<C><<<blocks, q.threads, bytes, stream>>>(scn, out, p, q, c);
  } else {
    const int blocks = (p.n_lanes + kBlock - 1) / kBlock;
    megakernel_lanes<C><<<blocks, kBlock, staged, stream>>>(scn, out, p, c);
  }
  return 0;
}

template <bool STAGED>
int launch_scene(const float* scn, float* out, const MegaParams& p, cudaStream_t stream) {
  const bool fm = p.full_mis != 0;
  if (p.rigid) {
    if (!p.nee_on) return launch(scn, out, p, Fixed<true, 0, STAGED>{fm}, stream);
    if (!p.one_light) return launch(scn, out, p, Fixed<true, 1, STAGED>{fm}, stream);
    return launch(scn, out, p, Fixed<true, 2, STAGED>{fm}, stream);
  }
  if (!p.nee_on) return launch(scn, out, p, Fixed<false, 0, STAGED>{fm}, stream);
  if (!p.one_light) return launch(scn, out, p, Fixed<false, 1, STAGED>{fm}, stream);
  return launch(scn, out, p, Fixed<false, 2, STAGED>{fm}, stream);
}

}  // namespace

// Launch one pass on `stream`: out[3, n_lanes] receives the RGB sums of lanes
// lane0 .. lane0 + n_lanes - 1. Returns cudaGetLastError() (0 on success).
extern "C" int kajo_megakernel(const float* scene, float* out, const MegaParams* params, void* stream) {
  const MegaParams p = *params;
  if (p.n_lanes > 0 && p.eff > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    // staged where the scene fits in 16 KB and, a thread a sample, beside
    // the plan's logs in a CTA's shared memory
    const sample_plan::Plan q = k1_plan(p);
    const size_t logs = q.threads > 0 && q.blocks > 1 ? static_cast<size_t>(q.shared) : 0;
    const bool stage = scene_floats(p) <= kStageFloats &&
                       logs + staged_floats(p) * sizeof(float) <= sample_plan::kSharedLimit;
    const int err = stage ? launch_scene<true>(scene, out, p, st) : launch_scene<false>(scene, out, p, st);
    if (err) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's plan constants (sample_plan::constants) into out[5].
extern "C" void kajo_megakernel_plan_constants(int* out) {
  sample_plan::constants(out, kResidentThreads, kThreadFloats, kLaneFloats);
}
