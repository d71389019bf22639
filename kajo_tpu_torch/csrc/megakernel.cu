// The fused path-tracing pass for Hopper (sm_90a): one thread per lane.
//
// Replaces kajo_tpu/ops/pallas/megakernel.py:_build_kernel (jvp=False), the
// Pallas TPU kernel behind render_pass_megakernel and
// render_passes_megakernel. Each lane (one pixel) runs the whole
// regenerating path-trace loop on its own: stratified camera ray, nearest
// hit over planes and spheres (rigid 4-float or general 23-float records),
// Russian roulette, the 4-BSDF lottery, next-event estimation over all lights
// or one, the deferred MIS weight, emission and background, until it has
// taken its eff = floor(sqrt(spp))^2 samples. The plain PyTorch twin is
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
// once per pass. The design does the TPU kernel's masked lane loop as SIMT
// branches: a lane computes only the branch it takes, the shadow trace runs
// only where its NEE term can be nonzero, and a lane exits when its own
// samples are done instead of waiting for its tile. The scene is one packed
// f32 buffer in global memory; every thread of a warp reads the same record
// at the same time, so a read is a broadcast served from L1. (At 512 general
// objects the buffer is ~77 KB, above the 64 KB of __constant__; staging it
// in shared memory, occupancy tuning and scene-specialised builds are later,
// measured optimisations.) Scene sizes and estimator knobs are runtime
// parameters, so one build serves every scene.
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
  int P, S, L;
  bool rigid;
};

struct Hit {
  float t;
  int obj;
  V3 n;
};

// General-transform sphere hit: object-space stable quadratic with
// determinant-scaled t; the normal is the object-space hit point rotated by
// the forward matrix, normalized.
__device__ __forceinline__ bool sphere_hit_general(const float* __restrict__ rec, V3 o, V3 d, float& t_out,
                                                   V3& n_out, bool need_normal) {
  float r[SPG];
#pragma unroll
  for (int j = 0; j < 14; ++j) r[j] = __ldg(rec + j);
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
    for (int j = 14; j < SPG; ++j) r[j] = __ldg(rec + j);
    const V3 nl = {ox + dx * t_loc, oy + dy * t_loc, oz + dz * t_loc};
    n_out = normalize({r[14] * nl.x + r[15] * nl.y + r[16] * nl.z, r[17] * nl.x + r[18] * nl.y + r[19] * nl.z,
                       r[20] * nl.x + r[21] * nl.y + r[22] * nl.z});
  }
  return valid;
}

// Nearest hit over planes then spheres; a later object needs a strictly
// smaller t. NEED_NORMAL=false for shadow rays, which use only the object.
template <bool NEED_NORMAL>
__device__ Hit trace(const Layout& s, V3 o, V3 d) {
  Hit h = {BIG, -1, {0.0f, 0.0f, 0.0f}};
  for (int i = 0; i < s.P; ++i) {
    const float* r = s.planes + i * PL;
    const float r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
    const float denom = d.x * r0 + d.y * r1 + d.z * r2;
    const float onum = o.x * r0 + o.y * r1 + o.z * r2 + __ldg(r + 3);
    const float t_loc = -onum / (denom == 0.0f ? 1.0f : denom);
    const float t = t_loc * __ldg(r + 4);
    if (fabsf(denom) >= FLT_EPS && t_loc >= 0.0f && t >= 0.0f && t < h.t) {
      h.t = t;
      h.obj = i;
      if (NEED_NORMAL) h.n = {__ldg(r + 5), __ldg(r + 6), __ldg(r + 7)};
    }
  }
  if (!s.rigid) {
    for (int i = 0; i < s.S; ++i) {
      float t;
      V3 n;
      if (sphere_hit_general(s.spheres + i * SPG, o, d, t, n, NEED_NORMAL) && t < h.t) {
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
    const float cx = __ldg(r), cy = __ldg(r + 1), cz = __ldg(r + 2), r2 = __ldg(r + 3);
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
__device__ float light_pdf_from(const Layout& s, V3 pos, int prev_obj, int hit_obj) {
  float pdf = 0.0f;
  for (int li = 0; li < s.L; ++li) {
    const float* r = s.lights + li * LI;
    const int obj_id = static_cast<int>(__ldg(r + 7));
    if (hit_obj == obj_id && prev_obj != obj_id) {
      const V3 delta = sub({__ldg(r), __ldg(r + 1), __ldg(r + 2)}, pos);
      pdf = pdf + 1.0f / solid_angle(safe_sqrt(dot(delta, delta)), __ldg(r + 3));
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
__device__ V3 nee_light(const Layout& s, const Shade& sh, const float* __restrict__ r, float u1, float u2, float u3,
                        float scale_) {
  const float rad = __ldg(r + 3);
  const float sx = rad * sqrtf(u1) * cosf(TWO_PI * u2);
  const float sy = rad * sqrtf(u1) * sinf(TWO_PI * u2);
  const float sz = safe_sqrt(rad * rad - sx * sx - sy * sy) * sinf(PI * (u3 - 0.5f));
  const V3 c = {__ldg(r), __ldg(r + 1), __ldg(r + 2)};
  const V3 dl = normalize(sub(add(c, {sx, sy, sz}), sh.pos));
  const V3 delta = sub(c, sh.pos);
  const float dist = safe_sqrt(dot(delta, delta));
  const float pdf_l = 1.0f / solid_angle(dist, rad);
  const int obj_id = static_cast<int>(__ldg(r + 7));
  const float cosl = dot(sh.normal, dl);
  const float lobe_l = (sh.mexp + 1.0f) / TWO_PI * safe_pow(fmaxf(dot(sh.refl, dl), 0.0f), sh.mexp);
  const float pdf_b_l = sh.lam ? cosl / PI : (sh.ph ? lobe_l : 0.0f);
  const V3 zero = {0.0f, 0.0f, 0.0f};
  const V3 fcos_l = sh.lam ? scale(sh.md, fmaxf(cosl, 0.0f) / PI)
                           : (sh.ph ? scale(sh.ms, lobe_l * fmaxf(cosl, 0.0f)) : zero);
  bool ok = sh.obj != obj_id && pdf_b_l != 0.0f && pdf_l > 0.0f;
  if (ok) ok = trace<false>(s, add(sh.pos, scale(dl, sh.eps)), dl).obj == obj_id;
  const float wl = ok ? scale_ / (pdf_b_l + pdf_l) : 0.0f;
  return scale(mul(fcos_l, {__ldg(r + 4), __ldg(r + 5), __ldg(r + 6)}), wl);
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

__global__ void __launch_bounds__(kBlock) megakernel(const float* __restrict__ scn, float* __restrict__ out,
                                                     const MegaParams p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.n_lanes) return;
  const int lane_i = p.lane0 + idx;
  const uint32_t lane = static_cast<uint32_t>(lane_i);

  Layout s;
  s.P = p.n_planes;
  s.S = p.n_spheres;
  s.L = p.n_lights;
  s.rigid = p.rigid != 0;
  s.planes = scn;
  s.spheres = s.planes + s.P * PL;
  s.mats = s.spheres + s.S * (s.rigid ? SP : SPG);
  s.lights = s.mats + (s.P + s.S) * MA;
  const float* bgp = s.lights + s.L * LI;
  const float* cam = bgp + 3;
  const V3 bg = {__ldg(bgp), __ldg(bgp + 1), __ldg(bgp + 2)};
  const V3 origin0 = {__ldg(cam), __ldg(cam + 1), __ldg(cam + 2)};
  const V3 p1 = {__ldg(cam + 3), __ldg(cam + 4), __ldg(cam + 5)};
  const V3 du = {__ldg(cam + 6), __ldg(cam + 7), __ldg(cam + 8)};
  const V3 dv = {__ldg(cam + 9), __ldg(cam + 10), __ldg(cam + 11)};

  const float px = static_cast<float>(lane_i % p.width);
  const float py = static_cast<float>(lane_i / p.width);
  const float fgrid = static_cast<float>(p.grid_n);
  const float fw = static_cast<float>(p.width);
  const float fh = static_cast<float>(p.height);
  const int eff = p.eff;

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

  int sample = 0, depth = 0;
  V3 o, d;
  camera_ray(0, o, d);
  const V3 one = {1.0f, 1.0f, 1.0f};
  V3 t3 = one, r3 = {0.0f, 0.0f, 0.0f};
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
    if (sample < eff) camera_ray(sample, o, d);
  };

  while (sample < eff) {
    Uniforms us = {lane, static_cast<uint32_t>(sample), static_cast<uint32_t>(depth) * static_cast<uint32_t>(p.ncalls),
                   p.seed, -1, {0.0f, 0.0f, 0.0f, 0.0f}};
    const Hit h = trace<true>(s, o, d);
    const bool was_hit = h.obj >= 0;
    const V3 pos_hit = add(o, scale(d, was_hit ? h.t : 0.0f));

    // deferred MIS weight from the previous vertex
    float pdf_l_vis = s.L ? light_pdf_from(s, prev_pos, prev_obj, h.obj) : 0.0f;
    if (p.full_mis && pdelta) pdf_l_vis = 0.0f;
    const float denom = pdf_l_vis + ppdf;
    const float w = 1.0f / (denom == 0.0f ? 1.0f : denom);
    if (misp) t3 = mul(t3, scale(pfcos, w));

    if (!was_hit) {  // miss -> background, and the path ends
      r3 = add(r3, mul(t3, bg));
      regenerate();
      continue;
    }

    const float* m = s.mats + h.obj * MA;
    const V3 md = {__ldg(m), __ldg(m + 1), __ldg(m + 2)};
    const V3 ms = {__ldg(m + 3), __ldg(m + 4), __ldg(m + 5)};
    const V3 me = {__ldg(m + 6), __ldg(m + 7), __ldg(m + 8)};
    const V3 mt = {__ldg(m + 9), __ldg(m + 10), __ldg(m + 11)};
    const float mexp = __ldg(m + 12);
    const float mior = __ldg(m + 13);

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

    if (p.nee_on && scatter) {
      const Shade sh = {pos_hit, normal, refl, md, ms, mexp, p.eps, h.obj, m_lam, m_ph};
      V3 nee;
      if (p.one_light) {
        // one uniformly chosen light, scaled by L: us[5] selects, us[6..8] sample
        const int li = min(static_cast<int>(us(5) * static_cast<float>(s.L)), s.L - 1);
        nee = nee_light(s, sh, s.lights + li * LI, us(6), us(7), us(8), static_cast<float>(s.L));
      } else {
        nee = {0.0f, 0.0f, 0.0f};
        for (int li = 0; li < s.L; ++li)
          nee = add(nee, nee_light(s, sh, s.lights + li * LI, us(5 + 3 * li), us(6 + 3 * li), us(7 + 3 * li), 1.0f));
      }
      r3 = add(r3, mul(t3, nee));
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
    if (emitter) r3 = add(r3, mul(survive ? t3 : tk, me));
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

  out[idx] = r3.x;
  out[p.n_lanes + idx] = r3.y;
  out[2 * p.n_lanes + idx] = r3.z;
}

}  // namespace

// Launch one pass on `stream`: out[3, n_lanes] receives the RGB sums of lanes
// lane0 .. lane0 + n_lanes - 1. Returns cudaGetLastError() (0 on success).
extern "C" int kajo_megakernel(const float* scene, float* out, const MegaParams* params, void* stream) {
  const MegaParams p = *params;
  if (p.n_lanes > 0) {
    const int blocks = (p.n_lanes + kBlock - 1) / kBlock;
    megakernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(scene, out, p);
  }
  return static_cast<int>(cudaGetLastError());
}
