// The path walk of the gradient kernels (K2, K3, K4), templated on its
// scalar: float (K3, K4's discovery walk), Dual, a value with its
// forward-mode tangent (K2), or Dual4, a value with four tangents (K4's
// replays: the four directions of one sphere in one walk).
//
// It is the walk of csrc/megakernel.cu (K1) written once more: K1 built on
// this file computes the same bits but took 0.2-2.6% longer per pass on an
// H100 (PERF.md), so it keeps its own copy. Every float expression is
// written in the order of the plain PyTorch version
// (kajo_tpu_torch/ops/megakernel.py:trace_lanes_plain) and of K1, so the
// float walk equals both bit for bit, and the value part of a Dual walk
// rounds as the float walk does: K2's image equals K1's bit for bit. Every
// branch and comparison takes the value; min, max and selects carry the
// tangent of the branch taken (ties split it, as JAX's max does); the coin
// probabilities use the value only (they are detached); safe_sqrt and
// safe_pow keep the JAX package's clamped derivatives
// (kajo_tpu/ops/pallas/megakernel.py:125-157). A Dual walk finds the
// nearest object on values alone (visibility is discrete) and then
// recomputes the winner's distance and normal as Duals, so a tangent costs
// one hit, not one per object; shadow rays are traced on values (detached).
//
// A kernel supplies two policies:
//  * a Reader, which returns a scene field as a scalar: the packed value,
//    and for a Dual its tangent (K2: the packed tangent; K4: the four
//    one-hot directions of one sphere's records);
//  * Hooks, told of each radiance term and of the events Path Replay needs
//    (K2 sums the terms; K3 peels them off R_rem; K4 sums g . d(term)).
//
// Build with -fmad=false and no fast math (kajo_tpu_torch/ops/_nvcc.py).

#pragma once

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

namespace walk {

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
constexpr float TWO_PI = 2.0f * PI;
constexpr uint32_t CAM_SALT = 0x7FFFFFFFu;

// ------------------------------------------------------------- scalars
struct Dual {
  float v, d;
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator+(Dual a, float b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return {a + b.v, b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float v = a.v / b.v;
  return {v, (a.d - v * b.d) / b.v};
}
__device__ __forceinline__ Dual operator/(Dual a, float b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float v = a / b.v;
  return {v, -(v * b.d) / b.v};
}

template <class T>
__device__ __forceinline__ T mk(float v);
template <>
__device__ __forceinline__ float mk<float>(float v) { return v; }
template <>
__device__ __forceinline__ Dual mk<Dual>(float v) { return {v, 0.0f}; }

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }

__device__ __forceinline__ float safe_sqrt(float x) { return sqrtf(fmaxf(x, 0.0f)); }
// JAX's clamped rule: exact for x > 1e-12, 0 for x <= 0
__device__ __forceinline__ Dual safe_sqrt(Dual x) {
  const float slope = x.v > 0.0f ? 0.5f * rsqrtf(fmaxf(x.v, 1e-12f)) : 0.0f;
  return {safe_sqrt(x.v), slope * x.d};
}

// x**n as exp(n log x); 0 for x <= 0, except 1 when n == 0
__device__ __forceinline__ float safe_pow(float x, float n) {
  if (x > 0.0f) return expf(n * logf(x));
  return n == 0.0f ? 1.0f : 0.0f;
}
// d/dx = n x^(n-1), d/dn = x^n log x for x > 0, else 0 (underflow-safe)
__device__ __forceinline__ Dual safe_pow(Dual x, Dual n) {
  const float y = safe_pow(x.v, n.v);
  float dx = 0.0f, dn = 0.0f;
  if (x.v > 0.0f) {
    dx = n.v * safe_pow(x.v, n.v - 1.0f);
    dn = y * logf(x.v);
  }
  return {y, dx * x.d + dn * n.d};
}

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ Dual rsqrt_(Dual x) {
  const float r = rsqrtf(x.v);
  return {r, x.d * (-0.5f * (r / x.v))};
}

__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float fmin_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ Dual fmax_(Dual a, Dual b) {
  return {fmaxf(a.v, b.v), a.v > b.v ? a.d : (a.v < b.v ? b.d : 0.5f * (a.d + b.d))};
}
__device__ __forceinline__ Dual fmin_(Dual a, Dual b) {
  return {fminf(a.v, b.v), a.v < b.v ? a.d : (a.v > b.v ? b.d : 0.5f * (a.d + b.d))};
}
__device__ __forceinline__ Dual fmax_(Dual a, float b) {
  return {fmaxf(a.v, b), a.v > b ? a.d : (a.v < b ? 0.0f : 0.5f * a.d)};
}
__device__ __forceinline__ Dual fmin_(Dual a, float b) {
  return {fminf(a.v, b), a.v < b ? a.d : (a.v > b ? 0.0f : 0.5f * a.d)};
}

// A value with N tangents (K4: the four directions cx, cy, cz, r^2 of one
// sphere in one walk). Each tangent component takes exactly the float
// operations of Dual's, so component k rounds as a Dual walk seeded with
// direction k would; the value is computed once.
template <int N>
struct DualN {
  float v;
  float d[N];
};

template <int N>
__device__ __forceinline__ DualN<N> operator+(DualN<N> a, DualN<N> b) {
  DualN<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator+(DualN<N> a, float b) {
  DualN<N> r;
  r.v = a.v + b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator+(float a, DualN<N> b) {
  DualN<N> r;
  r.v = a + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator-(DualN<N> a, DualN<N> b) {
  DualN<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator-(DualN<N> a, float b) {
  DualN<N> r;
  r.v = a.v - b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator-(float a, DualN<N> b) {
  DualN<N> r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator-(DualN<N> a) {
  DualN<N> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator*(DualN<N> a, DualN<N> b) {
  DualN<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator*(DualN<N> a, float b) {
  DualN<N> r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b;
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator*(float a, DualN<N> b) {
  DualN<N> r;
  r.v = a * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a * b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator/(DualN<N> a, DualN<N> b) {
  DualN<N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator/(DualN<N> a, float b) {
  DualN<N> r;
  r.v = a.v / b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / b;
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> operator/(float a, DualN<N> b) {
  DualN<N> r;
  r.v = a / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -(r.v * b.d[k]) / b.v;
  return r;
}

using Dual4 = DualN<4>;

template <>
__device__ __forceinline__ Dual4 mk<Dual4>(float v) {
  return {v, {0.0f, 0.0f, 0.0f, 0.0f}};
}

template <int N>
__device__ __forceinline__ float val(DualN<N> x) {
  return x.v;
}

template <int N>
__device__ __forceinline__ DualN<N> safe_sqrt(DualN<N> x) {
  const float slope = x.v > 0.0f ? 0.5f * rsqrtf(fmaxf(x.v, 1e-12f)) : 0.0f;
  DualN<N> r;
  r.v = safe_sqrt(x.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = slope * x.d[k];
  return r;
}

template <int N>
__device__ __forceinline__ DualN<N> safe_pow(DualN<N> x, DualN<N> n) {
  DualN<N> r;
  r.v = safe_pow(x.v, n.v);
  float dx = 0.0f, dn = 0.0f;
  if (x.v > 0.0f) {
    dx = n.v * safe_pow(x.v, n.v - 1.0f);
    dn = r.v * logf(x.v);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = dx * x.d[k] + dn * n.d[k];
  return r;
}

template <int N>
__device__ __forceinline__ DualN<N> rsqrt_(DualN<N> x) {
  DualN<N> r;
  r.v = rsqrtf(x.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = x.d[k] * (-0.5f * (r.v / x.v));
  return r;
}

// the tangent of the branch taken; a tie splits it (0.5 (a + b), per component)
template <int N>
__device__ __forceinline__ DualN<N> pick(bool take_a, bool take_b, DualN<N> a, DualN<N> b, float v) {
  DualN<N> r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = take_a ? a.d[k] : (take_b ? b.d[k] : 0.5f * (a.d[k] + b.d[k]));
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> fmax_(DualN<N> a, DualN<N> b) {
  return pick(a.v > b.v, a.v < b.v, a, b, fmaxf(a.v, b.v));
}
template <int N>
__device__ __forceinline__ DualN<N> fmin_(DualN<N> a, DualN<N> b) {
  return pick(a.v < b.v, a.v > b.v, a, b, fminf(a.v, b.v));
}
template <int N>
__device__ __forceinline__ DualN<N> fmax_(DualN<N> a, float b) {
  DualN<N> r;
  r.v = fmaxf(a.v, b);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.v > b ? a.d[k] : (a.v < b ? 0.0f : 0.5f * a.d[k]);
  return r;
}
template <int N>
__device__ __forceinline__ DualN<N> fmin_(DualN<N> a, float b) {
  DualN<N> r;
  r.v = fminf(a.v, b);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.v < b ? a.d[k] : (a.v > b ? 0.0f : 0.5f * a.d[k]);
  return r;
}

// ------------------------------------------------------------- vectors
template <class T>
struct V3 {
  T x, y, z;
};

template <class T>
__device__ __forceinline__ V3<T> add(V3<T> a, V3<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <class T>
__device__ __forceinline__ V3<T> sub(V3<T> a, V3<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <class T, class S>
__device__ __forceinline__ V3<T> scale(V3<T> a, S s) {
  return {a.x * s, a.y * s, a.z * s};
}
template <class T>
__device__ __forceinline__ V3<T> mul(V3<T> a, V3<T> b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
template <class T>
__device__ __forceinline__ T dot(V3<T> a, V3<T> b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <class T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
template <class T>
__device__ __forceinline__ V3<T> vconst(float x, float y, float z) {
  return {mk<T>(x), mk<T>(y), mk<T>(z)};
}
__device__ __forceinline__ V3<float> val3(V3<float> a) { return a; }
__device__ __forceinline__ V3<float> val3(V3<Dual> a) { return {a.x.v, a.y.v, a.z.v}; }
template <int N>
__device__ __forceinline__ V3<float> val3(V3<DualN<N>> a) {
  return {a.x.v, a.y.v, a.z.v};
}

// unit vector; 0 for a zero vector
template <class T>
__device__ __forceinline__ V3<T> normalize(V3<T> a) {
  const T n2 = dot(a, a);
  if (!(val(n2) > 0.0f)) return vconst<T>(0.0f, 0.0f, 0.0f);
  return scale(a, rsqrt_(n2));
}

template <class T>
__device__ __forceinline__ V3<T> reflect(V3<T> v, V3<T> n) {
  return sub(v, scale(n, 2.0f * dot(n, v)));
}

// --------------------------------------------------------------- PCG4D
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

// ---------------------------------------------------------------- scene
struct Layout {
  const float* __restrict__ planes;
  const float* __restrict__ spheres;
  const float* __restrict__ mats;
  const float* __restrict__ lights;
  const float* __restrict__ bg;
  const float* __restrict__ cam;
  int P, S, L;
  bool rigid;
};

__device__ __forceinline__ Layout layout(const float* scn, const MegaParams& p) {
  Layout s;
  s.P = p.n_planes;
  s.S = p.n_spheres;
  s.L = p.n_lights;
  s.rigid = p.rigid != 0;
  s.planes = scn;
  s.spheres = s.planes + s.P * PL;
  s.mats = s.spheres + s.S * (s.rigid ? SP : SPG);
  s.lights = s.mats + (s.P + s.S) * MA;
  s.bg = s.lights + s.L * LI;
  s.cam = s.bg + 3;
  return s;
}

__device__ __forceinline__ int light_obj(const Layout& s, int li) {
  return static_cast<int>(__ldg(s.lights + li * LI + 7));
}

// Reads the packed values: the float walks.
struct ValueReader {
  Layout s;
  __device__ float plane(int i, int f) const { return __ldg(s.planes + i * PL + f); }
  __device__ float sphere(int i, int f) const { return __ldg(s.spheres + i * (s.rigid ? SP : SPG) + f); }
  __device__ float mat(int i, int f) const { return __ldg(s.mats + i * MA + f); }
  __device__ float light(int i, int f) const { return __ldg(s.lights + i * LI + f); }
  __device__ float bg(int f) const { return __ldg(s.bg + f); }
  __device__ float cam(int f) const { return __ldg(s.cam + f); }
};

// ------------------------------------------------------------ the trace
struct Hit {
  float t;
  int obj;
  V3<float> n;
};

// General-transform sphere hit: object-space stable quadratic with
// determinant-scaled t; the normal is the object-space hit point rotated by
// the forward matrix, normalized. rec(f) reads field f of the record.
template <class T, class Rec>
__device__ __forceinline__ bool sphere_hit_general(const Rec& rec, V3<T> o, V3<T> d, T& t_out, V3<T>& n_out,
                                                   bool need_normal) {
  T r[SPG];
#pragma unroll
  for (int j = 0; j < 14; ++j) r[j] = rec(j);
  const T ox = r[0] * o.x + r[1] * o.y + r[2] * o.z + r[9];
  const T oy = r[3] * o.x + r[4] * o.y + r[5] * o.z + r[10];
  const T oz = r[6] * o.x + r[7] * o.y + r[8] * o.z + r[11];
  const T dx = r[0] * d.x + r[1] * d.y + r[2] * d.z;
  const T dy = r[3] * d.x + r[4] * d.y + r[5] * d.z;
  const T dz = r[6] * d.x + r[7] * d.y + r[8] * d.z;
  const T r2 = r[12], det = r[13];
  const T a = dx * dx + dy * dy + dz * dz;
  const T b = 2.0f * (dx * ox + dy * oy + dz * oz);
  const T cq = ox * ox + oy * oy + oz * oz - r2;
  const T discr = b * b - 4.0f * a * cq;
  const T sq = safe_sqrt(discr);
  const T q = val(b) < 0.0f ? (-b - sq) * 0.5f : (-b + sq) * 0.5f;
  const T t0 = q / (val(a) == 0.0f ? mk<T>(1.0f) : a);
  const T t1 = cq / (val(q) == 0.0f ? mk<T>(1.0f) : q);
  const T lo = fmin_(t0, t1);
  const T hi = fmax_(t0, t1);
  const T t_loc = val(lo) < 0.0f ? hi : lo;
  const T t = t_loc * det;
  t_out = t;
  const bool valid = (val(discr) >= 0.0f) && (val(hi) >= 0.0f) && (val(a) != 0.0f) && (val(q) != 0.0f) &&
                     (val(t) >= 0.0f);
  if (valid && need_normal) {
#pragma unroll
    for (int j = 14; j < SPG; ++j) r[j] = rec(j);
    const V3<T> nl = {ox + dx * t_loc, oy + dy * t_loc, oz + dz * t_loc};
    n_out = normalize(V3<T>{r[14] * nl.x + r[15] * nl.y + r[16] * nl.z, r[17] * nl.x + r[18] * nl.y + r[19] * nl.z,
                            r[20] * nl.x + r[21] * nl.y + r[22] * nl.z});
  }
  return valid;
}

struct GlobalRecord {
  const float* __restrict__ rec;
  __device__ float operator()(int f) const { return __ldg(rec + f); }
};

// Nearest hit over planes then spheres, on values; a later object needs a
// strictly smaller t. NEED_NORMAL=false for shadow rays.
template <bool NEED_NORMAL>
__device__ Hit trace(const Layout& s, V3<float> o, V3<float> d) {
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
      V3<float> n;
      if (sphere_hit_general<float>(GlobalRecord{s.spheres + i * SPG}, o, d, t, n, NEED_NORMAL) && t < h.t) {
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
      if (NEED_NORMAL) h.n = normalize(sub(add(o, scale(d, t)), V3<float>{cx, cy, cz}));
    }
  }
  return h;
}

template <class T, class R>
struct ReaderRecord {
  const R& rd;
  int i;
  __device__ T operator()(int f) const { return rd.sphere(i, f); }
};

// Distance and normal of the known winner ``obj`` in the scalar type, with
// the trace's expressions (so the value equals the trace's to the bit).
template <class T, class R>
__device__ void hit_at(const Layout& s, const R& rd, int obj, V3<T> o, V3<T> d, T& t, V3<T>& n) {
  if (obj < s.P) {
    const T r0 = rd.plane(obj, 0), r1 = rd.plane(obj, 1), r2 = rd.plane(obj, 2);
    const T denom = d.x * r0 + d.y * r1 + d.z * r2;
    const T onum = o.x * r0 + o.y * r1 + o.z * r2 + rd.plane(obj, 3);
    const T t_loc = -onum / (val(denom) == 0.0f ? mk<T>(1.0f) : denom);
    t = t_loc * rd.plane(obj, 4);
    n = {rd.plane(obj, 5), rd.plane(obj, 6), rd.plane(obj, 7)};
    return;
  }
  const int i = obj - s.P;
  if (!s.rigid) {
    sphere_hit_general<T>(ReaderRecord<T, R>{rd, i}, o, d, t, n, true);
    return;
  }
  const T d_dot_o = dot(d, o);
  const T o2 = dot(o, o);
  const T cx = rd.sphere(i, 0), cy = rd.sphere(i, 1), cz = rd.sphere(i, 2), r2 = rd.sphere(i, 3);
  const T d_dot_c = d.x * cx + d.y * cy + d.z * cz;
  const T o_dot_c = o.x * cx + o.y * cy + o.z * cz;
  const T b = 2.0f * (d_dot_o - d_dot_c);
  const T cq = o2 - 2.0f * o_dot_c + (cx * cx + cy * cy + cz * cz - r2);
  const T discr = b * b - 4.0f * cq;
  const T sq = safe_sqrt(discr);
  const T q = val(b) < 0.0f ? (-b - sq) * 0.5f : (-b + sq) * 0.5f;
  const T t1 = cq / (val(q) == 0.0f ? mk<T>(1.0f) : q);
  const T lo = fmin_(q, t1);
  const T hi = fmax_(q, t1);
  t = val(lo) < 0.0f ? hi : lo;
  n = normalize(sub(add(o, scale(d, t)), V3<T>{cx, cy, cz}));
}

// The object a path ray hits first (-1: none), with its distance and normal
// in the scalar type: on floats the trace's own, on Duals the winner's
// recomputed by hit_at.
template <class R>
__device__ __forceinline__ int nearest(const Layout& s, const R&, V3<float> o, V3<float> d, float& t, V3<float>& n) {
  const Hit h = trace<true>(s, o, d);
  t = h.t;
  n = h.n;
  return h.obj;
}
template <class R>
__device__ __forceinline__ int nearest(const Layout& s, const R& rd, V3<Dual> o, V3<Dual> d, Dual& t, V3<Dual>& n) {
  const int obj = trace<false>(s, val3(o), val3(d)).obj;
  if (obj >= 0) hit_at(s, rd, obj, o, d, t, n);
  return obj;
}
template <class R, int N>
__device__ __forceinline__ int nearest(const Layout& s, const R& rd, V3<DualN<N>> o, V3<DualN<N>> d, DualN<N>& t,
                                       V3<DualN<N>>& n) {
  const int obj = trace<false>(s, val3(o), val3(d)).obj;
  if (obj >= 0) hit_at(s, rd, obj, o, d, t, n);
  return obj;
}

template <class T>
__device__ __forceinline__ T solid_angle(T dist, T rad) {
  const T x = fmin_(fmax_(rad / fmax_(dist, 1e-30f), 0.0f), 1.0f);
  // x^2/(1+sqrt(1-x^2)) == 1-sqrt(1-x^2) without the cancellation that
  // rounds the solid angle to 0 for far-grazing x
  const T omega = TWO_PI * (x * x) / (1.0f + safe_sqrt(1.0f - x * x));
  return val(dist) < val(rad) ? mk<T>(4.0f * PI) : omega;
}

// sum over lights of the solid-angle pdf of the light the continuation ray
// hit, seen from the previous vertex (not the vertex's own object)
template <class T, class R>
__device__ T light_pdf_from(const Layout& s, const R& rd, V3<T> pos, int prev_obj, int hit_obj) {
  T pdf = mk<T>(0.0f);
  for (int li = 0; li < s.L; ++li) {
    const int obj_id = light_obj(s, li);
    if (hit_obj == obj_id && prev_obj != obj_id) {
      const V3<T> delta = sub(V3<T>{rd.light(li, 0), rd.light(li, 1), rd.light(li, 2)}, pos);
      pdf = pdf + 1.0f / solid_angle(safe_sqrt(dot(delta, delta)), rd.light(li, 3));
    }
  }
  return pdf;
}

// Permutation-trick tangent frame (planes and spheres alike).
template <class T>
__device__ __forceinline__ void tangent_frame(V3<T> n, V3<T>& tangent, V3<T>& binormal) {
  const float smallest = fminf(val(n.z), fminf(val(n.x), val(n.y)));
  const bool mx = val(n.x) == smallest;
  const bool my = val(n.y) == smallest;
  const T zero = mk<T>(0.0f);
  V3<T> t = mx ? V3<T>{zero, -n.z, n.y} : (my ? V3<T>{-n.z, zero, n.x} : V3<T>{-n.y, n.x, zero});
  const bool flat = fabsf(val(n.y)) < 0.9f;
  const V3<T> up = vconst<T>(flat ? 0.0f : 1.0f, flat ? 1.0f : 0.0f, 0.0f);
  if (val(dot(t, t)) < 1e-12f) t = cross(n, up);
  tangent = normalize(t);
  binormal = cross(n, tangent);
}

// ---------------------------------------------------------------- a path
template <class T>
struct State {
  V3<T> o, d, t3;     // ray, throughput
  T ppdf;             // pending BSDF pdf of the deferred MIS weight
  V3<T> pfcos;        // pending f cos of the deferred MIS weight
  V3<T> prev_pos;     // the previous scattering vertex
  int depth, prev_obj;
  bool emit, misp, pdelta;
};

template <class T, class R>
__device__ void camera_ray(const MegaParams& p, const R& rd, uint32_t lane, int sample, V3<T>& o, V3<T>& d) {
  const int lane_i = static_cast<int>(lane);
  const float px = static_cast<float>(lane_i % p.width);
  const float py = static_cast<float>(lane_i / p.width);
  const float fgrid = static_cast<float>(p.grid_n);
  const float fw = static_cast<float>(p.width);
  const float fh = static_cast<float>(p.height);
  const float gx = static_cast<float>(sample % p.grid_n);
  const float gy = static_cast<float>(sample / p.grid_n);
  uint32_t w[4];
  pcg4d(lane, static_cast<uint32_t>(sample), CAM_SALT, p.seed, w);
  const float u1 = unit(w[0]), u2 = unit(w[1]);
  const float sx = (px + (gx + u1) / fgrid) / fw;
  const float sy = ((fh - py) + (gy + u2) / fgrid) / fh;
  const V3<T> origin0 = {rd.cam(0), rd.cam(1), rd.cam(2)};
  const V3<T> p1 = {rd.cam(3), rd.cam(4), rd.cam(5)};
  const V3<T> du = {rd.cam(6), rd.cam(7), rd.cam(8)};
  const V3<T> dv = {rd.cam(9), rd.cam(10), rd.cam(11)};
  d = normalize(sub(add(p1, add(scale(du, sx), scale(dv, sy))), origin0));
  o = origin0;
}

// A fresh walk of sample ``sample`` from the camera.
template <class T, class R>
__device__ void start(const MegaParams& p, const R& rd, uint32_t lane, int sample, State<T>& st) {
  const V3<T> one = vconst<T>(1.0f, 1.0f, 1.0f);
  st.depth = 0;
  st.t3 = one;
  st.emit = true;
  st.misp = false;
  st.ppdf = mk<T>(1.0f);
  st.pfcos = one;
  st.pdelta = false;
  st.prev_obj = -1;
  st.prev_pos = vconst<T>(0.0f, 0.0f, 0.0f);
  if (sample < p.eff) camera_ray(p, rd, lane, sample, st.o, st.d);
}

// What one vertex's NEE needs from the surface it shades.
template <class T>
struct Shade {
  V3<T> pos, normal, refl, md, ms, t3;
  T mexp;
  int obj;
  bool lam, ph;
};

// One light's NEE term: solid-angle sample, shadow trace (on values), per-
// light MIS weight scale / (pdf_b + pdf_l). The shadow ray is traced only
// where the term can be nonzero.
template <class T, class R, class H>
__device__ V3<T> nee_light(const MegaParams& p, const Layout& s, const R& rd, H& hk, const Shade<T>& sh, int li,
                           float u1, float u2, float u3, float scale_) {
  const T rad = rd.light(li, 3);
  const T sx = rad * sqrtf(u1) * cosf(TWO_PI * u2);
  const T sy = rad * sqrtf(u1) * sinf(TWO_PI * u2);
  const T sz = safe_sqrt(rad * rad - sx * sx - sy * sy) * sinf(PI * (u3 - 0.5f));
  const V3<T> c = {rd.light(li, 0), rd.light(li, 1), rd.light(li, 2)};
  const V3<T> dl = normalize(sub(add(c, V3<T>{sx, sy, sz}), sh.pos));
  const V3<T> delta = sub(c, sh.pos);
  const T dist = safe_sqrt(dot(delta, delta));
  const T pdf_l = 1.0f / solid_angle(dist, rad);
  const int obj_id = light_obj(s, li);
  const T cosl = dot(sh.normal, dl);
  const T lobe_l = (sh.mexp + 1.0f) / TWO_PI * safe_pow(fmax_(dot(sh.refl, dl), 0.0f), sh.mexp);
  const T zero = mk<T>(0.0f);
  const T pdf_b_l = sh.lam ? cosl / PI : (sh.ph ? lobe_l : zero);
  // f cos = colour * s_sel, linear in the colour
  const T s_sel = sh.lam ? fmax_(cosl, 0.0f) / PI : (sh.ph ? lobe_l * fmax_(cosl, 0.0f) : zero);
  const V3<T> fcos_l = sh.lam ? scale(sh.md, s_sel) : (sh.ph ? scale(sh.ms, s_sel) : V3<T>{zero, zero, zero});
  bool ok = sh.obj != obj_id && val(pdf_b_l) != 0.0f && val(pdf_l) > 0.0f;
  if (ok) {
    const V3<float> dlv = val3(dl);
    ok = trace<false>(s, add(val3(sh.pos), scale(dlv, p.eps)), dlv).obj == obj_id;
  }
  const T wl = ok ? scale_ / (pdf_b_l + pdf_l) : zero;
  const V3<T> le = {rd.light(li, 4), rd.light(li, 5), rd.light(li, 6)};
  hk.nee_light(li, obj_id, ok, sh, wl, fcos_l, s_sel, le);
  return scale(mul(fcos_l, le), wl);
}

// One vertex of the walk: trace, the deferred MIS weight, background or
// shading (roulette, lottery, NEE, continuation, emission). Hands every
// radiance term to the hooks; returns whether the path goes on, and then
// advances ``st`` to the next vertex (the caller restarts it otherwise).
template <class T, class R, class H>
__device__ bool bounce(const MegaParams& p, const Layout& s, const R& rd, H& hk, uint32_t lane, int sample,
                       State<T>& st) {
  Uniforms us = {lane, static_cast<uint32_t>(sample),
                 static_cast<uint32_t>(st.depth) * static_cast<uint32_t>(p.ncalls), p.seed, -1,
                 {0.0f, 0.0f, 0.0f, 0.0f}};
  const V3<T> zero3 = vconst<T>(0.0f, 0.0f, 0.0f);
  const V3<T> one3 = vconst<T>(1.0f, 1.0f, 1.0f);
  T t_hit = mk<T>(0.0f);
  V3<T> normal = zero3;
  const int obj = nearest(s, rd, st.o, st.d, t_hit, normal);
  const bool was_hit = obj >= 0;
  hk.hit(obj);
  const V3<T> pos_hit = add(st.o, scale(st.d, was_hit ? t_hit : mk<T>(0.0f)));

  // deferred MIS weight from the previous vertex
  T pdf_l_vis = s.L ? light_pdf_from(s, rd, st.prev_pos, st.prev_obj, obj) : mk<T>(0.0f);
  if (p.full_mis && st.pdelta) pdf_l_vis = mk<T>(0.0f);
  const T denom = pdf_l_vis + st.ppdf;
  const T w = 1.0f / (val(denom) == 0.0f ? mk<T>(1.0f) : denom);
  if (st.misp) {
    hk.deferred();
    st.t3 = mul(st.t3, scale(st.pfcos, w));
  }

  if (!was_hit) {  // miss -> background, and the path ends
    hk.miss(st.t3, mul(st.t3, V3<T>{rd.bg(0), rd.bg(1), rd.bg(2)}));
    return false;
  }

  const V3<T> md = {rd.mat(obj, 0), rd.mat(obj, 1), rd.mat(obj, 2)};
  const V3<T> ms = {rd.mat(obj, 3), rd.mat(obj, 4), rd.mat(obj, 5)};
  const V3<T> me = {rd.mat(obj, 6), rd.mat(obj, 7), rd.mat(obj, 8)};
  const V3<float> mt = {val(rd.mat(obj, 9)), val(rd.mat(obj, 10)), val(rd.mat(obj, 11))};
  const T mexp = rd.mat(obj, 12);
  const T mior = rd.mat(obj, 13);
  const V3<float> mdv = val3(md), msv = val3(ms);

  // Russian roulette (+ depth limit); the coin probabilities are values
  const float p_rr = fmaxf(fmaxf(fmaxf(mdv.x, msv.x), fmaxf(mdv.y, msv.y)),
                           fmaxf(fmaxf(mdv.z, msv.z), fmaxf(fmaxf(mt.x, mt.y), mt.z)));
  const bool cont = p_rr > 0.0f && us(0) <= p_rr;
  const float prob_rr = cont ? p_rr : 1.0f - p_rr;
  st.t3 = scale(st.t3, 1.0f / prob_rr);
  const V3<T> tk = st.t3;
  const bool emitter = st.emit;
  const bool survive = cont && st.depth < p.max_depth;

  // BSDF lottery
  const float sum_d = mdv.x + mdv.y + mdv.z;
  const float sum_s = msv.x + msv.y + msv.z;
  const float sum_t = mt.x + mt.y + mt.z;
  const float total = sum_d + sum_s + sum_t;
  const float p_t = total > 0.0f ? sum_t / (total == 0.0f ? 1.0f : total) : 0.0f;
  const bool transmit = p_t > 0.0f && us(1) <= p_t;
  const float prob_t = transmit ? p_t : 1.0f - p_t;
  if (survive) st.t3 = scale(st.t3, 1.0f / prob_t);
  const float dsum = sum_d + sum_s;
  const float p_d = dsum > 0.0f ? sum_d / (dsum == 0.0f ? 1.0f : dsum) : 0.0f;
  const bool diffc = p_d > 0.0f && us(2) <= p_d;
  const float prob_d = diffc ? p_d : 1.0f - p_d;
  if (survive && !transmit) st.t3 = scale(st.t3, 1.0f / prob_d);

  const bool m_trans = survive && transmit;
  const bool m_lam = survive && !transmit && diffc;
  const bool m_ph = survive && !transmit && !diffc && val(mexp) > 0.0f;
  const bool m_mir = survive && !transmit && !diffc && val(mexp) <= 0.0f;
  const bool scatter = m_lam || m_ph || m_mir;

  const V3<T> view = st.d;
  const V3<T> refl = reflect(view, normal);

  if (p.nee_on && scatter) {
    const Shade<T> sh = {pos_hit, normal, refl, md, ms, st.t3, mexp, obj, m_lam, m_ph};
    V3<T> nee;
    if (p.one_light) {
      // one uniformly chosen light, scaled by L: us[5] selects, us[6..8] sample
      const int li = min(static_cast<int>(us(5) * static_cast<float>(s.L)), s.L - 1);
      nee = nee_light(p, s, rd, hk, sh, li, us(6), us(7), us(8), static_cast<float>(s.L));
    } else {
      nee = zero3;
      for (int li = 0; li < s.L; ++li)
        nee = add(nee, nee_light(p, s, rd, hk, sh, li, us(5 + 3 * li), us(6 + 3 * li), us(7 + 3 * li), 1.0f));
    }
    hk.nee_sum(mul(st.t3, nee));
  }

  // continuation sample: only the branch the lottery chose is evaluated;
  // f cos = (m_lam ? diffuse : specular) * s_cont
  const float u1 = us(3), u2 = us(4);
  V3<T> new_d = refl, fcos;
  T pdf_b = mk<T>(1.0f);
  if (m_trans) {
    const T cos_a = dot(view, normal);
    const bool entering = val(cos_a) < 0.0f;
    const V3<T> n_eff = entering ? normal : scale(normal, -1.0f);
    const T eta = entering ? 1.0f / mior : mior;
    const T ci = dot(view, n_eff);
    const T kk = 1.0f - eta * eta * (1.0f - ci * ci);
    const V3<T> refr = sub(scale(view, eta), scale(n_eff, eta * ci + safe_sqrt(kk)));
    new_d = val(kk) < 0.0f ? reflect(view, n_eff) : refr;
    fcos = ms;
  } else if (m_lam) {
    V3<T> tangent, binormal;
    tangent_frame(normal, tangent, binormal);
    const float rl = sqrtf(u1);
    const float phi = u2 * 2.0f * PI;
    const float lz = safe_sqrt(1.0f - u1);
    new_d = add(add(scale(tangent, rl * cosf(phi)), scale(binormal, rl * sinf(phi))), scale(normal, lz));
    pdf_b = mk<T>(lz / PI);
    fcos = scale(md, fmax_(dot(normal, new_d), 0.0f) / PI);
  } else if (m_ph) {
    const float phi = u2 * 2.0f * PI;
    V3<T> uax = cross(vconst<T>(0.0f, 0.0f, 1.0f), refl);
    const bool degen = val(dot(uax, uax)) < 1e-12f;
    uax = normalize(degen ? cross(vconst<T>(0.0f, 1.0f, 0.0f), refl) : uax);
    const V3<T> vax = cross(uax, refl);
    const T cos_ph = safe_pow(mk<T>(u1), 1.0f / (mexp + 1.0f));
    const T sin_ph = safe_sqrt(1.0f - cos_ph * cos_ph);
    new_d = add(add(scale(uax, sin_ph * cosf(phi)), scale(vax, sin_ph * sinf(phi))), scale(refl, cos_ph));
    pdf_b = (mexp + 1.0f) / TWO_PI * safe_pow(cos_ph, mexp);
    const T lobe_c = (mexp + 1.0f) / TWO_PI * safe_pow(fmax_(dot(refl, new_d), 0.0f), mexp);
    fcos = scale(ms, lobe_c * fmax_(dot(normal, new_d), 0.0f));
  } else {  // mirror, or a path that did not survive
    fcos = val(dot(normal, new_d)) > 0.0f ? ms : zero3;
  }

  if (m_trans) {
    hk.transmit(obj, ms);
    st.t3 = mul(st.t3, fcos);
  }
  if (emitter) {
    const V3<T> t_em = survive ? st.t3 : tk;
    hk.emission(obj, t_em, mul(t_em, me));
  }
  bool continuing = survive && (m_trans || val(pdf_b) != 0.0f);
  if (p.regen_threshold > 0.0f && continuing)
    continuing = fmaxf(fmaxf(val(st.t3.x), val(st.t3.y)), val(st.t3.z)) >= p.regen_threshold;
  hk.vertex_end(scatter && continuing, m_lam, obj, m_lam ? md : ms);

  if (!continuing) return false;
  st.o = add(pos_hit, scale(new_d, p.eps));
  st.d = new_d;
  ++st.depth;
  if (scatter) st.emit = p.emit_after_scatter != 0;
  st.misp = scatter;
  st.ppdf = scatter ? pdf_b : mk<T>(1.0f);
  st.pfcos = scatter ? fcos : one3;
  st.pdelta = m_mir;
  st.prev_obj = scatter ? obj : -1;
  st.prev_pos = scatter ? pos_hit : zero3;
  return true;
}

// Hooks that take no part: a kernel's own hooks derive from it and replace
// what they need.
struct NoHooks {
  __device__ void hit(int) {}
  __device__ void deferred() {}
  template <class V>
  __device__ void miss(const V&, const V&) {}
  template <class T, class V>
  __device__ void nee_light(int, int, bool, const Shade<T>&, T, const V&, T, const V&) {}
  template <class V>
  __device__ void nee_sum(const V&) {}
  template <class V>
  __device__ void transmit(int, const V&) {}
  template <class V>
  __device__ void emission(int, const V&, const V&) {}
  template <class V>
  __device__ void vertex_end(bool, bool, int, const V&) {}
};

}  // namespace walk
