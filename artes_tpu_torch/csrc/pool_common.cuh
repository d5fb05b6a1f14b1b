// Device code shared by the photon-transport kernels pool_radial.cu (radial
// grids, closed-form walks), pool_grid3d.cu (3-D grids, jump walks and the
// marching cell_face walk) and pool_march.cu (Lambert surfaces and flow
// diagnostics, marching walks): the table layouts, the threefry draw schedule,
// the closed-form shell-chord optical depth, the Stokes algebra, the
// scattering-angle samplers, the detector peel, the tallies' booking, the
// error records and the Stokes-anomaly check, the flow diagnostics'
// accumulators and the block reduction. Every function lives in an anonymous
// namespace, so each translation unit that includes this file gets its own
// copy.
//
// Formulas follow the XLA forms of artes_tpu/transport/kernel.py (acosf for
// the peel angle, the f32 sincos_2beta polynomial inside the azimuth Newton
// loop, exact trig after it). Build without --use_fast_math: the f32 guards
// rely on IEEE expf/logf/sqrtf and on denormals.

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// One launch of a pool kernel: every input and output of it, by name, the
// same for the three kernels (pool_cuda.PoolLaunch mirrors it field for
// field; tests/test_torch_launch_abi.py holds the two alike). Each kernel's
// entry points, artes_<k>_launch(PoolLaunch*, stream), artes_<k>_blocks(const
// PoolLaunch*) and artes_<k>_layout(int*), read the fields it needs; a
// pointer a kernel does not read may be null. Per-cell tables are flat over
// (r, theta, phi).
struct PoolLaunch {
  const float* rfront;        // (nr+1,) face radii
  const float* opacity;       // (ncell,) extinction per scaled length
  const float* albedo;        // (ncell,)
  const float* scatter;       // (ncell*180, 16) matrix rows
  const float* prefix;        // (ncell, 4, 181) alpha-CDF prefixes
  const float* p_int;         // (ncell, 4) azimuth integrals
  const float* consts;        // 83 sampling constants
  const float* scal;          // N_SCAL scalars (enum S_*)
  const float* emis_cum;      // (ncell,) emissivity CDF (thermal)
  const float* cell_weight;   // (ncell,) emission weights (thermal)
  const float* theta_tan;     // (nt+1,) the 3-D grid's faces (pool_geom3d.cuh::Grid3)
  const float* theta_cos;     // (nt+1,)
  const int* theta_flags;     // (nt+1,) bit 0 cone, bit 1 theta < pi/2
  const float* phi_sin;       // (np,)
  const float* phi_cos;       // (np,)
  const float* phifront;      // (np,) face azimuths in [0, 2 pi)
  const float* kbar;          // (nr,) the jump tables, read by pool_grid3d only
  const float* dk;            // (ncell,)
  const float* dr;            // (nr-1, nt*np)
  const float* dtt;           // (nt-1, nr*np)
  const float* dpp;           // (np, nr*nt)
  const float* rf2;           // (nr-1,)
  int nr;
  int ntheta;
  int nphi;
  int cell_depth;
  int max_crossings;
  float same_eps;
  float sel2;
  float boundary_tol;
  float surface_albedo;       // pool_march's Lambert surface
  unsigned int n_photons;
  unsigned int key_hi;
  unsigned int id_lo;
  int max_scatter;
  int variant;                // bit 0 thermal, bit 1 image, bit 2 flow
  int flags;                  // F_CRESCENT, F_BIASED, F_DEBUG_STOKES, F_NO_SCATTER
  int nx;
  int ny;
  double* img_sums;           // (nx*ny, N_IMG_D), added into
  unsigned long long* img_counts;  // (nx*ny, N_IMG_I)
  double* out_d;              // N_OUT_D sums
  unsigned long long* out_i;  // the kernel's out_i counters (its layout's slot 2)
  double* flow_g;             // (ncell, 3) flow diagnostics, with flow
  double* flow_t;             // (ncell, 4)
  double* flow_buf;           // flow_buf_blocks copies of both, zeroed, or null
  int flow_buf_blocks;
  float* rec;                 // (rec_cap, REC_W) error records
  unsigned int* rec_count;
  int rec_cap;
  unsigned long long* next_id;    // the persistent grid's photon counter, zeroed
  unsigned long long* counters;   // the kernel's counters, zeroed, or null
  int threads;                // a block
  int blocks;                 // written by the launch: the grid it launched
};

namespace {

constexpr int N_ANGLE = 180;
constexpr int N_FINE = 12;
constexpr int N_COARSE = 15;
constexpr int PREFIX_W = 181;
constexpr float BIG = 1.0e30f;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = (float)(2.0 * 3.14159265358979323846);
constexpr float TWO_PI_CLAMP = (float)(2.0 * 3.14159265358979323846 - 1.0e-10);
constexpr float DEG_F = (float)(3.14159265358979323846 / 180.0);
constexpr float ONE_MINUS_EPS = (float)(1.0 - 1.0e-10);   // rounds to 1.0f
constexpr float U_MIN = 1.17549435e-38f;                   // FLT_MIN
constexpr float U_MAX = 0.99999994f;                       // 1 - 2^-24
constexpr float FOUR_PI_F = (float)(4.0 * 3.14159265358979323846);
constexpr float U_CLIP_LO = 1.0e-4f;                       // thermal birth clip
constexpr float U_CLIP_HI = (float)(1.0 - 1.0e-4);
constexpr int N_SCAL = 32;
constexpr int N_OUT_D = 10;
constexpr int N_OUT_I = 4;
constexpr int N_IMG_D = 8;
constexpr int N_IMG_I = 2;

// scalar table layout (pool_cuda.py builds it)
enum {
  S_FSTOP = 0, S_PMIN = 1, S_XMAX = 2, S_YMAX = 3, S_DET = 4, S_TRIG = 7,
  S_RFLOOR = 11, S_OB = 12, S_UHAT = 15, S_E1 = 18, S_E2 = 21, S_WHAT = 24,
  S_POS_EPS = 27, S_SEL1 = 28, S_TCOS = 29, S_BIAS = 31,
};
// runtime flags of the launch: crescent sampling, Gordon-biased thermal
// emission, the Stokes-anomaly check of --debug-stokes, scattering off
enum { F_CRESCENT = 1, F_BIASED = 2, F_DEBUG_STOKES = 4, F_NO_SCATTER = 8 };
// outcome of a march
enum { M_EXIT = 0, M_INTER = 1, M_FLOOR = 2 };
// constant table layout: beta basis (3 x 17), sin/cos(2 edge) (16 + 16)
enum { C_BASIS = 0, C_SIN2 = 51, C_COS2 = 67 };

struct Tables {
  const float* __restrict__ rfront;    // (nr+1,) face radii
  const float* __restrict__ opacity;   // (nr,) extinction per scaled length
  const float* __restrict__ albedo;    // (nr,)
  const float* __restrict__ scatter;   // (nr*180, 16) matrix rows
  const float* __restrict__ prefix;    // (nr, 4, 181) alpha-CDF prefixes
  const float* __restrict__ p_int;     // (nr, 4) azimuth integrals
  const float* __restrict__ consts;    // 83 sampling constants
  const float* __restrict__ emis_cum;  // (nr,) emissivity CDF (thermal)
  const float* __restrict__ cell_weight;  // (nr,) emission weights (thermal)
  int nr;
};

struct Scal {
  float fstop, pmin, x_max, y_max, rfloor, pos_eps, sel1, bias;
  float det[3], trig[4], ob[3], u_hat[3], e1[3], e2[3], w_hat[3], tcos[2];
};

// the image: (npix, 8) double moments [I, Q, U, V, I^2, Q^2, U^2, V^2] and
// (npix, 2) counts [Stokes-I row (scatter + birth peels), Q/U/V rows]
struct Image {
  double* __restrict__ sums;
  unsigned long long* __restrict__ counts;
  int nx, ny;
};

// ---------------------------------------------------------------- RNG ----

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

__device__ __forceinline__ float bits_to_f32(uint32_t w) {
  float u = __uint_as_float((w >> 9) | 0x3F800000u) - 1.0f;
  return fminf(fmaxf(u, U_MIN), U_MAX);
}

// the six thermal emission draws at sites 0-5: both words of counters 0-2
__device__ __forceinline__ void draws6(uint32_t k0, uint32_t k1, float* out) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    uint32_t w0, w1;
    threefry2x32(k0, k1, (uint32_t)j, 0u, w0, w1);
    out[2 * j] = bits_to_f32(w0);
    out[2 * j + 1] = bits_to_f32(w1);
  }
}

// n (<= 5) float32 draws at sites s .. s+n-1: site s+i is word (s+i)&1 of
// the hash of counter (s+i)>>1, so 3 hashes cover 5 draws
__device__ __forceinline__ void draws(uint32_t k0, uint32_t k1, uint32_t s, int n,
                                      float* out) {
  uint32_t w[6];
  const uint32_t par = s & 1u;
  const int nh = (int)(par + n + 1) / 2;
  for (int j = 0; j < nh; ++j) threefry2x32(k0, k1, (s >> 1) + j, 0u, w[2 * j], w[2 * j + 1]);
  for (int i = 0; i < n; ++i) out[i] = bits_to_f32(w[par + i]);
}

// ------------------------------------------------- closed-form radial ----

// x^2 + y^2 + z^2 rounded as XLA compiles the reference's float32
// expression, fma(z, z, fma(x, x, y y)) (the plain version's geometry.norm2)
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(x, x, __fmul_rn(y, y)));
}

struct Ray {
  float A, Bq, Cq, inv_a, mb, sgn_b;
};

__device__ __forceinline__ Ray make_ray(const Scal& S, const float* p, const float* d) {
  const float a2 = S.ob[0] * S.ob[0], b2 = S.ob[1] * S.ob[1], c2 = S.ob[2] * S.ob[2];
  Ray r;
  r.A = a2 * d[0] * d[0] + b2 * d[1] * d[1] + c2 * d[2] * d[2];
  r.Bq = a2 * p[0] * d[0] + b2 * p[1] * d[1] + c2 * p[2] * d[2];
  r.Cq = a2 * p[0] * p[0] + b2 * p[1] * p[1] + c2 * p[2] * p[2];
  r.inv_a = 1.0f / r.A;
  r.mb = -r.Bq * r.inv_a;
  r.sgn_b = r.Bq >= 0.0f ? 1.0f : -1.0f;
  return r;
}

// stable q-form roots of the face sphere r_face (radial.py ray_chords)
__device__ __forceinline__ bool roots(const Ray& r, float r_face, float& lo, float& hi) {
  const float Cj = r.Cq - r_face * r_face;
  const float disc = r.Bq * r.Bq - r.A * Cj;
  const bool ok = disc > 0.0f;
  const float q = -(r.Bq + r.sgn_b * sqrtf(ok ? disc : 0.0f));
  const float r1 = q * r.inv_a;
  const float r2 = Cj / (q == 0.0f ? 1.0f : q);
  lo = ok ? fminf(r1, r2) : r.mb;
  hi = ok ? fmaxf(r1, r2) : r.mb;
  return ok;
}

__device__ __forceinline__ float face_in(const Ray& r, float rf) {
  float lo, hi;
  roots(r, rf, lo, hi);
  return fmaxf(lo, 0.0f);
}

__device__ __forceinline__ float face_out(const Ray& r, float rf) {
  float lo, hi;
  roots(r, rf, lo, hi);
  return fmaxf(hi, 0.0f);
}

// floor hit: whether the forward path enters the photon-floor sphere, where
__device__ __forceinline__ bool floor_hit(const Ray& r, const Scal& S, float& s_surf) {
  float lo, hi;
  const bool hit = roots(r, S.rfloor, lo, hi) && lo > S.pos_eps;
  s_surf = hit ? lo : BIG;
  return hit;
}

// optical depth to the boundary or the floor (radial.tau_walk)
__device__ float tau_walk(const Tables& T, const Scal& S, const float* p, const float* d,
                          bool& surface_hit) {
  const Ray r = make_ray(S, p, d);
  float s_surf;
  surface_hit = floor_hit(r, S, s_surf);
  float tau = 0.0f;
  float e_hi = face_in(r, __ldg(T.rfront + T.nr));
  for (int m = T.nr - 1; m >= 0; --m) {
    const float e_lo = face_in(r, __ldg(T.rfront + m));
    const float seg = fmaxf(fminf(e_lo, s_surf) - fminf(e_hi, s_surf), 0.0f);
    tau += __ldg(T.opacity + m) * seg;
    e_hi = e_lo;
  }
  if (!surface_hit) {
    float h_lo = face_out(r, __ldg(T.rfront));
    for (int m = 0; m < T.nr; ++m) {
      const float h_hi = face_out(r, __ldg(T.rfront + m + 1));
      tau += __ldg(T.opacity + m) * fmaxf(h_hi - h_lo, 0.0f);
      h_lo = h_hi;
    }
  }
  return tau;
}

// --------------------------------------------------- Stokes algebra ----

__device__ __forceinline__ void rotate_cs(float* st, float c2p, float s2p) {
  const float q = st[1], u = st[2], v = st[3];
  const float qn = c2p * q + s2p * u;
  const float un = -s2p * q + c2p * u;
  const float p_in = sqrtf(q * q + u * u + v * v);
  const float p_out = sqrtf(qn * qn + un * un + v * v);
  const float norm = p_out > 0.0f ? p_in / p_out : 1.0f;
  st[1] = qn * norm;
  st[2] = un * norm;
  st[3] = v * norm;
}

// meridian -> scattering plane -> meridian (mueller.polarization_rotation)
__device__ void polarization_rotation(float alpha, float c2b, float s2b, float beta_sign,
                                      float* st, const float* m, float dz, float dzn,
                                      bool peeling) {
  const float salpha = sqrtf(fmaxf(1.0f - alpha * alpha, 0.0f));
  const float szn = sqrtf(fmaxf(1.0f - dzn * dzn, 0.0f));
  const float denom = salpha * szn;
  const float cb2 = denom == 0.0f
      ? 1.0f : fminf(fmaxf((dz - dzn * alpha) / denom, -1.0f), 1.0f);
  rotate_cs(st, c2b, s2b);
  float sc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    sc[i] = m[4 * i] * st[0] + m[4 * i + 1] * st[1] + m[4 * i + 2] * st[2] + m[4 * i + 3] * st[3];
  if (!peeling) {  // conserve Stokes I across the scattering (:1799-1814)
    const float norm = sc[0] > 0.0f ? st[0] / sc[0] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] *= norm;
  }
  const float c2 = 2.0f * cb2 * cb2 - 1.0f;
  const float s2 = 2.0f * cb2 * sqrtf(fmaxf(1.0f - cb2 * cb2, 0.0f)) * beta_sign;
  rotate_cs(sc, c2, s2);
#pragma unroll
  for (int i = 0; i < 4; ++i) st[i] = sc[i];
}

// matrix at a scattering angle in degrees: rows centred at (i - 0.5) deg
__device__ __forceinline__ void matrix_at(const float* rows, float angle_deg, float* m) {
  const float t = angle_deg - 0.5f;
  const int r0 = min(max((int)floorf(t), 0), N_ANGLE - 2);
  const float frac = fminf(fmaxf(t - (float)r0, 0.0f), 1.0f);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float a = __ldg(rows + r0 * 16 + e);
    const float b = __ldg(rows + (r0 + 1) * 16 + e);
    m[e] = a + (b - a) * frac;
  }
}

__device__ void direction_cosine(float alpha, float beta, const float* d, float* out) {
  const float dx = d[0], dy = d[1], dz = d[2];
  const float sto = sqrtf(fmaxf(1.0f - dz * dz, 0.0f));
  const bool degen = sto < 1.0e-12f;
  const float inv = 1.0f / (degen ? 1.0f : sto);
  const float e1x = degen ? 1.0f : -dz * dx * inv;
  const float e1y = degen ? 0.0f : -dz * dy * inv;
  const float e1z = degen ? 0.0f : sto;
  const float e2x = degen ? 0.0f : -dy * inv;
  const float e2y = degen ? -dz : dx * inv;
  const float salpha = sqrtf(fmaxf(1.0f - alpha * alpha, 0.0f));
  const float cb = cosf(beta), sb = sinf(beta);
  const float nx = alpha * dx + salpha * (cb * e1x + sb * e2x);
  const float ny = alpha * dy + salpha * (cb * e1y + sb * e2y);
  const float nz = alpha * dz + salpha * (cb * e1z);
  const float inv_norm = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz);
  out[0] = nx * inv_norm;
  out[1] = ny * inv_norm;
  out[2] = nz * inv_norm;
}

// ----------------------------------------------------------- sampling ----

__device__ __forceinline__ void sincos_2beta(float delta, float s2lo, float c2lo,
                                             float& s, float& c) {
  const float x = 2.0f * delta;
  const float x2 = x * x;
  const float sx = x * (1.0f + x2 * ((float)(-1.0 / 6.0) + x2 * (float)(1.0 / 120.0)));
  const float cx = 1.0f + x2 * (-0.5f + x2 * ((float)(1.0 / 24.0) - x2 * (float)(1.0 / 720.0)));
  s = s2lo * cx + c2lo * sx;
  c = c2lo * cx - s2lo * sx;
}

// azimuth from the continuous Stokes-weighted CDF (sampling.sample_beta)
__device__ void sample_beta(const Tables& T, int cell, const float* st, float u1, float u2,
                            float& beta, float& c2b, float& s2b) {
  const float* pi4 = T.p_int + 4 * cell;
  const float p11 = __ldg(pi4), p12 = __ldg(pi4 + 1), p13 = __ldg(pi4 + 2), p14 = __ldg(pi4 + 3);
  const float a = p11 * st[0] + p14 * st[3];
  const float b = p12 * st[1] + p13 * st[2];
  const float c = p12 * st[2] - p13 * st[1];
  const float* B = T.consts + C_BASIS;
  const float a_safe = a == 0.0f ? 1.0f : a;
  const float target = u1 * a * PI_F;
  int k = 0;
  for (int j = 1; j < 16; ++j)
    k += (a * __ldg(B + j) + b * __ldg(B + 17 + j) + c * __ldg(B + 34 + j)) < target;
  const float cum_lo = a * __ldg(B + k) + b * __ldg(B + 17 + k) + c * __ldg(B + 34 + k);
  const float cum_hi = a * __ldg(B + k + 1) + b * __ldg(B + 18 + k) + c * __ldg(B + 35 + k);
  const float width = PI_F / 16.0f;
  float lo = (float)k * width;
  float hi = lo + width;
  const float lo0 = lo;
  const float s2lo = __ldg(T.consts + C_SIN2 + k), c2lo = __ldg(T.consts + C_COS2 + k);
  const float dcum = cum_hi - cum_lo;
  beta = lo + width * (dcum > 0.0f ? (target - cum_lo) / dcum : 0.5f);
  const float gp_floor = 1.0e-12f * fabsf(a_safe);
  for (int it = 0; it < 3; ++it) {
    float s2, c2;
    sincos_2beta(beta - lo0, s2lo, c2lo, s2, c2);
    const float g = a * beta + 0.5f * b * s2 + 0.5f * c * (1.0f - c2) - target;
    const float gp = a + b * c2 + c * s2;
    if (g < 0.0f) lo = beta; else hi = beta;
    const float beta_n = beta - g / fmaxf(gp, gp_floor);
    const bool bad = beta_n < lo || beta_n > hi || !isfinite(beta_n);
    beta = bad ? 0.5f * (lo + hi) : beta_n;
  }
  c2b = cosf(2.0f * beta);
  s2b = sinf(2.0f * beta);
  if (u2 > 0.5f) beta += PI_F;   // mirror to the other half-plane
  if (beta >= TWO_PI_F) beta = TWO_PI_CLAMP;
  if (beta <= 0.0f) beta = 1.0e-10f;
}

// scattering-angle cosine, 15 coarse x 12 fine CDF edges (sampling.sample_alpha_fused)
__device__ void sample_alpha(const Tables& T, int cell, const float* st, float c2b,
                             float s2b, float u3, float& alpha, float& alpha_deg) {
  const float w0 = st[0], w1 = c2b * st[1] + s2b * st[2];
  const float w2 = -s2b * st[1] + c2b * st[2], w3 = st[3];
  const float* P = T.prefix + cell * 4 * PREFIX_W;
  auto cum = [&](int i) {
    return w0 * __ldg(P + i) + w1 * __ldg(P + PREFIX_W + i)
         + w2 * __ldg(P + 2 * PREFIX_W + i) + w3 * __ldg(P + 3 * PREFIX_W + i);
  };
  const float target = u3 * cum(N_ANGLE);
  int k1 = 0;
  for (int j = 1; j < N_COARSE; ++j) k1 += cum(N_FINE * j) < target;
  const int base = N_FINE * k1;
  int k2 = 1;
  for (int j = 1; j < N_FINE; ++j) k2 += cum(base + j) < target;
  const float cum_lo = cum(base + k2 - 1), cum_hi = cum(base + k2);
  const float dcum = cum_hi - cum_lo;
  const float frac = dcum == 0.0f ? 0.5f : (target - cum_lo) / dcum;
  alpha_deg = (float)(base + k2 - 1) + frac;
  alpha = fminf(fmaxf(cosf(alpha_deg * DEG_F), -ONE_MINUS_EPS), ONE_MINUS_EPS);
}

// ---------------------------------------------------------------- peel ----

// detector-frame Stokes contribution of a scattering toward the observer
// (kernel._peel_photon_prep)
__device__ void peel_prep(const Tables& T, const Scal& S, const float* d, int cell,
                          const float* st_in, float* contrib) {
  const float* D = S.det;
  const float mu = fminf(fmaxf(d[0] * D[0] + d[1] * D[1] + d[2] * D[2], -ONE_MINUS_EPS),
                         ONE_MINUS_EPS);
  float m[16];
  matrix_at(T.scatter + cell * N_ANGLE * 16, acosf(mu) / DEG_F, m);
  const float dz = d[2];
  const float denom = sqrtf(fmaxf(1.0f - mu * mu, 0.0f)) * sqrtf(fmaxf(1.0f - dz * dz, 0.0f));
  const float num = (D[2] - dz * mu) / (denom == 0.0f ? 1.0f : denom);
  const float cphi = fminf(fmaxf(num, -ONE_MINUS_EPS), ONE_MINUS_EPS);
  const float sign = (d[1] * D[0] - d[0] * D[1]) > 0.0f ? -1.0f : 1.0f;
  const float c2b = 2.0f * cphi * cphi - 1.0f;
  const float s2b = 2.0f * cphi * sqrtf(fmaxf(1.0f - cphi * cphi, 0.0f)) * sign;
  float st[4] = {st_in[0], st_in[1], st_in[2], st_in[3]};
  polarization_rotation(mu, c2b, s2b, sign, st, m, dz, D[2], true);
  contrib[0] = st[0];
  contrib[1] = -st[1];   // detector Q sign flip (ARTES.f90:4956)
  contrib[2] = st[2];
  contrib[3] = st[3];
}

// pixel of a peel origin, -1 outside the image (kernel._pixel_index); the
// single pixel of a spectrum is the image square of half-size x_max
template <bool IMAGE>
__device__ __forceinline__ int pixel_of(const Scal& S, const Image& img, const float* p) {
  const float x_im = p[1] * S.trig[3] - p[0] * S.trig[2];
  const float y_im = p[2] * S.trig[0] - p[1] * S.trig[1] * S.trig[2] - p[0] * S.trig[1] * S.trig[3];
  if constexpr (IMAGE) {
    const float ix = floorf((float)img.nx * (x_im + S.x_max) / (2.0f * S.x_max));
    const float iy = floorf((float)img.ny * (y_im + S.y_max) / (2.0f * S.y_max));
    const bool in = ix >= 0.0f && ix < (float)img.nx && iy >= 0.0f && iy < (float)img.ny;
    return in ? (int)ix * img.ny + (int)iy : -1;
  } else {
    const float ix = floorf((x_im + S.x_max) / (2.0f * S.x_max));
    const float iy = floorf((y_im + S.y_max) / (2.0f * S.y_max));
    return (ix == 0.0f && iy == 0.0f) ? 0 : -1;
  }
}

// add an accepted peel into the tallies: NK = 4 Stokes components for a
// scatter peel, NK = 1 (Stokes I and the Stokes-I row's count) for a birth
// peel; per-thread sums for a spectrum, atomics into the pixel for an image
template <bool IMAGE, int NK>
__device__ __forceinline__ void book(const Image& img, int pix, const float* v, double* acc) {
  if constexpr (IMAGE) {
    double* row = img.sums + (size_t)N_IMG_D * pix;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      atomicAdd(row + k, (double)v[k]);
      atomicAdd(row + 4 + k, (double)(v[k] * v[k]));
    }
    unsigned long long* c = img.counts + (size_t)N_IMG_I * pix;
    atomicAdd(c, 1ull);
    if (NK == 4) atomicAdd(c + 1, 1ull);
  } else {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      acc[k] += (double)v[k];
      acc[4 + k] += (double)(v[k] * v[k]);
    }
  }
}

// ------------------------------------------------------------ errors ----

constexpr int REC_W = 16;

// the bounded buffer of error records (rows of REC_W floats) and its row count
struct Records {
  float* __restrict__ rows;
  unsigned int* __restrict__ count;
  unsigned int cap;
};

// append one record: code, photon id as its bit pattern, position,
// direction, cell, face, Stokes I, scatterings so far, site; a full buffer
// drops the row, never the count
__device__ void record_error(const Records& R, float code, uint32_t pid, const float* pos,
                             const float* dir, const int* cell, const int* face, float stokes_i,
                             int n_scat, float site) {
  const unsigned int slot = atomicAdd(R.count, 1u);
  if (slot >= R.cap) return;
  float* r = R.rows + (size_t)REC_W * slot;
  r[0] = code;
  r[1] = __uint_as_float(pid);
  for (int i = 0; i < 3; ++i) {
    r[2 + i] = pos[i];
    r[5 + i] = dir[i];
    r[8 + i] = (float)cell[i];
  }
  r[11] = (float)face[0];
  r[12] = (float)face[1];
  r[13] = stokes_i;
  r[14] = (float)n_scat;
  r[15] = site;
}

// error 050 of --debug-stokes (ARTES.f90:830-835): I^2 (1 + 1e-6) < Q^2 +
// U^2 + V^2 after the Mueller update, rounded as the plain version rounds it
// (no contracted multiply-adds)
__device__ __forceinline__ bool stokes_anomaly(const float* st) {
  const float lhs = __fmul_rn(__fmul_rn(st[0], st[0]), 1.000001f);
  const float rhs = __fadd_rn(__fadd_rn(__fmul_rn(st[1], st[1]), __fmul_rn(st[2], st[2])),
                              __fmul_rn(st[3], st[3]));
  return lhs < rhs;
}

// ---------------------------------------------------------- emission ----

// direction of a thermal birth at pos (kernel._emit_thermal): isotropic, or
// biased upward after Gordon 1987 (ARTES.f90:1229-1254); returns the bias
// weight
__device__ float thermal_direction(const Scal& S, const float* u, bool biased,
                                   const float* pos, float* dir) {
  const float beta = TWO_PI_F * u[5];
  float bias_w = 1.0f;
  if (!biased) {
    const float alpha = 2.0f * u[4] - 1.0f;
    const float s = sqrtf(fmaxf(1.0f - alpha * alpha, 0.0f));
    dir[0] = s * cosf(beta);
    dir[1] = s * sinf(beta);
    dir[2] = alpha;
  } else {
    const float root = sqrtf(1.0f - S.bias * S.bias);
    const float y = (1.0f + S.bias) * tanf(PI_F * u[4] / 2.0f) / root;
    const float theta_s = acosf(fminf(fmaxf((1.0f - y * y) / (1.0f + y * y), -1.0f), 1.0f));
    float rad[3];
    for (int k = 0; k < 3; ++k) rad[k] = pos[k] * (S.ob[k] * S.ob[k]);
    const float norm = sqrtf(rad[0] * rad[0] + rad[1] * rad[1] + rad[2] * rad[2]);
    for (int k = 0; k < 3; ++k) rad[k] /= norm;
    direction_cosine(cosf(PI_F - theta_s), beta, rad, dir);
    bias_w = (PI_F * sinf(theta_s) * (1.0f + S.bias * cosf(theta_s))) / (2.0f * root);
  }
  return bias_w;
}

// stellar birth: a uniform parallel beam over the ellipsoid silhouette
// (sites 0, 1), on the crescent ring r > 0.9 for phase angles >= 170 deg
__device__ __forceinline__ void emit_stellar(const Scal& S, const float* d, bool crescent,
                                             float* pos, float* dir) {
  const float u1 = crescent ? 0.81f + 0.19f * d[0] : d[0];
  const float r_disk = sqrtf(u1);
  const float phi = TWO_PI_F * d[1];
  const float disk1 = r_disk * sinf(phi), disk2 = r_disk * cosf(phi);
  const float depth = sqrtf(fmaxf(1.0f - disk1 * disk1 - disk2 * disk2, 0.0f));
  for (int k = 0; k < 3; ++k) {
    pos[k] = (disk1 * S.e1[k] + disk2 * S.e2[k] - depth * S.w_hat[k]) / S.ob[k];
    dir[k] = S.u_hat[k];
  }
}

// ------------------------------------------------------------ scalars ----

__device__ __forceinline__ Scal load_scal(const float* __restrict__ scal) {
  Scal S;
  S.fstop = __ldg(scal + S_FSTOP);
  S.pmin = __ldg(scal + S_PMIN);
  S.x_max = __ldg(scal + S_XMAX);
  S.y_max = __ldg(scal + S_YMAX);
  S.rfloor = __ldg(scal + S_RFLOOR);
  S.pos_eps = __ldg(scal + S_POS_EPS);
  S.sel1 = __ldg(scal + S_SEL1);
  S.bias = __ldg(scal + S_BIAS);
  for (int i = 0; i < 3; ++i) {
    S.det[i] = __ldg(scal + S_DET + i);
    S.ob[i] = __ldg(scal + S_OB + i);
    S.u_hat[i] = __ldg(scal + S_UHAT + i);
    S.e1[i] = __ldg(scal + S_E1 + i);
    S.e2[i] = __ldg(scal + S_E2 + i);
    S.w_hat[i] = __ldg(scal + S_WHAT + i);
  }
  for (int i = 0; i < 4; ++i) S.trig[i] = __ldg(scal + S_TRIG + i);
  for (int i = 0; i < 2; ++i) S.tcos[i] = __ldg(scal + S_TCOS + i);
  return S;
}

static_assert(N_SCAL == S_BIAS + 1, "scalar layout");

// ---------------------------------------------------------------- flow ----

// the flow diagnostics (ARTES.f90:4992-5047): g is (ncell, 3), energy x
// distance projected on the local (r, theta, phi) unit vectors; t is (ncell,
// 4), the energy of full crossings up / down / south / north. Both double,
// in global memory, added into with red.global.add.f64, a reduction that
// returns nothing: the thread goes on at once. (An atomicAdd through a
// pointer that may be shared or global compiles to a generic atomic whose
// result the thread waits for, a round trip to the L2 on every booking.)
// Where the caller gives `buf`, a zeroed buffer of gridDim.x x 7 ncell
// doubles, a block adds into its own copy of both, which flow_end adds into
// the result once; else every add goes straight into the result, where the
// blocks meet on the same addresses
struct Flow {
  double* g;
  double* t;
};

__device__ __forceinline__ void red_add(double* p, double v) {
  asm volatile("red.global.add.f64 [%0], %1;" ::"l"(p), "d"(v) : "memory");
}

__device__ __forceinline__ Flow flow_begin(double* flow_g, double* flow_t, double* buf,
                                           int ncell) {
  if (buf == nullptr) return Flow{flow_g, flow_t};
  double* own = buf + (size_t)blockIdx.x * 7 * ncell;
  return Flow{own, own + 3 * ncell};
}

__device__ __forceinline__ void flow_end(double* flow_g, double* flow_t, const Flow& fl,
                                         int ncell) {
  if (fl.g == flow_g) return;
  __syncthreads();
  for (int i = threadIdx.x; i < 7 * ncell; i += blockDim.x) {
    const double v = __ldcg(fl.g + i);
    if (v != 0.0) red_add(i < 3 * ncell ? flow_g + i : flow_t + (i - 3 * ncell), v);
  }
}

// book one step of a photon into cell `cell`: the three projections and, for
// a full crossing (column 0-3, else -1), its energy in that column
__device__ __forceinline__ void flow_add(const Flow& fl, int cell, float wr, float wt, float wp,
                                         int column, float energy) {
  red_add(fl.g + 3 * cell, (double)wr);
  red_add(fl.g + 3 * cell + 1, (double)wt);
  red_add(fl.g + 3 * cell + 2, (double)wp);
  if (column >= 0) red_add(fl.t + 4 * cell + column, (double)energy);
}

// --------------------------------------------------------- persistence ----

// the next photon of the launch for each active lane: one atomicAdd on the
// launch's counter for the lanes that ask together, each lane its own slot
__device__ __forceinline__ unsigned long long next_photon(unsigned long long* next_id) {
  const unsigned int mask = __activemask();
  const int leader = __ffs(mask) - 1;
  const int lane = threadIdx.x & 31;
  unsigned long long base = 0ull;
  if (lane == leader) base = atomicAdd(next_id, (unsigned long long)__popc(mask));
  base = __shfl_sync(mask, base, leader);
  return base + (unsigned long long)__popc(mask & ((1u << lane) - 1u));
}

// ------------------------------------------------------------- lanes ----

// A launch's lane counters (pool_cuda.LANE_KEYS), counted where the launch
// is given a buffer for them: a warp's passes through the persistent loop's
// refill branch and the lanes active at each, then the same for its
// scattering rounds. A block counts in shared memory and adds its counts
// into the buffer at its end.
enum { L_REFILL = 0, L_ROUND = 2, N_LANE = 4 };

// one pass of a warp's active lanes `mask`: its leader adds 1 to slot[0] and
// the lanes to slot[1] (shared memory); the phase clocks of
// ARTES_POOL_CLOCKS count their entries and lanes with it too
__device__ __forceinline__ void count_pass(unsigned long long* slot, unsigned int mask) {
  if ((int)(threadIdx.x & 31) == __ffs(mask) - 1) {
    atomicAdd(slot, 1ull);
    atomicAdd(slot + 1, (unsigned long long)__popc(mask));
  }
}

__device__ __forceinline__ void lanes_begin(unsigned long long* sh,
                                            const unsigned long long* out) {
  if (out == nullptr) return;
  if (threadIdx.x < N_LANE) sh[threadIdx.x] = 0ull;
  __syncthreads();
}

// a pass through branch `at` (L_REFILL, L_ROUND)
__device__ __forceinline__ void lane_pass(unsigned long long* sh, int at,
                                          const unsigned long long* out) {
  if (out != nullptr) count_pass(sh + at, __activemask());
}

__device__ __forceinline__ void lanes_end(const unsigned long long* sh,
                                          unsigned long long* out) {
  if (out == nullptr) return;
  __syncthreads();
  if (threadIdx.x < N_LANE) atomicAdd(out + threadIdx.x, sh[threadIdx.x]);
}

// the blocks of `threads` the card holds at once for kernel `fn`
// (instantiation `variant` of at most 8) with `smem` bytes of dynamic shared
// memory a block: queried once for each (the first launch's device) and
// again when threads or smem change, 0 when the query fails
template <typename Fn>
int resident_blocks(int variant, Fn fn, int threads, size_t smem = 0) {
  static int cached_threads[8] = {0}, cached_blocks[8] = {0};
  static size_t cached_smem[8] = {0};
  if (cached_blocks[variant] > 0 && cached_threads[variant] == threads &&
      cached_smem[variant] == smem)
    return cached_blocks[variant];
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem) != cudaSuccess)
    return 0;
  cached_threads[variant] = threads;
  cached_smem[variant] = smem;
  cached_blocks[variant] = per_sm * sms;
  return cached_blocks[variant];
}

// the persistent grid of a launch of n photons: the resident blocks, fewer
// for a small launch
inline int persistent_blocks(int resident, unsigned int n, int threads) {
  const unsigned long long wanted = ((unsigned long long)n + threads - 1) / threads;
  return (int)(wanted < (unsigned long long)resident ? (wanted > 0 ? wanted : 1) : resident);
}

// ---------------------------------------------------------- reduction ----

// block reduction of the per-thread tallies: warp shuffles, then one row
// per warp in shared memory, then one atomicAdd per tally (blocks of at
// most 256 threads)
template <int ND, int NI>
__device__ __forceinline__ void reduce_block(double* acc, unsigned long long* cnt,
                                             double* __restrict__ out_d,
                                             unsigned long long* __restrict__ out_i) {
  __shared__ double sh_d[8][ND];
  __shared__ unsigned long long sh_i[8][NI];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    for (int k = 0; k < ND; ++k) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    for (int k = 0; k < NI; ++k) cnt[k] += __shfl_down_sync(0xffffffffu, cnt[k], off);
  }
  if (lane == 0) {
    for (int k = 0; k < ND; ++k) sh_d[warp][k] = acc[k];
    for (int k = 0; k < NI; ++k) sh_i[warp][k] = cnt[k];
  }
  __syncthreads();
  if (threadIdx.x < ND) {
    double s = 0.0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += sh_d[w][threadIdx.x];
    atomicAdd(out_d + threadIdx.x, s);
  } else if (threadIdx.x < ND + NI) {
    const int k = threadIdx.x - ND;
    unsigned long long s = 0ull;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += sh_i[w][k];
    atomicAdd(out_i + k, s);
  }
}

// ------------------------------------------------------------- launch ----

// a launch's kernel arguments from its PoolLaunch (host code)
inline Tables tables_of(const PoolLaunch& a) {
  return Tables{a.rfront, a.opacity, a.albedo, a.scatter, a.prefix, a.p_int, a.consts,
                a.emis_cum, a.cell_weight, a.nr};
}

inline Image image_of(const PoolLaunch& a) {
  return Image{a.img_sums, a.img_counts, a.nx, a.ny};
}

inline Records records_of(const PoolLaunch& a) {
  return Records{a.rec, a.rec_count, (unsigned int)a.rec_cap};
}

// a block size every kernel takes: whole warps, at most 256 threads
inline bool threads_ok(int threads) {
  return threads >= 32 && threads <= 256 && threads % 32 == 0;
}

// the layout slots every kernel reports to the wrapper: {N_SCAL, N_OUT_D,
// n_out_i, N_IMG_D, N_IMG_I, REC_W, n_counters, sizeof(PoolLaunch)}; returns
// the slots written
inline int common_layout(int* sizes, int n_out_i, int n_counters) {
  sizes[0] = N_SCAL;
  sizes[1] = N_OUT_D;
  sizes[2] = n_out_i;
  sizes[3] = N_IMG_D;
  sizes[4] = N_IMG_I;
  sizes[5] = REC_W;
  sizes[6] = n_counters;
  sizes[7] = (int)sizeof(PoolLaunch);
  return 8;
}

}  // namespace
