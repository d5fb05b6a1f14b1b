// Device code shared by the kernels that step through (r, theta, phi) cells,
// pool_grid3d.cu (3-D grids, jump walks) and pool_march.cu (Lambert surfaces
// and flow diagnostics, marching walks on any grid): the grid tables, one
// traversal step (geometry.cell_face), the cell lookups, the error codes and
// the thermal birth over all cells. A radial grid is the case nt = np = 1.
// Every function lives in an anonymous namespace, as in pool_common.cuh.

#pragma once
#include "pool_common.cuh"

namespace {

// N_OUT_I + photons abandoned, codes 031, 032, 034, Stokes anomalies (050)
constexpr int N_OUT_I3 = 9;
enum { M_ERROR = 3 };
enum { C_ERR = 4, C_E031 = 5, C_E032 = 6, C_E034 = 7, C_ANOM = 8 };

struct Grid3 {
  const float* __restrict__ theta_tan;    // (nt+1,)
  const float* __restrict__ theta_cos;    // (nt+1,)
  const int* __restrict__ theta_flags;    // (nt+1,) bit 0 cone, bit 1 theta < pi/2
  const float* __restrict__ phi_sin;      // (np,)
  const float* __restrict__ phi_cos;      // (np,)
  const float* __restrict__ phifront;     // (np,) face azimuths in [0, 2 pi)
  const float* __restrict__ kbar;         // (nr,) baseline opacity
  const float* __restrict__ dk;           // (ncell,) opacity - kbar
  const float* __restrict__ dr;           // (nr-1, nt*np)
  const float* __restrict__ dtt;          // (nt-1, nr*np)
  const float* __restrict__ dpp;          // (np, nr*nt)
  const float* __restrict__ rf2;          // (nr-1,) squared interior face radii
  Records rec;                            // (rec_cap, 16) error records
  int nt, np, cell_depth, max_crossings;
  float same_eps, sel2, boundary_tol;
};

// a^2 u_x v_x + b^2 u_y v_y + c^2 u_z v_z as fma(c^2 u_z, v_z, fma(a^2 u_x,
// v_x, b^2 u_y v_y)), the chain XLA compiles of the reference's float32
// expression (the plain version's geometry._form and jumps.quad_terms).
// These kernels' walks round their float32 geometry in such explicit
// chains, as the plain version does (geometry.fmadd): how nvcc would
// contract the same expressions depends on the code around them, and the
// chains decide which walks graze a face. The closed-form radial kernel
// rounds its geometry op by op (pool_common.cuh::make_ray, emit_stellar), as
// the plain version's radial.ray_chords does.
__device__ __forceinline__ float form(const Scal& S, const float* u, const float* v) {
  const float a2 = S.ob[0] * S.ob[0], b2 = S.ob[1] * S.ob[1], c2 = S.ob[2] * S.ob[2];
  return __fmaf_rn(__fmul_rn(c2, u[2]), v[2],
                   __fmaf_rn(__fmul_rn(a2, u[0]), v[0], __fmul_rn(__fmul_rn(b2, u[1]), v[1])));
}

// ----------------------------------------------------------- cell_face ----

// stable quadratic roots, q-form (geometry._quadratic); absent roots are 0
__device__ __forceinline__ void quadratic(float qa, float qb, float qc, float& s1, float& s2) {
  const float disc = __fmaf_rn(qb, qb, -__fmul_rn(__fmul_rn(4.0f, qa), qc));
  const bool ok = disc >= 0.0f;
  const float sd = sqrtf(ok ? disc : 0.0f);
  const float q = qb == 0.0f ? -0.5f * sd : -0.5f * (qb + copysignf(sd, qb));
  // the reference's 1e-100 floors are 0 in float32
  s1 = (ok && fabsf(qa) > 0.0f) ? q / qa : 0.0f;
  s2 = (ok && fabsf(q) > 0.0f) ? qc / q : 0.0f;
}

// the smallest root above eps, else 0 (geometry._pick_root)
__device__ __forceinline__ float pick_root(float s1, float s2, float eps) {
  const bool v1 = s1 > eps && s1 < BIG, v2 = s2 > eps && s2 < BIG;
  return (v1 && v2) ? fminf(s1, s2) : (v1 ? s1 : (v2 ? s2 : 0.0f));
}

// the sphere quadratic's A, B/2 and C + r^2 along a ray (geometry.sphere_quadratic)
struct Quad {
  float A, Bq, Cq;
};

__device__ __forceinline__ float sphere_distance(const Quad& r, float r_face, float eps) {
  float s1, s2;
  quadratic(r.A, 2.0f * r.Bq, __fmaf_rn(-r_face, r_face, r.Cq), s1, s2);
  return pick_root(s1, s2, eps);
}

// distance to a theta face: a cone with wrong-nappe rejection, or the z = 0
// plane crossed in the direction `up` (geometry._cone_distance and its use)
__device__ float theta_distance(const Scal& S, const float* p, const float* d, float tan_t,
                                int flags, float eps, bool up) {
  const float nz = d[2], z = p[2];
  if (!(flags & 1)) {
    const float s_plane = -z / (nz == 0.0f ? 1.0f : nz);
    const bool moving = up ? nz > S.pos_eps : nz < -S.pos_eps;
    return (s_plane > 0.0f && moving) ? s_plane : 0.0f;
  }
  const bool above = (flags & 2) != 0;
  const float a2 = S.ob[0] * S.ob[0], b2 = S.ob[1] * S.ob[1], c2 = S.ob[2] * S.ob[2];
  const float t2 = __fmul_rn(tan_t, tan_t);
  // geometry.cone_quadratic
  const float qa = __fmaf_rn(-__fmul_rn(__fmul_rn(c2, nz), nz), t2,
                             __fmaf_rn(__fmul_rn(a2, d[0]), d[0],
                                       __fmul_rn(__fmul_rn(b2, d[1]), d[1])));
  const float qb = 2.0f * __fmaf_rn(-__fmul_rn(__fmul_rn(c2, z), nz), t2,
                                    __fmaf_rn(__fmul_rn(a2, p[0]), d[0],
                                              __fmul_rn(__fmul_rn(b2, p[1]), d[1])));
  const float qc = __fmaf_rn(-__fmul_rn(__fmul_rn(c2, z), z), t2,
                             __fmaf_rn(__fmul_rn(a2, p[0]), p[0],
                                       __fmul_rn(__fmul_rn(b2, p[1]), p[1])));
  float s[2];
  quadratic(qa, qb, qc, s[0], s[1]);
  for (int i = 0; i < 2; ++i) {
    const float z_test = __fmaf_rn(s[i], nz, z);
    const bool wrong = (z_test > 0.0f && !above) || (z_test < 0.0f && above);
    if (s[i] > S.pos_eps && wrong) s[i] = 0.0f;
  }
  return pick_root(s[0], s[1], eps);
}

// distance to a phi half-plane (geometry._phi_plane_distance)
__device__ __forceinline__ float phi_distance(const Scal& S, const float* p, const float* d,
                                              float sin_p, float cos_p, float eps) {
  const float denom = __fmaf_rn(__fmul_rn(S.ob[1], d[1]), cos_p,
                                -__fmul_rn(__fmul_rn(S.ob[0], d[0]), sin_p));
  const float s = __fmaf_rn(__fmul_rn(S.ob[0], p[0]), sin_p,
                            -__fmul_rn(__fmul_rn(S.ob[1], p[1]), cos_p))
      / (denom == 0.0f ? 1.0f : denom);
  return (fabsf(denom) > 0.0f && s > eps && s < BIG) ? s : 0.0f;
}

struct Step {
  float dist;
  int axis, idx;          // next face
  int cell[3];            // next cell
  bool grid_exit, nocand, degen;
};

// one traversal step (geometry.cell_face): faces are (axis, index) with axis
// 0 none, 1 radial, 2 theta, 3 phi
__device__ void cell_face(const Tables& T, const Grid3& G, const Scal& S, const float* p,
                          const float* d, const int* cell, const int* face, Step& out) {
  const int cr = cell[0], ct = cell[1], cp = cell[2];
  const int axis = face[0], fidx = face[1];
  const bool cur_r = axis == 1, cur_t = axis == 2, cur_p = axis == 3;
  const Quad ray{form(S, d, d), form(S, p, d), form(S, p, p)};
  float dist[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // r, theta, phi in; then out

  // radial: the inner sphere is skipped right after an outward crossing of
  // it; the outer one takes the looser threshold after an inward crossing
  if (!(cur_r && cr == fidx)) dist[0] = sphere_distance(ray, __ldg(T.rfront + cr), S.pos_eps);
  dist[3] = sphere_distance(ray, __ldg(T.rfront + cr + 1),
                            (cur_r && cr == fidx - 1) ? G.same_eps : S.pos_eps);

  if (G.nt > 1) {
    const int fl_in = __ldg(G.theta_flags + ct), fl_out = __ldg(G.theta_flags + ct + 1);
    const bool t_in_same = cur_t && ct == fidx && !(fl_in & 2);
    if (ct > 0 && (!cur_t || ct == fidx - 1 || t_in_same))
      dist[1] = theta_distance(S, p, d, __ldg(G.theta_tan + ct), fl_in,
                               t_in_same ? G.same_eps : S.pos_eps, true);
    const bool t_out_same = cur_t && ct == fidx - 1 && (fl_out & 2);
    if (ct + 1 < G.nt && (!cur_t || ct == fidx || t_out_same))
      dist[4] = theta_distance(S, p, d, __ldg(G.theta_tan + ct + 1), fl_out,
                               t_out_same ? G.same_eps : S.pos_eps, false);
  }

  int p_outer = 0;
  if (G.np > 1) {
    p_outer = cp + 1 == G.np ? 0 : cp + 1;
    const bool p_inward = cur_p && (cp == fidx - 1 || (cp == G.np - 1 && fidx == 0));
    const bool p_outward = cur_p && cp == fidx && !p_inward;
    if (!cur_p || p_inward)
      dist[2] = phi_distance(S, p, d, __ldg(G.phi_sin + cp), __ldg(G.phi_cos + cp), S.pos_eps);
    if (!cur_p || p_outward)
      dist[5] = phi_distance(S, p, d, __ldg(G.phi_sin + p_outer), __ldg(G.phi_cos + p_outer),
                             S.pos_eps);
  }

  // two-tier selection, candidates in the reference's scan order
  int best = 0;
  float dmin = BIG;
  for (int tier = 0; tier < 2 && dmin >= BIG; ++tier) {
    const float tier_eps = tier == 0 ? S.sel1 : G.sel2;
    best = 0;
    for (int i = 0; i < 6; ++i) {
      const float v = dist[i] > tier_eps ? dist[i] : BIG;
      if (v < dmin) { dmin = v; best = i; }
    }
  }
  const bool no_candidate = dmin >= BIG;
  out.dist = no_candidate ? 0.0f : dmin;

  // no-candidate rescue by position: on or over the outer face moving
  // outward is a grid exit, on or under the floor moving inward a floor hit
  bool on_outer = false, on_floor = false;
  if (no_candidate) {
    const float r_outer = __ldg(T.rfront + T.nr) * (1.0f - G.boundary_tol);
    const float r_floor = __ldg(T.rfront + G.cell_depth) * (1.0f + G.boundary_tol);
    on_outer = ray.Cq >= r_outer * r_outer && ray.Bq > 0.0f;
    on_floor = !on_outer && ray.Cq <= r_floor * r_floor && ray.Bq < 0.0f && cr == G.cell_depth;
  }
  const bool rescued = on_outer || on_floor;
  out.nocand = no_candidate && !rescued;

  const int faces[6] = {cr, ct, cp, cr + 1, ct + 1, p_outer};
  out.axis = rescued ? 1 : best % 3 + 1;
  out.idx = on_outer ? T.nr : (on_floor ? G.cell_depth : faces[best]);
  const bool outward = rescued ? on_outer : best >= 3;
  out.cell[0] = out.axis == 1 ? (outward ? cr + 1 : cr - 1) : cr;
  out.cell[1] = out.axis == 2 ? (outward ? ct + 1 : ct - 1) : ct;
  int cp_next = outward ? cp + 1 : cp - 1;
  cp_next = cp_next < 0 ? G.np - 1 : (cp_next >= G.np ? 0 : cp_next);
  out.cell[2] = out.axis == 3 ? cp_next : cp;
  out.grid_exit = out.axis == 1 && out.idx == T.nr;
  out.degen = cur_r && fidx == G.cell_depth && out.axis == 1 && out.idx == G.cell_depth;
}

// theta band of cos(theta): interior faces whose cosine lies above it
__device__ __forceinline__ int ct_at(const Grid3& G, float cos_t) {
  int c = 0;
  for (int j = 1; j < G.nt; ++j) c += cos_t < __ldg(G.theta_cos + j);
  return c;
}

// (theta, phi) cell of a point (geometry.locate_cell; arctan2 phi binning)
__device__ void locate_tp(const Grid3& G, float x, float y, float z, float r, int& ct, int& cp) {
  ct = 0;
  cp = 0;
  if (G.nt > 1) {
    // the reference's 1e-300 floor on r is 0 in float32
    const float theta = acosf(fminf(fmaxf(z / fmaxf(r, 0.0f), -1.0f), 1.0f));
    ct = ct_at(G, cosf(theta));
  }
  if (G.np > 1) {
    float phi = atan2f(y, x);
    if (phi < 0.0f) phi += TWO_PI_F;
    for (int j = 1; j < G.np; ++j) cp += phi >= __ldg(G.phifront + j);
    cp = min(cp, G.np - 1);
  }
}

// re-locate a photon whose radius left its tracked shell by more than sel1:
// all three indices from the position (geometry.heal_cell)
__device__ void heal_cell(const Tables& T, const Grid3& G, const Scal& S, const float* p,
                          int* cell) {
  const float x = p[0] * S.ob[0], y = p[1] * S.ob[1], z = p[2] * S.ob[2];
  const float rho = sqrtf(norm2(x, y, z));
  const float r_lo = __ldg(T.rfront + min(max(cell[0], 0), T.nr - 1));
  const float r_hi = __ldg(T.rfront + min(max(cell[0] + 1, 0), T.nr));
  if (!(rho < r_lo - S.sel1 || rho > r_hi + S.sel1)) return;
  int lo = 0, hi = T.nr + 1;            // count of faces with rfront <= rho
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(T.rfront + mid) <= rho) lo = mid + 1; else hi = mid;
  }
  cell[0] = min(max(lo - 1, 0), T.nr - 1);
  locate_tp(G, x, y, z, rho, cell[1], cell[2]);
}

// error code of a failed march, as the forensics record names it
__device__ __forceinline__ float error_code(bool e031, bool e034) {
  return e031 ? 31.0f : (e034 ? 34.0f : 32.0f);
}

// ------------------------------------------------------------ emission ----

// stellar birth as pool_common.cuh::emit_stellar, the entry point in the
// chains XLA compiles (kernel.disk_depth2, kernel.disk_position)
__device__ __forceinline__ void emit_stellar_fma(const Scal& S, const float* d, bool crescent,
                                                 float* pos, float* dir) {
  const float u1 = crescent ? 0.81f + 0.19f * d[0] : d[0];
  const float r_disk = sqrtf(u1);
  const float phi = TWO_PI_F * d[1];
  const float disk1 = r_disk * sinf(phi), disk2 = r_disk * cosf(phi);
  const float depth = sqrtf(fmaxf(__fmaf_rn(-disk2, disk2, __fmaf_rn(-disk1, disk1, 1.0f)), 0.0f));
  for (int k = 0; k < 3; ++k) {
    pos[k] = __fmaf_rn(-depth, S.w_hat[k],
                       __fmaf_rn(disk1, S.e1[k], __fmul_rn(disk2, S.e2[k]))) / S.ob[k];
    dir[k] = S.u_hat[k];
  }
}

// thermal birth (kernel._emit_thermal): the cell from the emissivity CDF
// over all cells, a point inside it, an isotropic or Gordon-biased
// direction; returns the initial Stokes I
__device__ float emit_thermal(const Tables& T, const Grid3& G, const Scal& S, const float* u,
                              bool biased, float* pos, float* dir, int* cell) {
  const float u_r = fminf(fmaxf(u[1], U_CLIP_LO), U_CLIP_HI);
  const float u_t = fminf(fmaxf(u[2], U_CLIP_LO), U_CLIP_HI);
  const int ncell = T.nr * G.nt * G.np;
  const float target = u[0] * __ldg(T.emis_cum + ncell - 1);
  int lo = 0, hi = ncell;                // lower bound: first emis_cum >= target
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(T.emis_cum + mid) < target) lo = mid + 1; else hi = mid;
  }
  const int idx = min(lo, ncell - 1);
  const int cr = idx / (G.nt * G.np), ct = (idx / G.np) % G.nt, cp = idx % G.np;
  cell[0] = cr;
  cell[1] = ct;
  cell[2] = cp;
  const float r0 = __ldg(T.rfront + cr), r1 = __ldg(T.rfront + cr + 1);
  const float r = r0 + u_r * (r1 - r0);
  const float c0 = __ldg(G.theta_cos + ct), c1 = __ldg(G.theta_cos + ct + 1);
  const float cos_t = c0 + u_t * (c1 - c0);
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float phi = TWO_PI_F * u[3];
  if (G.np > 1) {
    const float phi_lo = __ldg(G.phifront + cp);
    const float phi_hi = cp == G.np - 1 ? TWO_PI_F : __ldg(G.phifront + cp + 1);
    phi = phi_lo + u[3] * (phi_hi - phi_lo);
  }
  pos[0] = r * sin_t * cosf(phi) / S.ob[0];
  pos[1] = r * sin_t * sinf(phi) / S.ob[1];
  pos[2] = r * cos_t / S.ob[2];
  return thermal_direction(S, u, biased, pos, dir) / __ldg(T.cell_weight + idx);
}

// the grid argument of a launch from its PoolLaunch (host code)
inline Grid3 grid_of(const PoolLaunch& a) {
  return Grid3{a.theta_tan, a.theta_cos, a.theta_flags, a.phi_sin, a.phi_cos, a.phifront,
               a.kbar, a.dk, a.dr, a.dtt, a.dpp, a.rf2, records_of(a),
               a.ntheta, a.nphi, a.cell_depth, a.max_crossings,
               a.same_eps, a.sel2, a.boundary_tol};
}

}  // namespace
