// Photon transport through Lambert surfaces and with flow diagnostics: one
// hand-written CUDA kernel for Hopper, marching cell by cell on any grid.
//
// Replaces the TPU kernel artes_tpu/transport/pallas_stream.py::_build_kernel
// (the fused regeneration-pool Pallas kernel) in its Lambert-surface
// specialisation: the marching `march` with the in-loop Lambert draws
// (:970-1067), the marching `tau_walk` of peels and prewalk (:1082-1117), the
// surface peel (:1699-1710) and the peel and prewalk error tallies
// (:1819-1828); and the flow booking (:1626-1665) on the grids that the TPU
// kernel left to the XLA pool (3-D grids, and any grid with a surface). Its
// plain PyTorch version is artes_tpu_torch/transport/kernel.py::run_stream in
// walk mode "march" (_tau_walk_march, _march_cells).
//
// Eight compile-time instantiations, pool_march_kernel<THERMAL, IMAGE, FLOW>,
// each with a counting twin (COUNTS, below).
// The surface albedo is a run-time scalar: at albedo 0 (3-D flow without a
// surface) the floor absorbs through the same `u > albedo` test. A radial
// grid runs with nt = np = 1.
//
// Design. A persistent grid, as pool_grid3d.cu's: the blocks the card holds
// at once (four of 256 an SM for the surface instantiations, two with flow),
// each lane taking photon ids from the launch's counter
// (pool_common.cuh::next_photon) and running one step of its photon a loop
// iteration: a new photon's emission, birth peel (thermal), prewalk and
// first march, or one scattering round with its peel and its march. A lane
// whose photon dies takes the next id in the next iteration, so no lane
// waits for the longest photon of a static share. Photon streams are keyed
// by (seed, photon id, draw site), on the per-photon draw-site schedule of
// the JAX pool:
//   emission: sites 0, 1 (stellar) or 0-5 (thermal);
//   the forced first interaction: one site (the prewalk before it draws none);
//   every scattering round: 5 sites (roulette, azimuth x2, zenith, tau);
//   every pass of a transport march: 3 sites, the Lambert draws of a crossing
//     onto the floor face, reserved on every pass.
// Each photon's arithmetic is the same whichever lane runs it, so counts do
// not depend on the launch; only the order of the per-thread double sums
// moves. There is no exit precheck: every photon marches to its end, so its
// site counter advances as the JAX pool's does. A lane that reflects draws
// its Lambertian direction about the ellipsoid normal, books the surface peel
// (a marching walk from the cell above, e^-tau cos / pi on Stokes I alone,
// counted in the Stokes-I row only) and goes on marching in the same march
// with the optical depth it has left: the TPU kernel's SURF_PEEL stage and
// banked budget have no counterpart. Peels and the prewalk march cell_face
// too, stop at the grid's edge, the floor face or an error, and fail when
// still marching after max_crossings passes.
//
// Counts. out_i counts the passes of cell_face every walk made (C_PASSES)
// and, with FLOW, the passes that booked flow. Given a buffer for them
// (pool_cuda passes one while artes_tpu_torch.spans records), a launch also
// counts its warps' passes through the persistent loop's refill and round
// branches and their active lanes (pool_common.cuh::lane_pass), in every
// instantiation: it launches the instantiation's twin with COUNTS set, on the
// same grid. Without a buffer it launches the one without: the counting code
// in the loop, skipped at a null buffer, cost 0.8-2.5% of the kernel's time on
// the surface cells (H100, PERF.md), so that the loop a launch runs unrecorded
// holds none of it.
//
// Flow. Every pass of a transport march adds energy x step projected on the
// local (r, theta, phi) unit vectors at the advanced position into the cell
// the step was made in, and every full crossing of a radial or theta face
// its energy (up / down / south / north): double reductions
// (red.global.add.f64, which the thread does not wait for) into the block's
// copy in a global buffer, added into the result once a block, or straight
// into the result where the copies would not fit (pool_common.cuh).
//
// Errors. A failed transport march (031, 032, 034) or prewalk (tallied under
// 031) or thermal birth peel (tallied under "peel") abandons the photon; a
// failed scatter peel loses its flux only. Records as pool_grid3d.cu's, with
// the site: 0 a scatter march, 1 the first march, 2 the prewalk, 3 a scatter
// peel (code 50; the walk's input position, cell and face), 4 a Stokes
// anomaly (code 50, --debug-stokes; the photon is abandoned before its peel
// and march). Birth peels leave no record, as in the JAX pool. With
// scattering off a photon ends after its first march.
//
// What bounds it on an H100: arithmetic, divergence and table latency, as
// pool_grid3d.cu, with longer marches (escaping photons cross the whole grid)
// and, with FLOW, four to five double reductions a pass. A lane still waits
// for the longest march of its warp within one loop iteration (a march made
// resumable, one pass an iteration, lost on the surface cells: PERF.md).
//
// Rounding. The file builds with -fmad=false (_build.SOURCE_FLAGS), as
// pool_grid3d.cu does: every float32 expression rounds op by op, as the
// plain version's do, but the chains written with __fmaf_rn (the walks'
// geometry in the chains XLA compiles, geometry.fmadd on the plain side).

#include "pool_geom3d.cuh"

namespace {

// N_OUT_I3 + scatter and birth peel walks failed, passes of cell_face made,
// passes that booked flow
constexpr int N_OUT_IM = 12;
enum { C_EPEEL = 9, C_PASSES = 10, C_BOOKED = 11 };

// outcome of a marching tau walk
struct Walk {
  float tau;
  bool exited, surface, error;
};

// optical depth from (p, d), marched from `cell` with `face` as the current
// face, to the grid's outer face (exited), the photon floor (surface) or a
// cell_face error; still marching after max_crossings passes is an error
// (kernel._tau_walk_march)
__device__ Walk tau_walk_march(const Tables& T, const Grid3& G, const Scal& S, const float* p,
                               const float* d, const int* cell0, const int* face0,
                               unsigned long long& passes) {
  float pos[3] = {p[0], p[1], p[2]};
  int cell[3] = {cell0[0], cell0[1], cell0[2]};
  int face[2] = {face0[0], face0[1]};
  Walk w{0.0f, false, false, false};
  for (int it = 0; it < G.max_crossings; ++it) {
    Step st;
    cell_face(T, G, S, pos, d, cell, face, st);
    passes += 1;
    w.tau = __fadd_rn(w.tau, __fmul_rn(st.dist, __ldg(T.opacity + (cell[0] * G.nt + cell[1])
                                                      * G.np + cell[2])));
    w.exited = st.grid_exit;
    w.surface = st.axis == 1 && st.idx == G.cell_depth;
    w.error = st.nocand || st.degen;
    if (w.exited || w.surface || w.error) return w;
    for (int i = 0; i < 3; ++i) {
      pos[i] = __fmaf_rn(st.dist, d[i], pos[i]);
      cell[i] = st.cell[i];
    }
    face[0] = st.axis;
    face[1] = st.idx;
  }
  w.error = true;
  return w;
}

// unit normal of the ellipsoid through p: (x a^2, y b^2, z c^2) normalised
__device__ __forceinline__ void surface_normal(const Scal& S, const float* p, float* n) {
  for (int k = 0; k < 3; ++k) n[k] = p[k] * (S.ob[k] * S.ob[k]);
  const float inv = 1.0f / fmaxf(sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]), 1.0e-30f);
  for (int k = 0; k < 3; ++k) n[k] *= inv;
}

// flow diagnostics of one pass (kernel._flow_book): the step's projections
// at the advanced position p into cell cf, and a full crossing's energy
__device__ void flow_book(const Flow& fl, const Grid3& G, const float* p, const float* d,
                          float energy, float step, int cf, const Step& st, const int* cell,
                          bool crossing) {
  const float r = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
  const float theta = acosf(fminf(fmaxf(p[2] / fmaxf(r, 1.0e-30f), -1.0f), 1.0f));
  const float phi = atan2f(p[1], p[0]);
  const float s_t = sinf(theta), c_t = cosf(theta), s_p = sinf(phi), c_p = cosf(phi);
  const float w = energy * step;
  const bool outward = st.axis == 2 ? st.cell[1] > cell[1] : st.cell[0] > cell[0];
  const int column = !(crossing && (st.axis == 1 || st.axis == 2))
      ? -1 : (st.axis == 1 ? (outward ? 0 : 1) : (outward ? 2 : 3));
  flow_add(fl, cf, (s_t * c_p * d[0] + s_t * s_p * d[1] + c_t * d[2]) * w,
           (c_t * c_p * d[0] + c_t * s_p * d[1] - s_t * d[2]) * w,
           (-s_p * d[0] + c_p * d[1]) * w, column, energy);
}

// march cell by cell until the running optical depth passes tau
// (kernel._march_cells): the surface event at a crossing onto the floor face,
// its peel, and the flow booking; updates pos, dir, cell, face, the Stokes
// vector and the draw-site counter; returns M_INTER, M_EXIT, M_FLOOR
// (absorbed at the floor) or M_ERROR with the per-code flags set
template <bool IMAGE, bool FLOW>
__device__ int march_cells(const Tables& T, const Grid3& G, const Scal& S, float surface_albedo,
                           const Image& img, const Flow& fl, uint32_t key_hi, uint32_t pid,
                           float* pos, float* dir, int* cell, int* face, float* stokes,
                           float tau, uint32_t& ctr, double* acc, unsigned long long* cnt,
                           bool& e031, bool& e032, bool& e034) {
  e031 = e032 = e034 = false;
  float tau_run = 0.0f;
  for (int it = 0; it < G.max_crossings; ++it) {
    Step st;
    cell_face(T, G, S, pos, dir, cell, face, st);
    cnt[C_PASSES] += 1;
    const int cf = (cell[0] * G.nt + cell[1]) * G.np + cell[2];
    const float k = __ldg(T.opacity + cf);
    // the running optical depth as XLA compiles it (kernel._march_cells)
    const float tau_cell = __fmul_rn(st.dist, k);
    const bool interact = __fmaf_rn(st.dist, k, tau_run) > tau;
    const float step = interact ? (tau - tau_run) / (k == 0.0f ? 1.0f : k) : st.dist;
    for (int i = 0; i < 3; ++i) pos[i] = __fmaf_rn(step, dir[i], pos[i]);
    if constexpr (FLOW) {
      flow_book(fl, G, pos, dir, stokes[0], step, cf, st, cell, !interact);
      cnt[C_BOOKED] += 1;
    }
    const uint32_t site = ctr;
    ctr += 3;
    e031 = st.nocand;
    e034 = st.degen;
    const bool err = st.nocand || st.degen;
    if (interact) {
      face[0] = face[1] = 0;
      return err ? M_ERROR : M_INTER;
    }
    for (int i = 0; i < 3; ++i) cell[i] = st.cell[i];
    face[0] = st.axis;
    face[1] = st.idx;
    const bool floor_face = st.axis == 1 && st.idx == G.cell_depth;
    bool absorbed = false;
    if (floor_face) {
      // the surface event (ARTES.f90:755-774) on this pass's own three draws
      float u[3];
      draws(key_hi, pid, site, 3, u);
      absorbed = u[0] > surface_albedo;
      if (!absorbed && !err) {
        float normal[3];
        surface_normal(S, pos, normal);
        cell[0] += 1;                 // back into the cell above the surface
        const float cos_det = normal[0] * S.det[0] + normal[1] * S.det[1] + normal[2] * S.det[2];
        if (cos_det > 0.0f) {
          // surface peel e^-tau cos / pi on Stokes I (ARTES.f90:4600-4708)
          const Walk w = tau_walk_march(T, G, S, pos, S.det, cell, face, cnt[C_PASSES]);
          const int pix = pixel_of<IMAGE>(S, img, pos);
          if (w.exited && !w.error && w.tau < 50.0f && pix >= 0) {
            const float v = expf(-fminf(w.tau, 500.0f)) * cos_det / PI_F * stokes[0];
            book<IMAGE, 1>(img, pix, &v, acc);
            cnt[3] += 1;
          }
        }
        float lambert[3];
        direction_cosine(sqrtf(u[1]), TWO_PI_F * u[2], normal, lambert);
        for (int i = 0; i < 3; ++i) dir[i] = lambert[i];
        stokes[1] = stokes[2] = stokes[3] = 0.0f;
      }
    }
    if (err) return M_ERROR;
    if (absorbed) return M_FLOOR;
    if (st.grid_exit) return M_EXIT;
    tau_run = __fadd_rn(tau_run, tau_cell);
  }
  e032 = true;
  return M_ERROR;
}

// -------------------------------------------------------------- kernel ----

// Registers budgeted for four blocks of 256 an SM on a surface (64, spilling:
// more warps hide the latency), two with flow (128, no spills), the fastest
// of one to four on an H100 (PERF.md)
template <bool THERMAL, bool IMAGE, bool FLOW, bool COUNTS>
__global__ void __launch_bounds__(256, FLOW ? 2 : 4)
pool_march_kernel(Tables T, Grid3 G, const float* __restrict__ scal, Image img,
                  uint32_t n_photons, uint32_t key_hi, uint32_t id_lo, int max_scatter,
                  int flags, float surface_albedo, double* __restrict__ out_d,
                  unsigned long long* __restrict__ out_i, double* flow_g, double* flow_t,
                  double* flow_buf, unsigned long long* next_id, unsigned long long* lanes) {
  __shared__ unsigned long long lanes_sh[N_LANE];
  if constexpr (COUNTS) lanes_begin(lanes_sh, lanes);
  const int ncell = T.nr * G.nt * G.np;
  Flow fl{nullptr, nullptr};
  if constexpr (FLOW) fl = flow_begin(flow_g, flow_t, flow_buf, ncell);
  const Scal S = load_scal(scal);
  const bool crescent = (flags & F_CRESCENT) != 0;
  const bool biased = (flags & F_BIASED) != 0;
  const bool debug_stokes = (flags & F_DEBUG_STOKES) != 0;
  const bool no_scatter = (flags & F_NO_SCATTER) != 0;

  // I, Q, U, V sums, their squares (spectrum only), flux emitted, flux exit
  double acc[N_OUT_D] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  // scatter peels, photons capped, photons emitted, birth and surface peels,
  // photons abandoned, codes 031 / 032 / 034, Stokes anomalies, peel walks
  // failed, passes, passes that booked flow
  unsigned long long cnt[N_OUT_IM] = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull,
                                      0ull, 0ull, 0ull, 0ull, 0ull, 0ull};

  // the lane's photon: alive between an interaction and the scattering round
  // that follows it; tau is the optical depth its next march runs to. A
  // scatter peel that failed is recorded after the round's march, with the
  // walk's input state, unless that march failed too
  bool alive = false, peel_failed = false;
  uint32_t pid = 0u, ctr = 0u;
  int n_scat = 0;
  float pos[3], dir[3], st[4], d[6];
  int cell[3], face[2];
  float tau = 0.0f;
  float peel_pos[3] = {0.0f, 0.0f, 0.0f};
  int peel_cell[3] = {0, 0, 0}, peel_face[2] = {0, 0};

  // one loop iteration: a new photon's emission, prewalk and first march for
  // a lane without one, a scattering round, its peel and its march for a lane
  // with one
  while (true) {
    if (!alive) {
      // before the break: every lane's last pass counts
      if constexpr (COUNTS) lane_pass(lanes_sh, L_REFILL, lanes);
      const unsigned long long i = next_photon(next_id);
      if (i >= n_photons) break;
      pid = id_lo + (uint32_t)i;
      cnt[2] += 1;
      st[0] = 1.0f;
      st[1] = st[2] = st[3] = 0.0f;
      if constexpr (THERMAL) {
        draws6(key_hi, pid, d);
        st[0] = emit_thermal(T, G, S, d, biased, pos, dir, cell);
        face[0] = face[1] = 0;
        acc[8] += (double)st[0];
        ctr = 6;
        // birth peel: e^-tau / 4 pi on Stokes I (ARTES.f90:4519-4598); a
        // failed walk abandons the photon
        const Walk w = tau_walk_march(T, G, S, pos, S.det, cell, face, cnt[C_PASSES]);
        if (w.error) {
          cnt[C_ERR] += 1;
          cnt[C_EPEEL] += 1;
          continue;
        }
        const int pix = pixel_of<IMAGE>(S, img, pos);
        if (w.exited && w.tau < 50.0f && pix >= 0) {
          const float v = expf(-fminf(w.tau, 500.0f)) / FOUR_PI_F * st[0];
          book<IMAGE, 1>(img, pix, &v, acc);
          cnt[3] += 1;
        }
      } else {
        draws(key_hi, pid, 0u, 2, d);
        emit_stellar_fma(S, d, crescent, pos, dir);
        // the entry cell lies in the outermost shell, behind the outer face
        const float x = pos[0] * S.ob[0], y = pos[1] * S.ob[1], z = pos[2] * S.ob[2];
        cell[0] = T.nr - 1;
        locate_tp(G, x, y, z, sqrtf(norm2(x, y, z)), cell[1], cell[2]);
        face[0] = 1;
        face[1] = T.nr;
        ctr = 2;
      }

      // prewalk along the photon's direction, then the forced first interaction
      const Walk pre = tau_walk_march(T, G, S, pos, dir, cell, face, cnt[C_PASSES]);
      if (pre.error) {
        cnt[C_ERR] += 1;
        cnt[C_E031] += 1;
        record_error(G.rec, 31.0f, pid, pos, dir, cell, face, st[0], 0, 2.0f);
        continue;
      }
      draws(key_hi, pid, ctr, 1, d);
      ctr += 1;
      const bool thin = pre.tau < 1.0e-6f;
      if (thin && !pre.surface) continue;       // vacuum, no surface
      const bool forced = !thin && pre.tau < 50.0f;
      const float one_m_exp = 1.0f - expf(-pre.tau);
      tau = forced ? -logf(1.0f - d[0] * one_m_exp) : -logf(1.0f - d[0]);
      if (forced) st[0] *= one_m_exp;
      n_scat = 0;
    } else {
      // the scattering round after march n_scat (ARTES.f90:786-951)
      if constexpr (COUNTS) lane_pass(lanes_sh, L_ROUND, lanes);
      alive = false;
      if (n_scat > 0 && n_scat >= max_scatter) {
        cnt[1] += 1;
        continue;
      }
      heal_cell(T, G, S, pos, cell);
      const int cf = (cell[0] * G.nt + cell[1]) * G.np + cell[2];
      draws(key_hi, pid, ctr, 5, d);
      ctr += 5;
      if (d[0] < S.fstop) continue;                  // roulette
      const float alb = __ldg(T.albedo + cf);
      const float gamma = (alb < 1.0f && alb > 0.0f) ? alb / (1.0f - S.fstop) : 1.0f;
      for (int k = 0; k < 4; ++k) st[k] *= gamma;
      if (st[0] <= S.pmin) continue;

      float contrib[4];
      peel_prep(T, S, dir, cf, st, contrib);
      const int pix = pixel_of<IMAGE>(S, img, pos);
      float beta, c2b, s2b, alpha, alpha_deg;
      sample_beta(T, cf, st, d[1], d[2], beta, c2b, s2b);
      sample_alpha(T, cf, st, c2b, s2b, d[3], alpha, alpha_deg);
      float dir_new[3], m[16];
      direction_cosine(alpha, beta, dir, dir_new);
      matrix_at(T.scatter + (size_t)cf * N_ANGLE * 16, alpha_deg, m);
      polarization_rotation(alpha, c2b, s2b, beta < PI_F ? 1.0f : -1.0f, st, m, dir[2],
                            dir_new[2], false);
      for (int k = 0; k < 3; ++k) dir[k] = dir_new[k];
      if (debug_stokes && stokes_anomaly(st)) {
        // abandoned before its peel and march, recorded at site 4
        cnt[C_ERR] += 1;
        cnt[C_ANOM] += 1;
        record_error(G.rec, 50.0f, pid, pos, dir, cell, face, st[0], n_scat, 4.0f);
        continue;
      }

      const Walk peel = tau_walk_march(T, G, S, pos, S.det, cell, face, cnt[C_PASSES]);
      if (peel.error) {
        cnt[C_EPEEL] += 1;
        peel_failed = true;
        for (int k = 0; k < 3; ++k) {
          peel_pos[k] = pos[k];
          peel_cell[k] = cell[k];
        }
        peel_face[0] = face[0];
        peel_face[1] = face[1];
      } else if (peel.exited && peel.tau < 50.0f && pix >= 0) {
        const float w = expf(-fminf(peel.tau, 500.0f));
        float v[4];
        for (int k = 0; k < 4; ++k) v[k] = contrib[k] * w;
        book<IMAGE, 4>(img, pix, v, acc);
        cnt[0] += 1;
      }
      tau = -logf(1.0f - d[4]);
      n_scat += 1;
    }

    // march n_scat (the first march is march 0)
    bool e031, e032, e034;
    const int out = march_cells<IMAGE, FLOW>(T, G, S, surface_albedo, img, fl, key_hi, pid, pos,
                                             dir, cell, face, st, tau, ctr, acc, cnt, e031, e032,
                                             e034);
    if (out == M_ERROR) {
      cnt[C_ERR] += 1;
      cnt[C_E031] += e031;
      cnt[C_E032] += e032;
      cnt[C_E034] += e034;
      record_error(G.rec, error_code(e031, e034), pid, pos, dir, cell, face, st[0], n_scat,
                   n_scat == 0 ? 1.0f : 0.0f);
    } else if (peel_failed) {
      record_error(G.rec, 50.0f, pid, peel_pos, dir, peel_cell, peel_face, st[0], n_scat, 3.0f);
    }
    peel_failed = false;
    if (THERMAL && out == M_EXIT) acc[9] += (double)st[0];
    // scattering off: only the first march
    alive = out == M_INTER && !no_scatter;
  }

  if constexpr (FLOW) flow_end(flow_g, flow_t, fl, ncell);
  if constexpr (COUNTS) lanes_end(lanes_sh, lanes);
  reduce_block<N_OUT_D, N_OUT_IM>(acc, cnt, out_d, out_i);
}

using KernelFn = void (*)(Tables, Grid3, const float*, Image, uint32_t, uint32_t, uint32_t, int,
                          int, float, double*, unsigned long long*, double*, double*, double*,
                          unsigned long long*, unsigned long long*);
// the instantiation of a variant (bit 0 thermal, bit 1 image, bit 2 flow),
// counting or not
template <bool COUNTS>
KernelFn variant_fn(int variant) {
  switch (variant) {
    case 0: return pool_march_kernel<false, false, false, COUNTS>;
    case 1: return pool_march_kernel<true, false, false, COUNTS>;
    case 2: return pool_march_kernel<false, true, false, COUNTS>;
    case 3: return pool_march_kernel<true, true, false, COUNTS>;
    case 4: return pool_march_kernel<false, false, true, COUNTS>;
    case 5: return pool_march_kernel<true, false, true, COUNTS>;
    case 6: return pool_march_kernel<false, true, true, COUNTS>;
    default: return pool_march_kernel<true, true, true, COUNTS>;
  }
}

// the persistent grid of launch `a`, by the occupancy of the instantiation
// that does not count (its twin has the same launch bounds); 0 blocks when
// the variant is unknown or the card's occupancy cannot be read
int launch_grid(const PoolLaunch& a) {
  if (a.variant < 0 || a.variant > 7) return 0;
  const int resident = resident_blocks(a.variant, variant_fn<false>(a.variant), a.threads);
  return resident < 1 ? 0 : persistent_blocks(resident, a.n_photons, a.threads);
}

}  // namespace

// C entry point for ctypes: launches the instantiation of `variant` (bit 0
// thermal, bit 1 image, bit 2 flow) on `stream`, writes its grid into
// a->blocks and returns cudaGetLastError(). Reads the tables, the 3-D grid
// and surface_albedo of PoolLaunch, not the jump tables. out_d: 10 doubles
// as the radial kernel's; out_i: pool_grid3d's 9 counters, then the scatter
// and birth peel walks that failed, the passes of cell_face made and the
// passes that booked flow. `flags` as pool_radial's. `counters`, where not
// null, is N_LANE zeroed counters the launch adds its lane counts into
// (pool_common.cuh::lane_pass): it then launches the counting twin.
// The grid is persistent, as pool_grid3d's: the blocks the card holds at
// once (fewer for a small launch; artes_pool_march_blocks gives them), whose
// lanes take photon ids id_lo + *next_id from the launch's counter. The flow
// diagnostics go into flow_g (ncell, 3) and flow_t (ncell, 4), through a
// copy a block in flow_buf where that is given (pool_common.cuh::
// flow_begin), else straight.
extern "C" int artes_pool_march_launch(PoolLaunch* a, void* stream) {
  if (a->variant < 0 || a->variant > 7 || !threads_ok(a->threads))
    return (int)cudaErrorInvalidValue;
  const int blocks = launch_grid(*a);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  if (a->flow_buf != nullptr && blocks > a->flow_buf_blocks) return (int)cudaErrorInvalidValue;
  a->blocks = blocks;
  const KernelFn fn = a->counters != nullptr ? variant_fn<true>(a->variant)
                                             : variant_fn<false>(a->variant);
  fn<<<blocks, a->threads, 0, (cudaStream_t)stream>>>(
      tables_of(*a), grid_of(*a), a->scal, image_of(*a), a->n_photons, a->key_hi, a->id_lo,
      a->max_scatter, a->flags, a->surface_albedo, a->out_d, a->out_i, a->flow_g, a->flow_t,
      a->flow_buf, a->next_id, a->counters);
  return (int)cudaGetLastError();
}

// The blocks artes_pool_march_launch launches for `a` (0 when the card's
// occupancy cannot be read).
extern "C" int artes_pool_march_blocks(const PoolLaunch* a) { return launch_grid(*a); }

// Table sizes the wrapper must agree with (pool_common.cuh::common_layout):
// out_i's N_OUT_IM counters, N_LANE counters.
extern "C" int artes_pool_march_layout(int* sizes) {
  return common_layout(sizes, N_OUT_IM, N_LANE);
}
