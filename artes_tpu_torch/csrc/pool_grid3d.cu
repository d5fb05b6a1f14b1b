// Photon transport on 3-D (r, theta, phi) grids: one hand-written CUDA kernel
// for Hopper.
//
// Replaces the TPU kernel artes_tpu/transport/pallas_stream.py::_build_kernel
// (the fused regeneration-pool Pallas kernel) in its 3-D, surfaceless,
// flow-free specialisation: the jump environment (:683-723), cell_face
// (:751-921), the marching loop behind the jump-walk exit precheck
// (:934-1067), the jump tau walk of peels and prewalk (jumps.tau_walk_jumps),
// locate_tp (:1423-1450), the per-code error tallies (:1819-1828) and the
// per-lane forensics (:1830-1872). Its plain PyTorch version is
// artes_tpu_torch/transport/kernel.py::run_stream on a grid with ntheta > 1
// or nphi > 1.
//
// Four compile-time instantiations, pool_grid3d_kernel<THERMAL, IMAGE>, as
// pool_radial.cu has, sharing its emission, sampling, peel and booking code
// (pool_common.cuh) and, with pool_march.cu, the cell_face step, the cell
// lookups and the error records (pool_geom3d.cuh).
//
// Design. A persistent grid, as pool_radial.cu's: the blocks the card holds
// at once, each lane taking photon ids from the launch's counter
// (pool_common.cuh::next_photon) and running one step of its photon a loop
// iteration: a new photon's emission, prewalk and first march, or one
// scattering round and its march. A lane whose photon dies takes the next id
// in the next iteration, so no lane waits for the longest photon of a static
// share. Photon streams are keyed by (seed, photon id, draw site), on the
// per-photon draw-site schedule of the JAX pool:
//   emission: sites 0, 1 (stellar) or 0-5 (thermal);
//   prewalk fused with the forced first interaction: one site;
//   every scattering round: 5 sites (roulette, azimuth x2, zenith, tau);
//   every pass of a march's crossing loop: 3 sites, reserved for the
//     in-march Lambert draws whether or not a surface consumes them.
// Each photon's arithmetic is the same whichever lane runs it, so counts do
// not depend on the launch; only the order of the per-thread double sums
// moves.
// Peels, the prewalk and the exit precheck are jump walks: the closed-form
// radial chords carry the baseline opacity kbar[shell], and every face the
// ray crosses (nr-1 radial, NT-1 theta, NP phi faces, at run-time sizes)
// adds its opacity jump from the per-face difference tables dr/dtt/dpp. One
// pass up the radial faces solves each face's sphere once (nr + 2 roots a
// walk with the floor's and the outer face's) and takes from it both the
// kbar chords of the shell below and the face's two jumps. The
// phi wedge of a crossing is the count of phi half-plane crossings at or
// below it: a walk evaluates its NP half-plane crossings once, into its
// thread's column of a table in dynamic shared memory (NP x threads floats,
// given at launch), and every radial, theta and phi crossing reads them from
// there. Past PHI_TABLE_MAX half-planes the walk re-evaluates the NP
// crossings at every crossing instead (walk_jumps<false>, as on a grid
// without phi faces, which has none to count), on the same float32
// expression: both give the same wedge bit for bit. A photon whose sampled optical depth exceeds the
// walk's exact total leaves without marching; the others march cell_face
// cell by cell, at most max_crossings passes (error 032 beyond; 031 when no
// face is found, 034 at a degenerate floor bounce).
// Tables are indexed per cell in global memory: no mixture dedup, no cell
// cap. Given a buffer for them (pool_cuda passes one while
// artes_tpu_torch.spans records), a launch counts its warps' passes through
// the refill and round branches and their active lanes
// (pool_common.cuh::lane_pass), then its jump walks and those that read the
// phi table (count_walk).
//
// Rounding. The file builds with -fmad=false (_build.SOURCE_FLAGS): every
// float32 expression rounds op by op, as the plain version's PyTorch
// operations do, but the chains written with __fmaf_rn / __fmul_rn (the
// walks' geometry in the chains XLA compiles, geometry.fmadd on the plain
// side). Left to nvcc's contraction, the Stokes rotations, the scattering
// matrix product, the direction update, the sampling CDFs and the jump sums
// rounded differently from the plain version from a photon's first
// scattering on, and rare photons took other paths (on the Mie deck, 18
// peels against 8); op by op both take the same paths. The jump terms and
// the kbar chords are summed left to right in float32, as the plain
// version's radial.left_scan sums them: the jumps in the reference's order,
// the kbar chords in the port's own, the inbound chords from shell 0 up in
// one sum, the outbound ones in another, then the two sums (with the chords'
// torch.cumsum it parted photons 73722, 86952 and 132818 of grid3d_2496 at
// seed 9, and none without); acosf, cosf, sinf, expf, logf, tanf and atan2f
// round as PyTorch's functions do on the card (python -m
// artes_tpu_torch.measure parting).
//
// Errors. Per-code counts are per-thread counters reduced like the tallies.
// Each erroring thread also appends one 16-float record (code, photon id as
// its bit pattern, position, direction, cell, face, Stokes I, scatterings,
// site 0: a transport march) with one atomicAdd on a counter into a bounded
// buffer: a full buffer drops rows, never counts. The wrapper orders the rows
// by photon id.
//
// What bounds it on an H100: arithmetic, divergence and table latency, not
// memory bandwidth. Marches differ by tens of crossings between the photons
// of a warp; a jump walk costs NP plane evaluations, nr + 2 sphere roots and
// (2 nr + 2 NT + NP) crossings, each with NP table reads (NP plane
// evaluations each past PHI_TABLE_MAX); the per-cell scatter tables (36 MB
// at 2,496 cells) are gathered at random from L2.

#include "pool_geom3d.cuh"

namespace {

// ----------------------------------------------------------- jump walk ----

// the most phi half-planes a walk keeps in its table: at 32 x 256 threads x
// 4 B = 32 KB a block the four resident blocks of __launch_bounds__ take
// 128 KB of an SM's 228 KB of shared memory and L1, and no block needs the
// opt-in past 48 KB (the gate's grids have at most 24 phi faces)
constexpr int PHI_TABLE_MAX = 32;
// the walk counters after the N_LANE lane counters: jump walks, and those
// that read the phi table
enum { W_WALKS = 0, W_TABLED = 1, N_WALK = 2 };

// whether the jump walks of a grid of np phi faces keep their phi crossings
// in a table (phi_column)
__host__ __device__ __forceinline__ bool phi_tabled(int np) {
  return np > 1 && np <= PHI_TABLE_MAX;
}

// bytes of dynamic shared memory of a block of `threads` on a grid of np
// phi faces: the walks' phi tables, none where the walks recount
inline size_t phi_table_bytes(int np, int threads) {
  return phi_tabled(np) ? (size_t)np * threads * sizeof(float) : 0;
}

// both roots of A s^2 + 2 Bh s + C = 0 (jumps._stable_roots)
__device__ __forceinline__ bool stable_roots(float A, float Bh, float C, float& lo, float& hi) {
  const float lin_eps = 1.0e-30f;
  const float disc = Bh * Bh - A * C;
  const bool ok = disc > 0.0f;
  const float q = -(Bh + (Bh >= 0.0f ? 1.0f : -1.0f) * sqrtf(ok ? disc : 0.0f));
  const bool a_small = fabsf(A) < lin_eps;
  const float r1 = a_small ? BIG : q / A;
  const float r2 = C / (q == 0.0f ? 1.0f : q);
  const bool lin_ok = a_small && fabsf(Bh) >= lin_eps;
  lo = lin_ok ? -C / (2.0f * Bh) : fminf(r1, r2);
  hi = lin_ok ? BIG : fmaxf(r1, r2);
  return ok || lin_ok;
}

// the ray's squared radius A s^2 + 2 Bq s + Cq in the chains XLA compiles
// (jumps.quad_terms), where the closed-form kernel's make_ray
// (pool_common.cuh) leaves it to nvcc
__device__ __forceinline__ Ray make_ray_fma(const Scal& S, const float* p, const float* d) {
  Ray r;
  r.A = form(S, d, d);
  r.Bq = form(S, p, d);
  r.Cq = form(S, p, p);
  r.inv_a = 1.0f / r.A;
  r.mb = -r.Bq * r.inv_a;
  r.sgn_b = r.Bq >= 0.0f ? 1.0f : -1.0f;
  return r;
}

// stable q-form roots of the face sphere r_face, Cq - r^2 and the
// discriminant in the chains XLA compiles (jumps.chord_disc), where the
// closed-form kernel's roots leaves them to nvcc
__device__ __forceinline__ bool roots_fma(const Ray& r, float r_face, float& lo, float& hi) {
  const float Cj = __fmaf_rn(-r_face, r_face, r.Cq);
  const float disc = __fmaf_rn(r.Bq, r.Bq, -__fmul_rn(r.A, Cj));
  const bool ok = disc > 0.0f;
  const float q = -(r.Bq + r.sgn_b * sqrtf(ok ? disc : 0.0f));
  const float r1 = q * r.inv_a;
  const float r2 = Cj / (q == 0.0f ? 1.0f : q);
  lo = ok ? fminf(r1, r2) : r.mb;
  hi = ok ? fmaxf(r1, r2) : r.mb;
  return ok;
}

// shell m's part of the jump walk's kbar baseline, from the clamped roots of
// its faces, m (e_lo, h_lo) and m + 1 (e_hi, h_hi): the inbound chord, cut at
// the floor's s_surf, into tau_in, and the outbound chord, where the ray does
// not end on the floor, into tau_out (jumps.tau_walk_jumps)
__device__ __forceinline__ void add_shell(float kb, float e_lo, float h_lo, float e_hi,
                                          float h_hi, float s_surf, bool surface_hit,
                                          float& tau_in, float& tau_out) {
  tau_in += kb * fmaxf(fminf(e_lo, s_surf) - fminf(e_hi, s_surf), 0.0f);
  if (!surface_hit) tau_out += kb * fmaxf(h_hi - h_lo, 0.0f);
}

// a ray for the jump walk: the sphere quadratic and what the crossings need
struct JumpRay {
  const float* p;
  const float* d;
  Ray r;
  float ax, by, sq_c, s_end;
  int cp0;
  bool lz_pos;
};

// parameter of the crossing of phi half-plane j, BIG when there is none
__device__ __forceinline__ float phi_crossing(const Grid3& G, const JumpRay& J, int j) {
  const float sin_p = __ldg(G.phi_sin + j), cos_p = __ldg(G.phi_cos + j);
  const float denom = J.by * J.d[1] * cos_p - J.ax * J.d[0] * sin_p;
  const float s = (J.ax * J.p[0] * sin_p - J.by * J.p[1] * cos_p) / (denom == 0.0f ? 1.0f : denom);
  const float xs = J.ax * (J.p[0] + s * J.d[0]), ys = J.by * (J.p[1] + s * J.d[1]);
  const bool valid = fabsf(denom) > 0.0f && s > 0.0f && (xs * cos_p + ys * sin_p) > 0.0f;
  return valid ? s : BIG;
}

// this thread's column of the walks' phi table in dynamic shared memory:
// entry j at phi_column()[j * blockDim.x], so a warp's lanes read 32 banks
__device__ __forceinline__ float* phi_column() {
  extern __shared__ float phi_table[];
  return phi_table + threadIdx.x;
}

// the crossing of phi half-plane j: from the walk's table (TABLED), or
// evaluated anew
template <bool TABLED>
__device__ __forceinline__ float phi_at(const Grid3& G, const JumpRay& J, int j) {
  if constexpr (TABLED) return phi_column()[j * blockDim.x];
  else return phi_crossing(G, J, j);
}

// phi wedge at parameter t: the signed count of half-plane crossings at or
// below t, wrapped (phi is monotone along a straight ray). Unrolled, a pass
// has four table reads in flight; rolled, each waits on the one before it
// (PERF.md: 1.94 s against 1.56 s a 2^24-photon job on the deck).
template <bool TABLED>
__device__ int cp_at(const Grid3& G, const JumpRay& J, float t) {
  if (G.np == 1) return 0;
  int cnt = 0;
#pragma unroll 4
  for (int j = 0; j < G.np; ++j) cnt += phi_at<TABLED>(G, J, j) <= t;
  int cp = J.lz_pos ? J.cp0 + cnt : J.cp0 - cnt;
  if (cp < 0) cp += G.np;
  if (cp < 0) cp += G.np;
  if (cp >= G.np) cp -= G.np;
  if (cp >= G.np) cp -= G.np;
  return cp;
}

// shell of a squared transformed radius: interior faces with rf^2 <= r2
__device__ __forceinline__ int locate_m(const Tables& T, const Grid3& G, float r2) {
  int lo = 0, hi = T.nr - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(G.rf2 + mid) <= r2) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// one crossing's term of the jump sum: delta * max(s_end - t, 0) for a
// crossing at 0 < t < BIG
__device__ __forceinline__ float jump_term(float delta, float s_end, float t) {
  return delta * fmaxf(s_end - t, 0.0f);
}

// one jump walk of the active lanes into the walk counters `walks` (shared
// memory; nullptr while the launch counts nothing)
__device__ __forceinline__ void count_walk(unsigned long long* walks, bool tabled) {
  if (walks == nullptr) return;
  const unsigned int mask = __activemask();
  if ((int)(threadIdx.x & 31) == __ffs(mask) - 1) {
    atomicAdd(walks + W_WALKS, (unsigned long long)__popc(mask));
    if (tabled) atomicAdd(walks + W_TABLED, (unsigned long long)__popc(mask));
  }
}

// optical depth from (p, d) to the grid boundary or the photon floor
// (jumps.tau_walk_jumps); `cell` is the caller's current cell; `walks` as
// count_walk's; TABLED: the phi crossings in the walk's table
template <bool TABLED>
__device__ float walk_jumps(const Tables& T, const Grid3& G, const Scal& S, const float* p,
                            const float* d, const int* cell, bool& surface_hit,
                            unsigned long long* walks) {
  JumpRay J;
  J.p = p;
  J.d = d;
  J.r = make_ray_fma(S, p, d);
  J.ax = S.ob[0];
  J.by = S.ob[1];
  J.sq_c = S.ob[2];
  J.cp0 = cell[2];
  J.lz_pos = (p[0] * d[1] - p[1] * d[0]) > 0.0f;
  // the NP half-plane crossings, once a walk (the launch sized the table)
  if (TABLED)
    for (int j = 0; j < G.np; ++j) phi_column()[j * blockDim.x] = phi_crossing(G, J, j);
  count_walk(walks, TABLED);
  const int nr = T.nr, NT = G.nt, NP = G.np;
  // the floor and the outer face first: where the path ends, s_end, which
  // every jump term needs
  float lo, hi;
  surface_hit = roots_fma(J.r, S.rfloor, lo, hi) && lo > S.pos_eps;
  const float s_surf = surface_hit ? lo : BIG;
  roots_fma(J.r, __ldg(T.rfront + nr), lo, hi);
  const float e_top = fmaxf(lo, 0.0f);
  J.s_end = surface_hit ? s_surf : fmaxf(hi, 0.0f);
  const float s_end = J.s_end;
  const float pz = p[2], dz = d[2];

  float dk_sum = __ldg(G.dk + (cell[0] * NT + cell[1]) * NP + cell[2]) * s_end;

  // the radial faces in one pass up, each face's roots solved once: face j
  // closes shell j - 1's kbar chords (add_shell) and adds its two jumps,
  // inbound at e (shell j -> j-1) and outbound at h; the outer face's roots
  // close shell nr - 1 (its h is s_end wherever the outbound chords count)
  roots_fma(J.r, __ldg(T.rfront), lo, hi);
  float e_lo = fmaxf(lo, 0.0f), h_lo = fmaxf(hi, 0.0f);
  float tau_in = 0.0f, tau_out = 0.0f;
  for (int j = 1; j < nr; ++j) {
    const float rf = __ldg(T.rfront + j);
    roots_fma(J.r, rf, lo, hi);
    const float e = fmaxf(lo, 0.0f), h = fmaxf(hi, 0.0f);
    add_shell(__ldg(G.kbar + j - 1), e_lo, h_lo, e, h, s_surf, surface_hit, tau_in, tau_out);
    const float inv_rf = 1.0f / rf;
    const float* row = G.dr + (size_t)(j - 1) * NT * NP;
    for (int k = 0; k < 2; ++k) {
      const float t = k == 0 ? e : h;
      if (!(t > 0.0f && t < BIG)) continue;
      const int ct_i = ct_at(G, J.sq_c * (pz + t * dz) * inv_rf);
      const int cp_i = cp_at<TABLED>(G, J, t);
      const float delta = __ldg(row + ct_i * NP + cp_i);
      dk_sum += jump_term(k == 0 ? -delta : delta, s_end, t);
    }
    e_lo = e;
    h_lo = h;
  }
  add_shell(__ldg(G.kbar + nr - 1), e_lo, h_lo, e_top, s_end, s_surf, surface_hit, tau_in,
            tau_out);
  const float tau_bar = tau_in + tau_out;

  // theta faces: the cone's low then high root, or the plane's one crossing
  if (NT > 1) {
    const float a2 = S.ob[0] * S.ob[0], b2 = S.ob[1] * S.ob[1], c2 = S.ob[2] * S.ob[2];
    const float s_plane = fabsf(dz) > 0.0f ? -pz / dz : BIG;
    for (int f = 1; f < NT; ++f) {
      const float tan_t = __ldg(G.theta_tan + f);
      const float tan2 = tan_t * tan_t;
      const int flags = __ldg(G.theta_flags + f);
      const bool is_cone = flags & 1, above = flags & 2;
      const float qa = a2 * d[0] * d[0] + b2 * d[1] * d[1] - c2 * dz * dz * tan2;
      const float qb = a2 * p[0] * d[0] + b2 * p[1] * d[1] - c2 * pz * dz * tan2;
      const float qc = a2 * p[0] * p[0] + b2 * p[1] * p[1] - c2 * pz * pz * tan2;
      float root[2];
      const bool ok = stable_roots(qa, qb, qc, root[0], root[1]);
      const float* row = G.dtt + (size_t)(f - 1) * nr * NP;
      for (int k = 0; k < 2; ++k) {
        const float z_r = pz + root[k] * dz;
        const bool nappe_ok = above ? z_r > 0.0f : z_r < 0.0f;
        const float t = is_cone ? ((ok && nappe_ok) ? root[k] : BIG) : (k == 0 ? s_plane : BIG);
        if (!(t > 0.0f && t < BIG)) continue;
        const float r2 = (J.r.A * t + 2.0f * J.r.Bq) * t + J.r.Cq;
        // crossing direction: the sign of d(cos theta)/ds at t
        const float u = J.sq_c * dz * r2 - J.sq_c * (pz + t * dz) * (J.r.A * t + J.r.Bq);
        const int m_i = locate_m(T, G, r2);
        const int cp_i = cp_at<TABLED>(G, J, t);
        const float delta = __ldg(row + m_i * NP + cp_i);
        dk_sum += jump_term(u < 0.0f ? delta : -delta, s_end, t);
      }
    }
  }

  // phi faces
  if (NP > 1) {
    for (int f = 0; f < NP; ++f) {
      const float t = phi_at<TABLED>(G, J, f);
      if (!(t > 0.0f && t < BIG)) continue;
      const float r2 = (J.r.A * t + 2.0f * J.r.Bq) * t + J.r.Cq;
      const int m_i = locate_m(T, G, r2);
      const int ct_i = ct_at(G, J.sq_c * (pz + t * dz) / sqrtf(fmaxf(r2, 1.0e-30f)));
      const float delta = __ldg(G.dpp + (size_t)f * nr * NT + m_i * NT + ct_i);
      dk_sum += jump_term(J.lz_pos ? delta : -delta, s_end, t);
    }
  }
  return fmaxf(tau_bar + dk_sum, 0.0f);
}

// the jump walk of walk_jumps, its phi crossings in a table where the grid's
// phi faces fit one (phi_tabled), else evaluated anew at each crossing
__device__ float tau_walk_jumps(const Tables& T, const Grid3& G, const Scal& S, const float* p,
                                const float* d, const int* cell, bool& surface_hit,
                                unsigned long long* walks) {
  return phi_tabled(G.np) ? walk_jumps<true>(T, G, S, p, d, cell, surface_hit, walks)
                          : walk_jumps<false>(T, G, S, p, d, cell, surface_hit, walks);
}

// --------------------------------------------------------------- march ----

// march cell by cell until the running optical depth passes tau
// (kernel._march_cells): updates pos, cell, face and the draw-site counter;
// returns M_INTER, M_EXIT, M_FLOOR (absorbed at the photon floor) or
// M_ERROR with the per-code flags set
__device__ int march_cells(const Tables& T, const Grid3& G, const Scal& S, float* pos,
                           const float* dir, int* cell, int* face, float tau, uint32_t& ctr,
                           bool& e031, bool& e032, bool& e034) {
  e031 = e032 = e034 = false;
  float tau_run = 0.0f;
  for (int it = 0; it < G.max_crossings; ++it) {
    Step st;
    cell_face(T, G, S, pos, dir, cell, face, st);
    const float k = __ldg(T.opacity + (cell[0] * G.nt + cell[1]) * G.np + cell[2]);
    // the running optical depth as XLA compiles it (kernel._march_cells)
    const float tau_cell = __fmul_rn(st.dist, k);
    const bool interact = __fmaf_rn(st.dist, k, tau_run) > tau;
    const float step = interact ? (tau - tau_run) / (k == 0.0f ? 1.0f : k) : st.dist;
    for (int i = 0; i < 3; ++i) pos[i] = __fmaf_rn(step, dir[i], pos[i]);
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
    if (err) return M_ERROR;
    // without a Lambert surface the photon floor absorbs
    if (st.axis == 1 && st.idx == G.cell_depth) return M_FLOOR;
    if (st.grid_exit) return M_EXIT;
    tau_run = __fadd_rn(tau_run, tau_cell);
  }
  e032 = true;
  return M_ERROR;
}

// -------------------------------------------------------------- kernel ----

// four blocks of 256 threads an SM hold ptxas to 64 registers a thread: of
// one, two, three and four blocks, timed on an H100 (PERF.md), the
// fastest on grid3d_2496, grid3d_thermal and blended_5184, though it spills
template <bool THERMAL, bool IMAGE>
__global__ void __launch_bounds__(256, 4)
pool_grid3d_kernel(Tables T, Grid3 G, const float* __restrict__ scal, Image img,
                   uint32_t n_photons, uint32_t key_hi, uint32_t id_lo, int max_scatter,
                   int flags, double* __restrict__ out_d, unsigned long long* __restrict__ out_i,
                   unsigned long long* next_id, unsigned long long* lanes) {
  // the lane counters, then the walk counters (N_WALK)
  __shared__ unsigned long long lanes_sh[N_LANE + N_WALK];
  if (lanes != nullptr && threadIdx.x < N_WALK) lanes_sh[N_LANE + threadIdx.x] = 0ull;
  lanes_begin(lanes_sh, lanes);
  unsigned long long* walks = lanes != nullptr ? lanes_sh + N_LANE : nullptr;
  const Scal S = load_scal(scal);
  const bool crescent = (flags & F_CRESCENT) != 0;
  const bool biased = (flags & F_BIASED) != 0;
  const bool debug_stokes = (flags & F_DEBUG_STOKES) != 0;
  const bool no_scatter = (flags & F_NO_SCATTER) != 0;

  // I, Q, U, V sums, their squares (spectrum only), flux emitted, flux exit
  double acc[N_OUT_D] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  // scatter peels, photons capped, photons emitted, birth peels, photons
  // abandoned, codes 031 / 032 / 034, Stokes anomalies
  unsigned long long cnt[N_OUT_I3] = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull, 0ull, 0ull, 0ull};

  // the lane's photon: alive between an interaction and the scattering round
  // that follows it; tau is the optical depth its next march runs to, and
  // tau_path (path_surface) the exact total of its path, the exit precheck
  bool alive = false, path_surface = false;
  uint32_t pid = 0u, ctr = 0u;
  int n_scat = 0;
  float pos[3], dir[3], st[4], d[6];
  int cell[3], face[2];
  float tau = 0.0f, tau_path = 0.0f;

  // one loop iteration: a new photon's emission, prewalk and first march for
  // a lane without one, a scattering round and its march for a lane with one
  while (true) {
    if (!alive) {
      lane_pass(lanes_sh, L_REFILL, lanes);   // before the break: every lane's last pass counts
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
        // birth peel: e^-tau / 4 pi on Stokes I (ARTES.f90:4519-4598)
        bool surf;
        const float tau_b = tau_walk_jumps(T, G, S, pos, S.det, cell, surf, walks);
        const int pix = pixel_of<IMAGE>(S, img, pos);
        if (!surf && tau_b < 50.0f && pix >= 0) {
          const float v = expf(-fminf(tau_b, 500.0f)) / FOUR_PI_F * st[0];
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

      // prewalk along the photon's direction + forced first interaction; the
      // prewalk's total is the exit precheck of the first march
      tau_path = tau_walk_jumps(T, G, S, pos, dir, cell, path_surface, walks);
      draws(key_hi, pid, ctr, 1, d);
      ctr += 1;
      const bool thin = tau_path < 1.0e-6f;
      if (thin && !path_surface) continue;       // vacuum, no surface
      const bool forced = !thin && tau_path < 50.0f;
      const float one_m_exp = 1.0f - expf(-tau_path);
      tau = forced ? -logf(1.0f - d[0] * one_m_exp) : -logf(1.0f - d[0]);
      if (forced) st[0] *= one_m_exp;
      n_scat = 0;
    } else {
      // the scattering round after march n_scat (ARTES.f90:786-951)
      lane_pass(lanes_sh, L_ROUND, lanes);
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

      bool peel_surface;
      const float tau_peel = tau_walk_jumps(T, G, S, pos, S.det, cell, peel_surface, walks);
      if (!peel_surface && tau_peel < 50.0f && pix >= 0) {
        const float w = expf(-fminf(tau_peel, 500.0f));
        float v[4];
        for (int k = 0; k < 4; ++k) v[k] = contrib[k] * w;
        book<IMAGE, 4>(img, pix, v, acc);
        cnt[0] += 1;
      }

      tau = -logf(1.0f - d[4]);
      tau_path = tau_walk_jumps(T, G, S, pos, dir, cell, path_surface, walks);
      n_scat += 1;
    }

    // march n_scat (the first march is march 0)
    int out;
    if (tau >= tau_path) {
      out = path_surface ? M_FLOOR : M_EXIT;    // cannot reach tau: no march
    } else {
      bool e031, e032, e034;
      out = march_cells(T, G, S, pos, dir, cell, face, tau, ctr, e031, e032, e034);
      if (out == M_ERROR) {
        cnt[C_ERR] += 1;
        cnt[C_E031] += e031;
        cnt[C_E032] += e032;
        cnt[C_E034] += e034;
        record_error(G.rec, error_code(e031, e034), pid, pos, dir, cell, face, st[0], n_scat,
                     0.0f);
      }
    }
    if (THERMAL && out == M_EXIT) acc[9] += (double)st[0];
    // scattering off: only the first march
    alive = out == M_INTER && !no_scatter;
  }

  lanes_end(lanes_sh, lanes);
  if (lanes != nullptr && threadIdx.x < N_WALK)
    atomicAdd(lanes + N_LANE + threadIdx.x, lanes_sh[N_LANE + threadIdx.x]);
  reduce_block<N_OUT_D, N_OUT_I3>(acc, cnt, out_d, out_i);
}

using KernelFn = void (*)(Tables, Grid3, const float*, Image, uint32_t, uint32_t, uint32_t, int,
                          int, double*, unsigned long long*, unsigned long long*,
                          unsigned long long*);
KernelFn variant_fn(int variant) {
  switch (variant) {
    case 0: return pool_grid3d_kernel<false, false>;
    case 1: return pool_grid3d_kernel<true, false>;
    case 2: return pool_grid3d_kernel<false, true>;
    case 3: return pool_grid3d_kernel<true, true>;
    default: return nullptr;
  }
}

// the grid of launch `a` of kernel `fn` with `smem` bytes of dynamic shared
// memory a block: the persistent grid, as pool_radial's; 0 blocks when the
// occupancy query fails
int launch_grid(const PoolLaunch& a, KernelFn fn, size_t smem) {
  const int resident = resident_blocks(a.variant, fn, a.threads, smem);
  return resident < 1 ? 0 : persistent_blocks(resident, a.n_photons, a.threads);
}

}  // namespace

// C entry point for ctypes: launches the instantiation of `variant` (bit 0
// thermal, bit 1 image) on `stream`, writes its grid into a->blocks and
// returns cudaGetLastError(). Reads the tables, the 3-D grid and the jump
// tables of PoolLaunch; not the flow fields. out_d: 10 doubles as the radial
// kernel's; out_i: its first 4 counters, then photons abandoned, codes 031 /
// 032 / 034 and Stokes anomalies. `flags` as pool_radial's. The grid is
// persistent, as pool_radial's: the blocks the card holds at once, whose
// lanes take photon ids id_lo + *next_id from the launch's counter.
// `counters`, where not null, is N_LANE + N_WALK zeroed counters the launch
// adds its lane counts (pool_common.cuh::lane_pass) and its walk counts
// (count_walk) into. The launch gives each block phi_table_bytes of dynamic
// shared memory.
extern "C" int artes_pool_grid3d_launch(PoolLaunch* a, void* stream) {
  const KernelFn fn = variant_fn(a->variant);
  if (fn == nullptr || !threads_ok(a->threads)) return (int)cudaErrorInvalidValue;
  const size_t smem = phi_table_bytes(a->nphi, a->threads);
  const int blocks = launch_grid(*a, fn, smem);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  a->blocks = blocks;
  fn<<<blocks, a->threads, smem, (cudaStream_t)stream>>>(
      tables_of(*a), grid_of(*a), a->scal, image_of(*a), a->n_photons, a->key_hi, a->id_lo,
      a->max_scatter, a->flags, a->out_d, a->out_i, a->next_id, a->counters);
  return (int)cudaGetLastError();
}

// The blocks artes_pool_grid3d_launch launches for `a`, whose phi faces
// size its blocks' shared memory; 0 when the occupancy query fails.
extern "C" int artes_pool_grid3d_blocks(const PoolLaunch* a) {
  const KernelFn fn = variant_fn(a->variant);
  return fn == nullptr ? 0 : launch_grid(*a, fn, phi_table_bytes(a->nphi, a->threads));
}

// Table sizes the wrapper must agree with (pool_common.cuh::common_layout):
// out_i's N_OUT_I3 counters, N_LANE + N_WALK counters; then PHI_TABLE_MAX.
extern "C" int artes_pool_grid3d_layout(int* sizes) {
  const int n = common_layout(sizes, N_OUT_I3, N_LANE + N_WALK);
  sizes[n] = PHI_TABLE_MAX;
  return n + 1;
}
