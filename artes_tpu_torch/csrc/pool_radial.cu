// Photon transport on radial grids: one hand-written CUDA kernel for Hopper.
//
// Replaces the TPU kernel artes_tpu/transport/pallas_stream.py::_build_kernel
// (the fused regeneration-pool Pallas kernel) in its RADIAL, surfaceless
// specialisations: stellar or thermal sources, a single pixel (a Stokes
// spectrum) or an nx x ny image, with or without flow diagnostics. Its plain
// PyTorch version is artes_tpu_torch/transport/kernel.py::run_stream.
//
// Eight compile-time instantiations, pool_radial_kernel<THERMAL, IMAGE, FLOW>,
// dispatched from the one C entry point, so the stellar spectrum keeps its
// own register budget:
//   THERMAL: emission from the emissivity CDF (sites 0-5, isotropic or
//     Gordon-biased), the birth peel e^-tau/4pi on Stokes I, and the
//     flux_emitted / flux_exit tallies (pallas_stream.py:1347-1421,
//     :1688-1698, :1874-1882);
//   IMAGE: each accepted peel is added into its pixel of an (npix, 8) double
//     and (npix, 2) 64-bit count detector with global atomics (the TPU's
//     MXU one-hot splat, :1711-1779). Double and 64-bit atomics are exact
//     per add, so the TPU's bf16 hi/lo split and count-row collapse have
//     no counterpart.
//   FLOW: every shell segment a march walks books energy x length on the
//     local (r, theta, phi) unit vectors at the segment's end, and every
//     full crossing its energy up or down (the flow hook of radial.march,
//     pallas_stream.py:1626-1665, :1970-1988): double reductions
//     (red.global.add.f64, which the thread does not wait for) into the
//     block's copy of the 7 nr sums in a global buffer, added into the
//     result once a block (pool_common.cuh).
// Crescent sampling and the off-axis stellar beam are runtime scalars.
//
// Design. A persistent grid: exactly the blocks the card holds at once,
// each lane running photons one after another. Photon streams are keyed by
// (seed, photon id, draw site), so no lane pool, refill ranking or stage
// machine is needed, and the per-photon draw-site schedule is the one of the
// JAX and plain versions:
//   emission: sites 0, 1 (stellar) or 0-5 (thermal, then the birth peel,
//     which draws nothing);
//   prewalk fused with the forced first interaction: one site;
//   every scattering round: 5 sites (roulette, azimuth x2, zenith, tau).
// One loop iteration is one step of a lane's photon: a lane without a photon
// takes the next id from the launch's counter (one atomicAdd for the lanes
// of a warp that ask together), emits it and runs its prewalk and first
// march; a lane with one runs one scattering round. A lane whose new photon
// meets its first interaction goes on into that photon's first round in the
// same iteration, beside the warp's other lanes, instead of sitting the
// round out; one whose photon leaves, reaches the floor or ends there
// (scattering off) takes a new one in the next iteration. So the lanes of a
// warp stay busy until the ids run out instead of waiting for the longest
// photon of a static share, and no block holds an SM for its slowest
// photon. Each photon's arithmetic is the same whichever lane runs it, and
// in whichever iteration; only the order in which the per-thread double
// sums add photons moves.
// The closed-form shell-chord walks (artes_tpu/transport/radial.py) need no
// per-face arrays: face roots are computed on the fly in path order.
// Tables live in global memory and are read per cell (__ldg). Per-thread
// tallies are double (Stokes sums and squares, fluxes) and 64-bit integers
// (counts), reduced per block in shared memory and added with one atomicAdd
// per tally. --debug-stokes (runtime flag F_DEBUG_STOKES) abandons a photon
// whose Stokes vector leaves the cone I^2 >= Q^2 + U^2 + V^2 after a
// scattering and records it (error 050, site 4); photon:scattering=off
// (F_NO_SCATTER) ends every photon at its first interaction.
//
// The device code it shares with pool_grid3d.cu (draws, chords, Stokes
// algebra, samplers, peel, booking, reduction) is in pool_common.cuh.
//
// Rounding. The file builds with -fmad=false (_build.SOURCE_FLAGS): every
// float32 expression rounds op by op, as the plain version's PyTorch
// operations do, but norm2's __fmaf_rn chain. Contracted, the grazing
// entries of the crescent parted trajectories past pool_cuda.AGREE on
// BASELINE #2's cloud deck at 177.5 deg (PERF.md).
//
// What bounds it on an H100: arithmetic and latency, not memory: a long
// dependent chain (threefry, the two walks, the azimuth Newton, the 15 x 12
// zenith search, the matrix) at 64 registers a thread for the stellar
// spectrum, four blocks of 256 an SM (128 and two for the others). The
// image splat adds ten global atomics per accepted peel, which
// contend on the lit pixels. A compile-time define ARTES_POOL_CLOCKS builds
// the instrumented library pool_radial_clocks (python -m
// artes_tpu_torch.measure clocks), which times each phase of the loop per
// warp with clock64. ARTES_F32_LANES=<lanes> builds pool_radial_lanes, which
// also sums the scatter peels as the TPU kernel sums a single pixel: in
// float32, per lane, over a whole launch (artes_tpu_torch.baselines
// .record_sums reads it).
// Given a buffer for them (pool_cuda passes one while artes_tpu_torch.spans
// records), a launch counts its warps' passes through the loop's refill and
// round branches and the lanes active at each (pool_common.cuh::lane_pass),
// in every build and every instantiation but the stellar image (CountsLanes),
// and, in every instantiation, stamps when its blocks leave the loop
// (drain_stamp): the drain, from the first block's exit to the last's, in
// which SMs empty.

#include "pool_common.cuh"

namespace {

// ------------------------------------------------- closed-form radial ----

// the ray-constant coefficients of the flow projections (radial.march's
// flow hook): along p + t d, r^2 and rho^2 = x^2 + y^2 are quadratics of t
struct FlowRay {
  float pd, p2, pdxy, pq2, dq2, lz, pz, dz;
};

__device__ __forceinline__ FlowRay make_flow_ray(const float* p, const float* d) {
  FlowRay f;
  f.pd = p[0] * d[0] + p[1] * d[1] + p[2] * d[2];
  f.p2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
  f.pdxy = p[0] * d[0] + p[1] * d[1];
  f.pq2 = p[0] * p[0] + p[1] * p[1];
  f.dq2 = d[0] * d[0] + d[1] * d[1];
  f.lz = p[0] * d[1] - p[1] * d[0];
  f.pz = p[2];
  f.dz = d[2];
  return f;
}

// book one walked segment of shell m that ends at parameter t after the
// length dist: the projections at its end and, for a full crossing, the
// energy in column 0 (outward) or 1 (inward); counts the segment in n_booked
__device__ __forceinline__ void book_segment(const Flow& fl, const FlowRay& f, int m, float energy,
                                             float dist, float t, bool crossed, int column,
                                             unsigned long long& n_booked) {
  const float r2 = t * (t + 2.0f * f.pd) + f.p2;
  const float rho2 = (f.dq2 * t + 2.0f * f.pdxy) * t + f.pq2;
  const float inv_r = rsqrtf(fmaxf(r2, 1.0e-30f));
  const float inv_rho = rsqrtf(fmaxf(rho2, 1.0e-30f));
  const float w = energy * dist;
  const float tnum = (f.pz + t * f.dz) * (f.pdxy + t * f.dq2) - rho2 * f.dz;
  flow_add(fl, m, (f.pd + t) * inv_r * w, tnum * (inv_rho * inv_r) * w, f.lz * inv_rho * w,
           crossed ? column : -1, energy);
  n_booked += 1;
}

// march to the optical depth tau_budget (radial.march): M_INTER at an
// interaction, with the path length s_stop and the shell cr; M_EXIT when the
// photon leaves the grid through the top, M_FLOOR when it reaches the floor
// (absorbed). FLOW books every segment walked, of a photon of Stokes I
// `energy`, and counts them in n_booked
template <bool FLOW>
__device__ int march(const Tables& T, const Scal& S, const float* p, const float* d,
                      float tau_budget, float& s_stop, int& cr, float energy, const Flow& fl,
                      unsigned long long& n_booked) {
  const Ray r = make_ray(S, p, d);
  FlowRay f;
  if constexpr (FLOW) f = make_flow_ray(p, d);
  float s_surf;
  const bool surface_hit = floor_hit(r, S, s_surf);
  float cum = 0.0f;
  float e_hi = face_in(r, __ldg(T.rfront + T.nr));
  for (int m = T.nr - 1; m >= 0; --m) {
    const float e_lo = face_in(r, __ldg(T.rfront + m));
    const float start = fminf(e_hi, s_surf);
    const float seg = fmaxf(fminf(e_lo, s_surf) - start, 0.0f);
    const float k = __ldg(T.opacity + m);
    const float c_new = cum + k * seg;
    if (c_new > tau_budget) {
      s_stop = start + (tau_budget - cum) / (k == 0.0f ? 1.0f : k);
      cr = m;
      if constexpr (FLOW) {
        if (seg > 0.0f) book_segment(fl, f, m, energy, s_stop - start, s_stop, false, 1,
                                    n_booked);
      }
      return M_INTER;
    }
    if constexpr (FLOW) {
      if (seg > 0.0f) book_segment(fl, f, m, energy, seg, start + seg, true, 1, n_booked);
    }
    cum = c_new;
    e_hi = e_lo;
  }
  if (surface_hit) return M_FLOOR;
  float h_lo = face_out(r, __ldg(T.rfront));
  for (int m = 0; m < T.nr; ++m) {
    const float h_hi = face_out(r, __ldg(T.rfront + m + 1));
    const float k = __ldg(T.opacity + m);
    const float seg = fmaxf(h_hi - h_lo, 0.0f);
    const float c_new = cum + k * seg;
    if (c_new > tau_budget) {
      s_stop = h_lo + (tau_budget - cum) / (k == 0.0f ? 1.0f : k);
      cr = m;
      if constexpr (FLOW) {
        if (seg > 0.0f) book_segment(fl, f, m, energy, s_stop - h_lo, s_stop, false, 0,
                                    n_booked);
      }
      return M_INTER;
    }
    if constexpr (FLOW) {
      if (seg > 0.0f) book_segment(fl, f, m, energy, seg, h_lo + seg, true, 0, n_booked);
    }
    cum = c_new;
    h_lo = h_hi;
  }
  return M_EXIT;
}

// re-locate a photon whose radius left its tracked shell by more than sel1
// (geometry.heal_cell, radial part)
__device__ int heal_cell(const Tables& T, const Scal& S, const float* p, int cr) {
  const float x = p[0] * S.ob[0], y = p[1] * S.ob[1], z = p[2] * S.ob[2];
  const float rho = sqrtf(norm2(x, y, z));
  const float r_lo = __ldg(T.rfront + min(max(cr, 0), T.nr - 1));
  const float r_hi = __ldg(T.rfront + min(cr + 1, T.nr));
  if (!(rho < r_lo - S.sel1 || rho > r_hi + S.sel1)) return cr;
  int lo = 0, hi = T.nr + 1;            // count of faces with rfront <= rho
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(T.rfront + mid) <= rho) lo = mid + 1; else hi = mid;
  }
  return min(max(lo - 1, 0), T.nr - 1);
}

// ---------------------------------------------------------- emission ----

// thermal birth (kernel._emit_thermal): cell from the emissivity CDF, a
// point inside the shell, an isotropic or Gordon-biased direction; returns
// the initial Stokes I (bias weight over cell weight)
__device__ float emit_thermal(const Tables& T, const Scal& S, const float* u, bool biased,
                              float* pos, float* dir) {
  const float u_r = fminf(fmaxf(u[1], U_CLIP_LO), U_CLIP_HI);
  const float u_t = fminf(fmaxf(u[2], U_CLIP_LO), U_CLIP_HI);
  const float target = u[0] * __ldg(T.emis_cum + T.nr - 1);
  int lo = 0, hi = T.nr;                 // lower bound: first emis_cum >= target
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(T.emis_cum + mid) < target) lo = mid + 1; else hi = mid;
  }
  const int cr = min(lo, T.nr - 1);
  const float r0 = __ldg(T.rfront + cr), r1 = __ldg(T.rfront + cr + 1);
  const float r = r0 + u_r * (r1 - r0);
  const float cos_t = S.tcos[0] + u_t * (S.tcos[1] - S.tcos[0]);
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const float phi = TWO_PI_F * u[3];
  pos[0] = r * sin_t * cosf(phi) / S.ob[0];
  pos[1] = r * sin_t * sinf(phi) / S.ob[1];
  pos[2] = r * cos_t / S.ob[2];
  return thermal_direction(S, u, biased, pos, dir) / __ldg(T.cell_weight + cr);
}

// ------------------------------------------------------------- kernel ----

#ifdef ARTES_POOL_CLOCKS
// Instrumented build (the library pool_radial_clocks, never the main path):
// each warp adds the clock64 cycles it spends in a phase, the times it
// enters it and the lanes active at entry, in a block's shared memory,
// flushed into g_clocks; row N_PHASE holds the warps' whole time.
enum { P_EMIT, P_FIRST, P_ROULETTE, P_BETA, P_ALPHA, P_ROTATE, P_PEEL, P_MARCH, N_PHASE };
__device__ unsigned long long g_clocks[(N_PHASE + 1) * 3];

__device__ __forceinline__ void clock_add(unsigned long long* sh, int k, long long t0,
                                          unsigned int mask) {
  const long long dt = clock64() - t0;
  if ((int)(threadIdx.x & 31) == __ffs(mask) - 1) atomicAdd(sh + 3 * k, (unsigned long long)dt);
  count_pass(sh + 3 * k + 1, mask);
}
#define CLOCK_BEGIN() (clk_t0 = clock64(), clk_mask = __activemask())
#define CLOCK_END(k) clock_add(clk_sh, k, clk_t0, clk_mask)
#else
#define CLOCK_BEGIN() ((void)0)
#define CLOCK_END(k) ((void)0)
#endif

#ifdef ARTES_F32_LANES
// Build pool_radial_lanes (never the main path): the launch holds exactly
// ARTES_F32_LANES threads, the TPU kernel's pool width, in blocks of
// LANE_THREADS, and each thread adds its scatter peels' Stokes values into
// four float32 sums besides the double ones, as a lane of the TPU kernel adds
// them into its (RR, C) tiles over a launch (pallas_stream.py:1781-1784). At
// its end each thread adds its float sums into g_lane_sums in double (the TPU
// kernel sums its lanes' tiles once, in float32: an error of a few float32
// ulps of the total).
constexpr int LANE_THREADS = 64;
__device__ double g_lane_sums[4];
#endif

// blocks of 256 an SM must hold at once, which bounds the registers ptxas may
// give a thread: for the stellar spectrum 4 (64 registers; of 2, 3 and 4
// blocks, the fastest at 2^20 and 2^24 photons together on an H100), for the
// other instantiations 2 (128 registers)
template <bool THERMAL, bool IMAGE, bool FLOW>
struct MinBlocks {
  static constexpr int value = (THERMAL || IMAGE || FLOW) ? 2 : 4;
};

// instantiations that count lanes where given a buffer: all but the stellar
// image, whose counting code took a register (128, was 127) and 2% of its
// kernel time at 2^24 photons with the buffer null (H100, PERF.md); its
// buffer stays zero, which pool_cuda reads as no count
template <bool THERMAL, bool IMAGE, bool FLOW>
struct CountsLanes {
  static constexpr bool value = THERMAL || !IMAGE || FLOW;
};

// the drain's two stamps after the N_LANE lane counters (pool_cuda.DRAIN_KEYS):
// the earliest and the latest time, %globaltimer in ns, at which a block's
// threads have all left the persistent loop
constexpr int N_DRAIN = 2;

// once every thread of the block has left the loop, its thread 0 stamps the
// time into the launch's counters, where it is given them: the earliest exit
// as its complement under atomicMax, so that the zeroed slot needs no fill,
// and the latest under atomicMax
__device__ __forceinline__ void drain_stamp(unsigned long long* out) {
  if (out == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    atomicMax(out + N_LANE, ~t);
    atomicMax(out + N_LANE + 1, t);
  }
}

// out_i slots: scatter peels, photons capped, photons emitted, birth peels,
// photons abandoned on a Stokes anomaly (error 050), and with FLOW the
// segments that booked flow
constexpr int N_OUT_IR = N_OUT_I + 1;
enum { C_ANOM_R = 4 };

template <bool THERMAL, bool IMAGE, bool FLOW>
__global__ void __launch_bounds__(256, MinBlocks<THERMAL, IMAGE, FLOW>::value)
pool_radial_kernel(Tables T, const float* __restrict__ scal, Image img, uint32_t n_photons,
                   uint32_t key_hi, uint32_t id_lo, int max_scatter, int flags,
                   double* __restrict__ out_d, unsigned long long* __restrict__ out_i,
                   double* flow_g, double* flow_t, double* flow_buf, Records rec,
                   unsigned long long* next_id, unsigned long long* lanes) {
  Flow fl{nullptr, nullptr};
  if constexpr (FLOW) fl = flow_begin(flow_g, flow_t, flow_buf, T.nr);
  constexpr bool COUNTS = CountsLanes<THERMAL, IMAGE, FLOW>::value;
  __shared__ unsigned long long lanes_sh[N_LANE];
  if constexpr (COUNTS) lanes_begin(lanes_sh, lanes);
#ifdef ARTES_POOL_CLOCKS
  __shared__ unsigned long long clk_sh[(N_PHASE + 1) * 3];
  for (int k = threadIdx.x; k < (N_PHASE + 1) * 3; k += blockDim.x) clk_sh[k] = 0ull;
  __syncthreads();
  const long long clk_start = clock64();
  long long clk_t0 = 0;
  unsigned int clk_mask = 0u;
#endif
  const Scal S = load_scal(scal);
  const bool crescent = (flags & F_CRESCENT) != 0;
  const bool biased = (flags & F_BIASED) != 0;
  const bool debug_stokes = (flags & F_DEBUG_STOKES) != 0;
  const bool no_scatter = (flags & F_NO_SCATTER) != 0;

  // I, Q, U, V sums, their squares (spectrum only), flux emitted, flux exit
  double acc[N_OUT_D] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  constexpr int NI = N_OUT_IR + (FLOW ? 1 : 0);
  unsigned long long cnt[NI] = {0ull, 0ull, 0ull, 0ull, 0ull};
#ifdef ARTES_F32_LANES
  float lane[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#endif

  // the lane's photon: alive between its first interaction and its death
  bool alive = false;
  uint32_t pid = 0u, ctr = 0u;
  int cr = 0, n_scat = 0;
  float pos[3], dir[3], st[4];
  float d[6];
  float s_stop = 0.0f;

  // one loop iteration: a new photon's emission, prewalk and first march for
  // a lane without one, then one scattering round for a lane with one,
  // whether it had it before the iteration or has just drawn it
  while (true) {
    if (!alive) {
      // before the break: every lane's last pass counts
      if constexpr (COUNTS) lane_pass(lanes_sh, L_REFILL, lanes);
      CLOCK_BEGIN();
      const unsigned long long i = next_photon(next_id);
      if (i >= n_photons) break;
      pid = id_lo + (uint32_t)i;
      cnt[2] += 1;
      st[0] = 1.0f;
      st[1] = st[2] = st[3] = 0.0f;
      if constexpr (THERMAL) {
        draws6(key_hi, pid, d);
        st[0] = emit_thermal(T, S, d, biased, pos, dir);
        acc[8] += (double)st[0];
        ctr = 6;
        // birth peel: e^-tau / 4 pi on Stokes I (ARTES.f90:4519-4598)
        bool surf;
        const float tau_b = tau_walk(T, S, pos, S.det, surf);
        const int pix = pixel_of<IMAGE>(S, img, pos);
        if (!surf && tau_b < 50.0f && pix >= 0) {
          const float v = expf(-fminf(tau_b, 500.0f)) / FOUR_PI_F * st[0];
          book<IMAGE, 1>(img, pix, &v, acc);
          cnt[3] += 1;
        }
      } else {
        draws(key_hi, pid, 0u, 2, d);
        emit_stellar(S, d, crescent, pos, dir);
        ctr = 2;
      }
      CLOCK_END(P_EMIT);

      // prewalk along the photon's direction + forced first interaction
      CLOCK_BEGIN();
      bool pre_surface;
      const float tau_first = tau_walk(T, S, pos, dir, pre_surface);
      draws(key_hi, pid, ctr, 1, d);
      ctr += 1;
      const bool thin = tau_first < 1.0e-6f;
      int first = M_EXIT;                       // vacuum, no surface: dropped
      if (!(thin && !pre_surface)) {
        const bool forced = !thin && tau_first < 50.0f;
        const float one_m_exp = 1.0f - expf(-tau_first);
        const float tau = forced ? -logf(1.0f - d[0] * one_m_exp) : -logf(1.0f - d[0]);
        if (forced) st[0] *= one_m_exp;
        first = march<FLOW>(T, S, pos, dir, tau, s_stop, cr, st[0], fl, cnt[NI - 1]);
        if (THERMAL && first == M_EXIT) acc[9] += (double)st[0];
      }
      // scattering off: the photon ends at its first interaction
      alive = first == M_INTER && !no_scatter;
      if (alive) {
        for (int k = 0; k < 3; ++k) pos[k] += s_stop * dir[k];
        n_scat = 1;
      }
      CLOCK_END(P_FIRST);
    }
    // outside the refill branch, so that the warp's lanes meet before the
    // round: with the `continue` inside the branch the round is entered from
    // two places, and the warp runs it twice a pass, once for the lanes that
    // have just refilled and once for the rest
    if (!alive) continue;

    // a scattering round (ARTES.f90:786-951); the max_scatter cap bounds them
    if constexpr (COUNTS) lane_pass(lanes_sh, L_ROUND, lanes);
    CLOCK_BEGIN();
    alive = false;
    cr = heal_cell(T, S, pos, cr);
    draws(key_hi, pid, ctr, 5, d);
    ctr += 5;
    if (d[0] < S.fstop) {                           // roulette
      CLOCK_END(P_ROULETTE);
      continue;
    }
    const float alb = __ldg(T.albedo + cr);
    const float gamma = (alb < 1.0f && alb > 0.0f) ? alb / (1.0f - S.fstop) : 1.0f;
    for (int k = 0; k < 4; ++k) st[k] *= gamma;
    if (st[0] <= S.pmin) {
      CLOCK_END(P_ROULETTE);
      continue;
    }
    float contrib[4];
    peel_prep(T, S, dir, cr, st, contrib);
    const int pix = pixel_of<IMAGE>(S, img, pos);
    CLOCK_END(P_ROULETTE);

    CLOCK_BEGIN();
    float beta, c2b, s2b, alpha, alpha_deg;
    sample_beta(T, cr, st, d[1], d[2], beta, c2b, s2b);
    CLOCK_END(P_BETA);
    CLOCK_BEGIN();
    sample_alpha(T, cr, st, c2b, s2b, d[3], alpha, alpha_deg);
    CLOCK_END(P_ALPHA);
    CLOCK_BEGIN();
    float dir_new[3], m[16];
    direction_cosine(alpha, beta, dir, dir_new);
    matrix_at(T.scatter + cr * N_ANGLE * 16, alpha_deg, m);
    polarization_rotation(alpha, c2b, s2b, beta < PI_F ? 1.0f : -1.0f, st, m, dir[2],
                          dir_new[2], false);
    const bool anomalous = debug_stokes && stokes_anomaly(st);
    CLOCK_END(P_ROTATE);
    if (anomalous) {
      // abandoned before its peel and march, recorded at site 4 with the
      // scatterings before this one
      cnt[C_ANOM_R] += 1;
      const int cell[3] = {cr, 0, 0}, face[2] = {0, 0};
      record_error(rec, 50.0f, pid, pos, dir_new, cell, face, st[0], n_scat - 1, 4.0f);
      continue;
    }

    CLOCK_BEGIN();
    bool peel_surface;
    const float tau_peel = tau_walk(T, S, pos, S.det, peel_surface);
    if (!peel_surface && tau_peel < 50.0f && pix >= 0) {
      const float w = expf(-fminf(tau_peel, 500.0f));
      float v[4];
      for (int k = 0; k < 4; ++k) v[k] = contrib[k] * w;
      book<IMAGE, 4>(img, pix, v, acc);
#ifdef ARTES_F32_LANES
      for (int k = 0; k < 4; ++k) lane[k] += v[k];
#endif
      cnt[0] += 1;
    }
    CLOCK_END(P_PEEL);

    CLOCK_BEGIN();
    const float tau = -logf(1.0f - d[4]);
    for (int k = 0; k < 3; ++k) dir[k] = dir_new[k];
    const int out = march<FLOW>(T, S, pos, dir, tau, s_stop, cr, st[0], fl, cnt[NI - 1]);
    if (out == M_INTER) {
      for (int k = 0; k < 3; ++k) pos[k] += s_stop * dir[k];
      if (n_scat >= max_scatter) {
        cnt[1] += 1;
      } else {
        alive = true;
        n_scat += 1;
      }
    } else if (THERMAL && out == M_EXIT) {
      acc[9] += (double)st[0];
    }
    CLOCK_END(P_MARCH);
  }

  drain_stamp(lanes);
  if constexpr (COUNTS) lanes_end(lanes_sh, lanes);
  if constexpr (FLOW) flow_end(flow_g, flow_t, fl, T.nr);
  reduce_block<N_OUT_D, NI>(acc, cnt, out_d, out_i);
#ifdef ARTES_F32_LANES
  for (int k = 0; k < 4; ++k) atomicAdd(g_lane_sums + k, (double)lane[k]);
#endif
#ifdef ARTES_POOL_CLOCKS
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(clk_sh + 3 * N_PHASE, (unsigned long long)(clock64() - clk_start));
    atomicAdd(clk_sh + 3 * N_PHASE + 1, 1ull);
    atomicAdd(clk_sh + 3 * N_PHASE + 2, 32ull);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < (N_PHASE + 1) * 3; k += blockDim.x)
    atomicAdd(g_clocks + k, clk_sh[k]);
#endif
}


// the instantiation of a variant: bit 0 thermal, bit 1 image, bit 2 flow
using KernelFn = void (*)(Tables, const float*, Image, uint32_t, uint32_t, uint32_t, int, int,
                          double*, unsigned long long*, double*, double*, double*, Records,
                          unsigned long long*, unsigned long long*);
KernelFn variant_fn(int variant) {
  switch (variant) {
    case 0: return pool_radial_kernel<false, false, false>;
    case 1: return pool_radial_kernel<true, false, false>;
    case 2: return pool_radial_kernel<false, true, false>;
    case 3: return pool_radial_kernel<true, true, false>;
    case 4: return pool_radial_kernel<false, false, true>;
    case 5: return pool_radial_kernel<true, false, true>;
    case 6: return pool_radial_kernel<false, true, true>;
    case 7: return pool_radial_kernel<true, true, true>;
    default: return nullptr;
  }
}

// the block size and the grid of launch `a` of kernel `fn`: the persistent
// grid, exactly the blocks the card holds at once (fewer for a small
// launch), or with ARTES_F32_LANES the TPU's lanes; 0 blocks when the
// occupancy query fails
int launch_grid(const PoolLaunch& a, KernelFn fn, int& threads) {
#ifdef ARTES_F32_LANES
  threads = LANE_THREADS;
#else
  threads = a.threads;
#endif
  const int resident = resident_blocks(a.variant, fn, threads);
  if (resident < 1) return 0;
#ifdef ARTES_F32_LANES
  return ARTES_F32_LANES / LANE_THREADS;
#else
  return persistent_blocks(resident, a.n_photons, threads);
#endif
}

}  // namespace

// C entry point for ctypes: launches the instantiation of `variant` (bit 0
// thermal, bit 1 image, bit 2 flow) on `stream`, writes its grid into
// a->blocks and returns cudaGetLastError(). Reads the radial tables of
// PoolLaunch, not the 3-D grid's. `flags`: F_CRESCENT, F_BIASED,
// F_DEBUG_STOKES, F_NO_SCATTER of pool_common.cuh. The grid is persistent
// (launch_grid), whose lanes take photon ids id_lo + *next_id from the
// launch's counter.
// out_d: 10 doubles (I, Q, U, V sums and their squares, zero for an image;
// flux emitted; flux exit); out_i: 5 counters (scatter peels, photons capped
// at max_scatter, photons emitted, birth peels, photons abandoned on a Stokes
// anomaly, and with flow a sixth: the segments that booked flow). An image
// (nx * ny pixels) is added into img_sums and img_counts; the flow
// diagnostics into flow_g (nr, 3) and flow_t (nr, 4), through a copy a block
// in flow_buf where that is given (pool_common.cuh::flow_begin;
// artes_pool_radial_blocks gives the launch's blocks), else straight. Stokes
// anomalies leave records (pool_common.cuh::record_error) in rec, their
// count in rec_count. `counters`, where not null, is N_LANE + N_DRAIN zeroed
// counters the launch adds its lane counts into (pool_common.cuh::lane_pass;
// every instantiation but the stellar image, CountsLanes) and stamps its
// drain into (drain_stamp; every instantiation).
extern "C" int artes_pool_radial_launch(PoolLaunch* a, void* stream) {
  const KernelFn fn = variant_fn(a->variant);
  if (fn == nullptr || !threads_ok(a->threads) || a->rec_cap < 0)
    return (int)cudaErrorInvalidValue;
  int threads = 0;
  const int blocks = launch_grid(*a, fn, threads);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  if (a->flow_buf != nullptr && blocks > a->flow_buf_blocks) return (int)cudaErrorInvalidValue;
  a->blocks = blocks;
  fn<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      tables_of(*a), a->scal, image_of(*a), a->n_photons, a->key_hi, a->id_lo, a->max_scatter,
      a->flags, a->out_d, a->out_i, a->flow_g, a->flow_t, a->flow_buf, records_of(*a),
      a->next_id, a->counters);
  return (int)cudaGetLastError();
}

// The blocks artes_pool_radial_launch launches for `a` (launch_grid), 0 when
// the occupancy query fails.
extern "C" int artes_pool_radial_blocks(const PoolLaunch* a) {
  const KernelFn fn = variant_fn(a->variant);
  int threads = 0;
  return fn == nullptr ? 0 : launch_grid(*a, fn, threads);
}

// Table sizes the wrapper must agree with (pool_common.cuh::common_layout):
// out_i's N_OUT_IR counters, N_LANE + N_DRAIN counters.
extern "C" int artes_pool_radial_layout(int* sizes) {
  return common_layout(sizes, N_OUT_IR, N_LANE + N_DRAIN);
}

#ifdef ARTES_POOL_CLOCKS
// The instrumented build's phase clocks since the last reset: (N_PHASE + 1)
// rows of {cycles, entries, active lanes at entry}; returns the rows written.
extern "C" int artes_pool_radial_clocks(unsigned long long* host, int reset) {
  cudaDeviceSynchronize();
  if (cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks)) != cudaSuccess) return -1;
  if (reset) {
    static const unsigned long long zero[(N_PHASE + 1) * 3] = {0ull};
    if (cudaMemcpyToSymbol(g_clocks, zero, sizeof(g_clocks)) != cudaSuccess) return -1;
  }
  return N_PHASE + 1;
}
#endif

#ifdef ARTES_F32_LANES
// The lanes' float32 sums of the scatter peels' I, Q, U, V since the last
// reset (after the card finishes its work); returns 4.
extern "C" int artes_pool_radial_lane_sums(double* host, int reset) {
  cudaDeviceSynchronize();
  if (cudaMemcpyFromSymbol(host, g_lane_sums, sizeof(g_lane_sums)) != cudaSuccess) return -1;
  if (reset) {
    static const double zero[4] = {0.0, 0.0, 0.0, 0.0};
    if (cudaMemcpyToSymbol(g_lane_sums, zero, sizeof(g_lane_sums)) != cudaSuccess) return -1;
  }
  return 4;
}
#endif
