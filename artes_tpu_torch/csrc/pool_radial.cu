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
//     pallas_stream.py:1626-1665, :1970-1988): double atomics into the
//     block's shared memory, 7 nr sums flushed once a block, or into the
//     global result where the shells do not fit there.
// Crescent sampling and the off-axis stellar beam are runtime scalars.
//
// Design. One thread per photon, grid-stride over the photon ids: a thread
// runs its photon from emission to death, then takes the next id. Photon
// streams are keyed by (seed, photon id, draw site), so no lane pool, refill
// ranking or stage machine is needed, and the per-photon draw-site schedule
// is the one of the JAX and plain versions:
//   emission: sites 0, 1 (stellar) or 0-5 (thermal, then the birth peel,
//     which draws nothing);
//   prewalk fused with the forced first interaction: one site;
//   every scattering round: 5 sites (roulette, azimuth x2, zenith, tau).
// The closed-form shell-chord walks (artes_tpu/transport/radial.py) need no
// per-face arrays: face roots are computed on the fly in path order.
// Tables live in global memory and are read per cell (__ldg). Per-thread
// tallies are double (Stokes sums and squares, fluxes) and 64-bit integers
// (counts), reduced per block in shared memory and added with one atomicAdd
// per tally.
//
// The device code it shares with pool_grid3d.cu (draws, chords, Stokes
// algebra, samplers, peel, booking, reduction) is in pool_common.cuh.
//
// What bounds it on an H100: arithmetic and divergence, not memory. Photons
// of one warp live for different numbers of rounds (geometric roulette
// lifetimes) and walk shells of different counts, so warps run partly
// idle; each thread holds a 4x4 matrix and the Stokes state in registers.
// The image splat adds ten global atomics per accepted peel, which contend
// on the lit pixels. This version keeps the loop simple; warp-level refill,
// shared-memory tables, a privatised shared-memory detector and occupancy
// tuning are later work.

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
  flow_add_g(fl, m, (f.pd + t) * inv_r * w, tnum * (inv_rho * inv_r) * w, f.lz * inv_rho * w);
  if (crossed) flow_add_t(fl, m, column, energy);
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
  const float rho = sqrtf(x * x + y * y + z * z);
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

template <bool THERMAL, bool IMAGE, bool FLOW>
__global__ void __launch_bounds__(256)
pool_radial_kernel(Tables T, const float* __restrict__ scal, Image img, uint32_t n_photons,
                   uint32_t key_hi, uint32_t id_lo, int max_scatter, int flags,
                   double* __restrict__ out_d, unsigned long long* __restrict__ out_i,
                   double* flow_g, double* flow_t, int flow_shared) {
  extern __shared__ double flow_sh[];
  Flow fl{nullptr, nullptr};
  if constexpr (FLOW) fl = flow_begin(flow_g, flow_t, flow_sh, T.nr, flow_shared != 0);
  const Scal S = load_scal(scal);
  const bool crescent = (flags & F_CRESCENT) != 0;
  const bool biased = (flags & F_BIASED) != 0;

  // I, Q, U, V sums, their squares (spectrum only), flux emitted, flux exit
  double acc[N_OUT_D] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  // scatter peels, photons capped, photons emitted, birth peels; with FLOW
  // also the segments that booked flow
  constexpr int NI = N_OUT_I + (FLOW ? 1 : 0);
  unsigned long long cnt[NI] = {0ull, 0ull, 0ull, 0ull};

  // 64-bit index: a 32-bit one would wrap past n_photons near 2^32
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_photons; i += stride) {
    const uint32_t pid = id_lo + (uint32_t)i;
    cnt[2] += 1;
    float d[6];
    float pos[3], dir[3];
    float st[4] = {1.0f, 0.0f, 0.0f, 0.0f};
    uint32_t ctr;

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

    // prewalk along the photon's direction + forced first interaction
    bool pre_surface;
    const float tau_first = tau_walk(T, S, pos, dir, pre_surface);
    draws(key_hi, pid, ctr, 1, d);
    ctr += 1;
    const bool thin = tau_first < 1.0e-6f;
    if (thin && !pre_surface) continue;       // vacuum, no surface
    const bool forced = !thin && tau_first < 50.0f;
    const float one_m_exp = 1.0f - expf(-tau_first);
    float tau = forced ? -logf(1.0f - d[0] * one_m_exp) : -logf(1.0f - d[0]);
    if (forced) st[0] *= one_m_exp;
    float s_stop;
    int cr;
    const int first = march<FLOW>(T, S, pos, dir, tau, s_stop, cr, st[0], fl, cnt[NI - 1]);
    if (first != M_INTER) {
      if (THERMAL && first == M_EXIT) acc[9] += (double)st[0];
      continue;
    }
    for (int k = 0; k < 3; ++k) pos[k] += s_stop * dir[k];

    // scattering rounds (ARTES.f90:786-951); the max_scatter cap bounds them
    for (int n_scat = 1;; ++n_scat) {
      cr = heal_cell(T, S, pos, cr);
      draws(key_hi, pid, ctr, 5, d);
      ctr += 5;
      if (d[0] < S.fstop) break;                     // roulette
      const float alb = __ldg(T.albedo + cr);
      const float gamma = (alb < 1.0f && alb > 0.0f) ? alb / (1.0f - S.fstop) : 1.0f;
      for (int k = 0; k < 4; ++k) st[k] *= gamma;
      if (st[0] <= S.pmin) break;

      float contrib[4];
      peel_prep(T, S, dir, cr, st, contrib);
      const int pix = pixel_of<IMAGE>(S, img, pos);
      float beta, c2b, s2b, alpha, alpha_deg;
      sample_beta(T, cr, st, d[1], d[2], beta, c2b, s2b);
      sample_alpha(T, cr, st, c2b, s2b, d[3], alpha, alpha_deg);
      float dir_new[3], m[16];
      direction_cosine(alpha, beta, dir, dir_new);
      matrix_at(T.scatter + cr * N_ANGLE * 16, alpha_deg, m);
      polarization_rotation(alpha, c2b, s2b, beta < PI_F ? 1.0f : -1.0f, st, m, dir[2],
                            dir_new[2], false);

      bool peel_surface;
      const float tau_peel = tau_walk(T, S, pos, S.det, peel_surface);
      if (!peel_surface && tau_peel < 50.0f && pix >= 0) {
        const float w = expf(-fminf(tau_peel, 500.0f));
        float v[4];
        for (int k = 0; k < 4; ++k) v[k] = contrib[k] * w;
        book<IMAGE, 4>(img, pix, v, acc);
        cnt[0] += 1;
      }

      tau = -logf(1.0f - d[4]);
      for (int k = 0; k < 3; ++k) dir[k] = dir_new[k];
      const int out = march<FLOW>(T, S, pos, dir, tau, s_stop, cr, st[0], fl, cnt[NI - 1]);
      if (out != M_INTER) {
        if (THERMAL && out == M_EXIT) acc[9] += (double)st[0];
        break;
      }
      for (int k = 0; k < 3; ++k) pos[k] += s_stop * dir[k];
      if (n_scat >= max_scatter) {
        cnt[1] += 1;
        break;
      }
    }
  }

  if constexpr (FLOW) flow_end(flow_g, flow_t, flow_sh, T.nr, flow_shared != 0);
  reduce_block<N_OUT_D, NI>(acc, cnt, out_d, out_i);
}


// the instantiation of a variant: bit 0 thermal, bit 1 image, bit 2 flow
using KernelFn = void (*)(Tables, const float*, Image, uint32_t, uint32_t, uint32_t, int, int,
                          double*, unsigned long long*, double*, double*, int);
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

}  // namespace

// C entry point for ctypes: launches the instantiation of `variant` (bit 0
// thermal, bit 1 image, bit 2 flow) on `stream` and returns
// cudaGetLastError().
// out_d: 10 doubles (I, Q, U, V sums and their squares, zero for an image;
// flux emitted; flux exit); out_i: 4 counters (scatter peels, photons capped
// at max_scatter, photons emitted, birth peels, and with flow a fifth: the
// segments that booked flow). An image (nx * ny pixels)
// is added into img_sums (npix, 8) and img_counts (npix, 2); the flow
// diagnostics into flow_g (nr, 3) and flow_t (nr, 4), summed per block in
// `flow_shared_bytes` of shared memory when that is not 0.
extern "C" int artes_pool_radial_launch(
    const float* rfront, const float* opacity, const float* albedo, const float* scatter,
    const float* prefix, const float* p_int, const float* consts, const float* scal,
    const float* emis_cum, const float* cell_weight, int nr, unsigned int n_photons,
    unsigned int key_hi, unsigned int id_lo, int max_scatter, int variant, int flags, int nx,
    int ny, double* img_sums, unsigned long long* img_counts, double* out_d,
    unsigned long long* out_i, double* flow_g, double* flow_t, int flow_shared_bytes,
    int blocks, int threads, void* stream) {
  Tables T{rfront, opacity, albedo, scatter, prefix, p_int, consts, emis_cum, cell_weight, nr};
  Image img{img_sums, img_counts, nx, ny};
  const KernelFn fn = variant_fn(variant);
  if (fn == nullptr || threads > 256 || threads % 32 != 0 || blocks < 1 ||
      flow_shared_bytes < 0 || flow_shared_bytes > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  fn<<<blocks, threads, flow_shared_bytes, (cudaStream_t)stream>>>(
      T, scal, img, n_photons, key_hi, id_lo, max_scatter, flags, out_d, out_i, flow_g, flow_t,
      flow_shared_bytes);
  return (int)cudaGetLastError();
}

// Table sizes the wrapper must agree with: {N_SCAL, N_OUT_D, N_OUT_I, N_IMG_D, N_IMG_I}.
extern "C" int artes_pool_radial_layout(int* sizes) {
  sizes[0] = N_SCAL;
  sizes[1] = N_OUT_D;
  sizes[2] = N_OUT_I;
  sizes[3] = N_IMG_D;
  sizes[4] = N_IMG_I;
  return 0;
}
