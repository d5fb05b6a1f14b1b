#include <algorithm>
#include <initializer_list>
// computepart: Mie/DHS scattering solver (native ComputePart equivalent).
//
// Drop-in replacement for the prebuilt binary the reference ships
// (bin/ComputePartMac, driven by python/opacityMie.py:92-106): reads
// ``mie.in`` (nr, nf, refractive-index file, percentage/density/amin/amax/
// apow/fmax) plus a wavelength list, and writes ``particle.fits`` with the
// per-gram extinction/absorption/scattering opacities and the 6-element
// scattering matrix (F11,F12,F22,F33,F34,F44) on 180 one-degree bins.
//
// Physics, implemented from the standard formulations (not from any
// existing code):
//  * homogeneous spheres: Bohren & Huffman Mie series with downward
//    logarithmic-derivative recurrence,
//  * distribution of hollow spheres (DHS, Min et al. 2005): vacuum-core
//    coated spheres averaged uniformly over the core volume fraction
//    f in [0, fmax], at equal material volume,
//  * size distributions: power law n(a) ~ a^-apow on [amin, amax], or the
//    Hansen gamma distribution when (r_eff, v_eff) are given on the command
//    line (overruling amin/amax/apow, as in opacityMie.py:21-22,101-105).
//
// Build: g++ -O2 -std=c++17 -o computepart mie.cc

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

using cdouble = std::complex<double>;
static const double PI = 3.14159265358979323846;
static const int NANG = 180;  // one-degree bins

struct MieResult {
  double qext = 0.0, qsca = 0.0;
  // amplitude functions at the NANG+1 bin-edge angles (0..180 deg)
  std::vector<cdouble> s1, s2;
  MieResult() : s1(NANG + 1), s2(NANG + 1) {}
};

static int terms_needed(double x) {
  int n = static_cast<int>(x + 4.0 * std::cbrt(x) + 2.0);
  return n < 3 ? 3 : n;
}

// Homogeneous-sphere Mie coefficients a_n, b_n (Bohren & Huffman ch. 4).
static void mie_coefficients(double x, cdouble m, int nmax,
                             std::vector<cdouble>& a, std::vector<cdouble>& b) {
  const cdouble mx = m * x;
  const int nmx = static_cast<int>(std::max(static_cast<double>(nmax), std::abs(mx)) + 16.0);
  // downward recurrence for the logarithmic derivative D_n(mx)
  std::vector<cdouble> D(nmx + 1, cdouble(0.0, 0.0));
  for (int n = nmx; n >= 1; --n) {
    const cdouble rn = cdouble(n, 0.0) / mx;
    D[n - 1] = rn - 1.0 / (D[n] + rn);
  }
  // upward recurrence for Riccati-Bessel psi (regular) and chi (irregular)
  double psi0 = std::cos(x), psi1 = std::sin(x);
  double chi0 = -std::sin(x), chi1 = std::cos(x);
  cdouble xi1(psi1, -chi1);
  a.assign(nmax + 1, cdouble());
  b.assign(nmax + 1, cdouble());
  for (int n = 1; n <= nmax; ++n) {
    const double psi = (2.0 * n - 1.0) * psi1 / x - psi0;
    const double chi = (2.0 * n - 1.0) * chi1 / x - chi0;
    const cdouble xi(psi, -chi);
    const cdouble da = D[n] / m + cdouble(n, 0.0) / x;
    const cdouble db = D[n] * m + cdouble(n, 0.0) / x;
    a[n] = (da * psi - psi1) / (da * xi - xi1);
    b[n] = (db * psi - psi1) / (db * xi - xi1);
    psi0 = psi1; psi1 = psi;
    chi0 = chi1; chi1 = chi;
    xi1 = xi;
  }
}

// Coated sphere with vacuum core (hollow sphere): Bohren & Huffman ch. 8
// boundary conditions specialised to m_core = 1, written in the
// log-derivative form. x = core size parameter, y = outer size parameter,
// m = shell refractive index.
//
//   A_n = psi_n(m x) [ (m2/m1) D_n(m1 x) - D_n(m2 x) ]
//         / [ (m2/m1) D_n(m1 x) chi_n(m2 x) - chi'_n(m2 x) ]
//   B_n = psi_n(m x) [ (m1/m2) D_n(m1 x) - D_n(m2 x) ]  (roles of m swapped)
//   Dt_n = [ psi'_n(m2 y) - A_n chi'_n(m2 y) ] / [ psi_n(m2 y) - A_n chi_n(m2 y) ]
//   a_n = [ (Dt_n/m2 + n/y) psi_n(y) - psi_{n-1}(y) ]
//         / [ (Dt_n/m2 + n/y) xi_n(y) - xi_{n-1}(y) ]      (Gt_n, *m2 for b_n)
//
// chi at complex argument grows exponentially for absorbing shells; this is
// the standard BHCOAT stability limit and is adequate for the k <~ 1 dust
// species shipped with the reference data.
static void hollow_coefficients(double x, double y, cdouble m, int nmax,
                                std::vector<cdouble>& a, std::vector<cdouble>& b) {
  const cdouble m1(1.0, 0.0);  // vacuum core
  const cdouble m2 = m;        // shell
  const cdouble x1 = m1 * x, x2 = m2 * x, y2 = m2 * y;
  const int nmx = static_cast<int>(
      std::max({static_cast<double>(nmax), std::abs(x2), std::abs(y2)}) + 16.0);

  auto logderiv = [&](cdouble z) {
    std::vector<cdouble> D(nmx + 1, cdouble());
    for (int n = nmx; n >= 1; --n) {
      const cdouble rn = cdouble(n, 0.0) / z;
      D[n - 1] = rn - 1.0 / (D[n] + rn);
    }
    return D;
  };
  const std::vector<cdouble> D1x = logderiv(x1);
  const std::vector<cdouble> D2x = logderiv(x2);
  const std::vector<cdouble> D2y = logderiv(y2);

  // Riccati-Bessel psi, chi (upward; index 0 = order 0)
  auto riccati = [&](cdouble z, std::vector<cdouble>& psi, std::vector<cdouble>& chi) {
    psi.assign(nmax + 1, cdouble());
    chi.assign(nmax + 1, cdouble());
    psi[0] = std::sin(z);
    chi[0] = std::cos(z);
    cdouble pm = std::cos(z), cm = -std::sin(z);  // order -1
    for (int n = 1; n <= nmax; ++n) {
      psi[n] = (2.0 * n - 1.0) * psi[n - 1] / z - pm;
      chi[n] = (2.0 * n - 1.0) * chi[n - 1] / z - cm;
      pm = psi[n - 1];
      cm = chi[n - 1];
    }
  };
  std::vector<cdouble> psi2x, chi2x, psi2y, chi2y;
  riccati(x2, psi2x, chi2x);
  riccati(y2, psi2y, chi2y);
  std::vector<cdouble> psiy, chiy;
  riccati(cdouble(y, 0.0), psiy, chiy);

  a.assign(nmax + 1, cdouble());
  b.assign(nmax + 1, cdouble());
  for (int n = 1; n <= nmax; ++n) {
    // chi'/psi' from the identity f'_n(z) = f_{n-1}(z) - (n/z) f_n(z)
    const cdouble chi2x_d = chi2x[n - 1] - cdouble(n, 0.0) / x2 * chi2x[n];
    const cdouble chi2y_d = chi2y[n - 1] - cdouble(n, 0.0) / y2 * chi2y[n];
    const cdouble psi2y_d = psi2y[n] * D2y[n];

    const cdouble An = psi2x[n] * ((m2 / m1) * D1x[n] - D2x[n]) /
                       ((m2 / m1) * D1x[n] * chi2x[n] - chi2x_d);
    const cdouble Bn = psi2x[n] * ((m1 / m2) * D1x[n] - D2x[n]) /
                       ((m1 / m2) * D1x[n] * chi2x[n] - chi2x_d);

    const cdouble Dt = (psi2y_d - An * chi2y_d) / (psi2y[n] - An * chi2y[n]);
    const cdouble Gt = (psi2y_d - Bn * chi2y_d) / (psi2y[n] - Bn * chi2y[n]);

    const cdouble xiy(psiy[n].real(), -chiy[n].real());
    const cdouble xiy_prev(psiy[n - 1].real(), -chiy[n - 1].real());
    const cdouble fa = Dt / m2 + cdouble(n, 0.0) / y;
    const cdouble fb = Gt * m2 + cdouble(n, 0.0) / y;
    a[n] = (fa * psiy[n] - psiy[n - 1]) / (fa * xiy - xiy_prev);
    b[n] = (fb * psiy[n] - psiy[n - 1]) / (fb * xiy - xiy_prev);
  }
}

// Amplitude functions + efficiencies from the coefficient sets.
static MieResult amplitudes(double x, const std::vector<cdouble>& a,
                            const std::vector<cdouble>& b) {
  const int nmax = static_cast<int>(a.size()) - 1;
  MieResult r;
  for (int n = 1; n <= nmax; ++n) {
    const double f = 2.0 * n + 1.0;
    r.qext += f * (a[n].real() + b[n].real());
    r.qsca += f * (std::norm(a[n]) + std::norm(b[n]));
  }
  r.qext *= 2.0 / (x * x);
  r.qsca *= 2.0 / (x * x);

  for (int j = 0; j <= NANG; ++j) {
    const double mu = std::cos(j * PI / 180.0);
    double pi_prev = 0.0, pi_cur = 1.0;  // pi_0 = 0, pi_1 = 1
    cdouble s1(0.0, 0.0), s2(0.0, 0.0);
    for (int n = 1; n <= nmax; ++n) {
      const double tau = n * mu * pi_cur - (n + 1.0) * pi_prev;
      const double f = (2.0 * n + 1.0) / (n * (n + 1.0));
      s1 += f * (a[n] * pi_cur + b[n] * tau);
      s2 += f * (a[n] * tau + b[n] * pi_cur);
      const double pi_next = ((2.0 * n + 1.0) * mu * pi_cur - (n + 1.0) * pi_prev) / n;
      pi_prev = pi_cur;
      pi_cur = pi_next;
    }
    r.s1[j] = s1;
    r.s2[j] = s2;
  }
  return r;
}

static MieResult mie_sphere(double x, cdouble m) {
  std::vector<cdouble> a, b;
  mie_coefficients(x, m, terms_needed(x), a, b);
  return amplitudes(x, a, b);
}

static MieResult hollow_sphere(double fcore, double x_outer, cdouble m) {
  if (fcore <= 1e-8) return mie_sphere(x_outer, m);
  const double x_core = x_outer * std::cbrt(fcore);
  std::vector<cdouble> a, b;
  hollow_coefficients(x_core, x_outer, m, terms_needed(x_outer), a, b);
  return amplitudes(x_outer, a, b);
}

// ---------------------------------------------------------------------------
// minimal FITS image writer (big-endian float64, primary + IMAGE extension)
// ---------------------------------------------------------------------------

static void fits_card(std::string& h, const std::string& key, const std::string& val,
                      bool quoted = false) {
  char buf[81];
  if (quoted)
    std::snprintf(buf, sizeof buf, "%-8s= '%-8s'", key.c_str(), val.c_str());
  else
    std::snprintf(buf, sizeof buf, "%-8s= %20s", key.c_str(), val.c_str());
  std::string card(buf);
  card.resize(80, ' ');
  h += card;
}

static void fits_pad(std::string& s, char fill) {
  while (s.size() % 2880) s.push_back(fill);
}

static void write_hdu(std::ofstream& out, const std::vector<long>& shape,
                      const std::vector<double>& data, bool primary,
                      const char* extname) {
  std::string h;
  if (primary) fits_card(h, "SIMPLE", "T");
  else fits_card(h, "XTENSION", "IMAGE", true);
  fits_card(h, "BITPIX", "-64");
  fits_card(h, "NAXIS", std::to_string(shape.size()));
  for (size_t i = 0; i < shape.size(); ++i)
    fits_card(h, "NAXIS" + std::to_string(i + 1), std::to_string(shape[i]));
  if (primary) fits_card(h, "EXTEND", "T");
  else { fits_card(h, "PCOUNT", "0"); fits_card(h, "GCOUNT", "1"); }
  if (extname) fits_card(h, "EXTNAME", extname, true);
  { std::string e = "END"; e.resize(80, ' '); h += e; }
  fits_pad(h, ' ');
  out.write(h.data(), h.size());

  std::string d;
  d.reserve(data.size() * 8);
  for (double v : data) {
    uint64_t bits;
    std::memcpy(&bits, &v, 8);
    for (int k = 7; k >= 0; --k) d.push_back(static_cast<char>((bits >> (8 * k)) & 0xff));
  }
  fits_pad(d, '\0');
  out.write(d.data(), d.size());
}

// ---------------------------------------------------------------------------

struct Config {
  int nr = 100, nf = 1;
  std::string ri_file;
  double percentage = 100.0, density = 1.0;
  double amin = 0.1, amax = 1.0, apow = 3.5, fmax = 0.0;
  double r_eff = -1.0, v_eff = -1.0;
};

static std::string strip_quotes(std::string s) {
  std::stringstream ss(s);
  std::string tok;
  ss >> tok;
  if (!tok.empty() && (tok.front() == '\'' || tok.front() == '"')) {
    tok = tok.substr(1, tok.rfind(tok.front()) - 1);
  }
  return tok;
}

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: computepart mie.in wavelength.dat [r_eff v_eff]\n");
    return 1;
  }
  Config cfg;
  {
    std::ifstream in(argv[1]);
    if (!in) { std::fprintf(stderr, "cannot open %s\n", argv[1]); return 1; }
    std::string line;
    std::getline(in, line); cfg.nr = std::stoi(line);
    std::getline(in, line); cfg.nf = std::stoi(line);
    std::getline(in, line); cfg.ri_file = strip_quotes(line);
    std::getline(in, line);
    std::stringstream ss(line);
    ss >> cfg.percentage >> cfg.density >> cfg.amin >> cfg.amax >> cfg.apow >> cfg.fmax;
  }
  if (argc >= 5) { cfg.r_eff = std::atof(argv[3]); cfg.v_eff = std::atof(argv[4]); }

  std::vector<double> wavelengths;
  {
    std::ifstream in(argv[2]);
    double w;
    while (in >> w) wavelengths.push_back(w);
  }
  // refractive index table: wavelength [micron], n, k
  std::vector<double> ri_wl, ri_n, ri_k;
  {
    std::ifstream in(cfg.ri_file);
    if (!in) { std::fprintf(stderr, "cannot open %s\n", cfg.ri_file.c_str()); return 1; }
    std::string line;
    while (std::getline(in, line)) {
      if (line.empty() || line[0] == '#') continue;
      std::stringstream ss(line);
      double w, n, k;
      if (ss >> w >> n >> k) { ri_wl.push_back(w); ri_n.push_back(n); ri_k.push_back(k); }
    }
  }
  auto ri_at = [&](double wl) {
    if (wl <= ri_wl.front()) return cdouble(ri_n.front(), ri_k.front());
    if (wl >= ri_wl.back()) return cdouble(ri_n.back(), ri_k.back());
    size_t i = 1;
    while (i < ri_wl.size() && ri_wl[i] < wl) ++i;
    const double t = (wl - ri_wl[i - 1]) / (ri_wl[i] - ri_wl[i - 1]);
    return cdouble(ri_n[i - 1] + t * (ri_n[i] - ri_n[i - 1]),
                   ri_k[i - 1] + t * (ri_k[i] - ri_k[i - 1]));
  };

  // size grid + distribution weights
  std::vector<double> radius(cfg.nr), weight(cfg.nr);
  const bool hansen = cfg.r_eff > 0.0;
  double amin = cfg.amin, amax = cfg.amax;
  if (hansen) {
    // Hansen gamma distribution n(a) ~ a^((1-3v)/v) exp(-a/(r_eff v))
    amin = std::max(1e-3 * cfg.r_eff, cfg.r_eff * (1.0 - 5.0 * std::sqrt(cfg.v_eff)));
    if (amin <= 0) amin = 1e-3 * cfg.r_eff;
    amax = cfg.r_eff * (1.0 + 8.0 * std::sqrt(cfg.v_eff));
  }
  for (int i = 0; i < cfg.nr; ++i) {
    const double t = cfg.nr == 1 ? 0.5 : static_cast<double>(i) / (cfg.nr - 1);
    radius[i] = amin * std::pow(amax / amin, t);
    double w;
    if (hansen) {
      const double p = (1.0 - 3.0 * cfg.v_eff) / cfg.v_eff;
      w = std::pow(radius[i], p) * std::exp(-radius[i] / (cfg.r_eff * cfg.v_eff));
    } else {
      w = std::pow(radius[i], -cfg.apow);
    }
    weight[i] = w * radius[i];  // log-spaced grid: da = a dln(a)
  }

  // DHS volume fractions (uniform average over [0, fmax])
  std::vector<double> fracs;
  if (cfg.fmax <= 1e-8 || cfg.nf <= 1) fracs.push_back(0.0);
  else for (int i = 0; i < cfg.nf; ++i) fracs.push_back(cfg.fmax * (i + 0.5) / cfg.nf);

  const size_t nl = wavelengths.size();
  std::vector<double> opacity(4 * nl, 0.0);
  std::vector<double> scatter(static_cast<size_t>(NANG) * 6 * nl, 0.0);

  for (size_t il = 0; il < nl; ++il) {
    const double wl = wavelengths[il];
    const cdouble m = ri_at(wl);
    double csca_sum = 0.0, cext_sum = 0.0, mass_sum = 0.0;
    std::vector<double> F(static_cast<size_t>(NANG + 1) * 4, 0.0);  // F11,F12,F33,F34 edges
    for (int i = 0; i < cfg.nr; ++i) {
      const double a_um = radius[i];
      for (double f : fracs) {
        const double r_outer = a_um / std::cbrt(1.0 - f);
        const double x = 2.0 * PI * r_outer / wl;
        if (x > 2.0e4) continue;  // series impractical; negligible weight
        MieResult mr = hollow_sphere(f, x, m);
        const double geo = PI * r_outer * r_outer;  // [um^2]
        const double wgt = weight[i] / fracs.size();
        cext_sum += mr.qext * geo * wgt;
        csca_sum += mr.qsca * geo * wgt;
        const double k2 = std::pow(2.0 * PI / wl, 2.0);
        for (int j = 0; j <= NANG; ++j) {
          const double i1 = std::norm(mr.s1[j]);
          const double i2 = std::norm(mr.s2[j]);
          const cdouble s21 = mr.s2[j] * std::conj(mr.s1[j]);
          F[j * 4 + 0] += wgt / k2 * 0.5 * (i1 + i2);
          F[j * 4 + 1] += wgt / k2 * 0.5 * (i2 - i1);
          F[j * 4 + 2] += wgt / k2 * s21.real();
          F[j * 4 + 3] += wgt / k2 * s21.imag();
        }
      }
      // particle mass in [g]: density [g cm-3] * volume of MATERIAL
      const double vol_cm3 = 4.0 / 3.0 * PI * std::pow(a_um * 1e-4, 3.0);
      mass_sum += cfg.density * vol_cm3 * weight[i];
    }
    // cross sections in um^2 -> cm^2
    const double cext_cm2 = cext_sum * 1e-8;
    const double csca_cm2 = csca_sum * 1e-8;
    opacity[0 * nl + il] = wl;
    opacity[1 * nl + il] = cext_cm2 / mass_sum;             // extinction [cm2 g-1]
    opacity[2 * nl + il] = (cext_cm2 - csca_cm2) / mass_sum;  // absorption
    opacity[3 * nl + il] = csca_cm2 / mass_sum;             // scattering
    // bin-average edge values into the 180 one-degree bins
    for (int j = 0; j < NANG; ++j) {
      const double f11 = 0.5 * (F[j * 4 + 0] + F[(j + 1) * 4 + 0]);
      const double f12 = 0.5 * (F[j * 4 + 1] + F[(j + 1) * 4 + 1]);
      const double f33 = 0.5 * (F[j * 4 + 2] + F[(j + 1) * 4 + 2]);
      const double f34 = 0.5 * (F[j * 4 + 3] + F[(j + 1) * 4 + 3]);
      // layout (180, 6, nl) with NAXIS1 = nl: flat = (j*6 + e)*nl + il
      scatter[(j * 6 + 0) * nl + il] = f11;
      scatter[(j * 6 + 1) * nl + il] = f12;
      scatter[(j * 6 + 2) * nl + il] = f11;  // F22 = F11 for spheres
      scatter[(j * 6 + 3) * nl + il] = f33;
      scatter[(j * 6 + 4) * nl + il] = f34;
      scatter[(j * 6 + 5) * nl + il] = f33;  // F44 = F33 for spheres
    }
    std::fprintf(stderr, "\rlambda %zu/%zu: %.3f um  Qext-avg kappa=%.4e cm2/g",
                 il + 1, nl, wl, opacity[1 * nl + il]);
  }
  std::fprintf(stderr, "\n");

  std::ofstream out("particle.fits", std::ios::binary);
  write_hdu(out, {static_cast<long>(nl), 4}, opacity, true, "opacity");
  write_hdu(out, {static_cast<long>(nl), 6, NANG}, scatter, false, "scattermatrix");
  return 0;
}
