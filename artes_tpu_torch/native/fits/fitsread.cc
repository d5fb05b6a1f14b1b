// libartesfits: native FITS image-HDU reader (cfitsio-equivalent subset).
//
// The reference links NASA's cfitsio for all engine-side I/O
// (Makefile:22-26; ftopen/ftgpvd calls ARTES.f90:2067-2201). This library is
// the native loader for the same artifacts: primary + IMAGE extensions of
// BITPIX 8/16/32/64/-32/-64, returned as host-endian float64. The Python
// module artes_tpu_torch/io/fitsio.py is the format authority; this is the
// bulk reader (one pass, no per-card Python work), loaded via ctypes
// (``read_fits_native``).
//
// C ABI:
//   int artes_fits_scan(const char* path, long* n_hdus);
//   int artes_fits_hdu_info(const char* path, int index,
//                           long* ndim, long shape[8], char name[72]);
//   int artes_fits_read(const char* path, int index, double* out, long n);
// All return 0 on success, negative error codes otherwise: -1 the file
// does not open, -2 a truncated header, -3 no such HDU, -4 a wrong element
// count, -5 truncated data.
//
// Build: artes_tpu_torch/_build.py (``build_host("artesfits")``: g++ -O2
// -std=c++17 -Wall -fPIC -shared), at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr long kBlock = 2880;
constexpr long kCard = 80;

struct Hdu {
  long data_offset = 0;
  int bitpix = 8;
  long ndim = 0;
  long shape[8] = {0};  // FITS order: shape[0] = NAXIS1 (fastest)
  char name[72] = {0};
  long n_elems() const {
    if (ndim == 0) return 0;
    long n = 1;
    for (long i = 0; i < ndim; ++i) n *= shape[i];
    return n;
  }
  long data_bytes() const {
    const int itemsize = bitpix < 0 ? (-bitpix / 8) : (bitpix / 8);
    return n_elems() * itemsize;
  }
};

long parse_long(const char* card) {
  // value field: columns 10..80
  return std::strtol(card + 10, nullptr, 10);
}

void parse_string(const char* card, char* out, size_t cap) {
  const char* q1 = std::strchr(card + 10, '\'');
  if (!q1) { out[0] = 0; return; }
  const char* q2 = std::strchr(q1 + 1, '\'');
  if (!q2) { out[0] = 0; return; }
  size_t n = std::min(static_cast<size_t>(q2 - q1 - 1), cap - 1);
  std::memcpy(out, q1 + 1, n);
  out[n] = 0;
  // strip trailing blanks
  while (n > 0 && out[n - 1] == ' ') out[--n] = 0;
}

int scan_file(const char* path, std::vector<Hdu>& hdus) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return -1;
  std::fseek(fh, 0, SEEK_END);
  const long fsize = std::ftell(fh);
  long pos = 0;
  char block[kBlock];
  while (pos < fsize) {
    Hdu hdu;
    bool done = false;
    long hpos = pos;
    while (!done) {
      std::fseek(fh, hpos, SEEK_SET);
      if (std::fread(block, 1, kBlock, fh) != static_cast<size_t>(kBlock)) {
        std::fclose(fh);
        return -2;  // truncated header
      }
      hpos += kBlock;
      for (long c = 0; c < kBlock; c += kCard) {
        const char* card = block + c;
        if (std::strncmp(card, "END", 3) == 0 &&
            (card[3] == ' ' || card[3] == 0)) { done = true; break; }
        if (std::strncmp(card, "BITPIX  ", 8) == 0) hdu.bitpix = static_cast<int>(parse_long(card));
        else if (std::strncmp(card, "NAXIS   ", 8) == 0) hdu.ndim = parse_long(card);
        else if (std::strncmp(card, "NAXIS", 5) == 0 && card[5] >= '1' && card[5] <= '8'
                 && card[6] == ' ') hdu.shape[card[5] - '1'] = parse_long(card);
        else if (std::strncmp(card, "EXTNAME ", 8) == 0) parse_string(card, hdu.name, sizeof hdu.name);
      }
    }
    hdu.data_offset = hpos;
    long db = hdu.data_bytes();
    if (db % kBlock) db += kBlock - db % kBlock;
    pos = hpos + db;
    hdus.push_back(hdu);
  }
  std::fclose(fh);
  return 0;
}

double convert(const unsigned char* p, int bitpix) {
  switch (bitpix) {
    case 8: return static_cast<double>(*p);
    case 16: {
      int16_t v = static_cast<int16_t>((p[0] << 8) | p[1]);
      return static_cast<double>(v);
    }
    case 32: {
      uint32_t u = (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
      return static_cast<double>(static_cast<int32_t>(u));
    }
    case 64: {
      uint64_t u = 0;
      for (int i = 0; i < 8; ++i) u = (u << 8) | p[i];
      return static_cast<double>(static_cast<int64_t>(u));
    }
    case -32: {
      uint32_t u = (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
      float f;
      std::memcpy(&f, &u, 4);
      return static_cast<double>(f);
    }
    case -64: {
      uint64_t u = 0;
      for (int i = 0; i < 8; ++i) u = (u << 8) | p[i];
      double d;
      std::memcpy(&d, &u, 8);
      return d;
    }
  }
  return 0.0;
}

}  // namespace

extern "C" {

int artes_fits_scan(const char* path, long* n_hdus) {
  std::vector<Hdu> hdus;
  int rc = scan_file(path, hdus);
  if (rc) return rc;
  *n_hdus = static_cast<long>(hdus.size());
  return 0;
}

int artes_fits_hdu_info(const char* path, int index, long* ndim, long* shape,
                        char* name) {
  std::vector<Hdu> hdus;
  int rc = scan_file(path, hdus);
  if (rc) return rc;
  if (index < 0 || index >= static_cast<int>(hdus.size())) return -3;
  const Hdu& h = hdus[index];
  *ndim = h.ndim;
  for (long i = 0; i < 8; ++i) shape[i] = h.shape[i];
  std::memcpy(name, h.name, 72);
  return 0;
}

int artes_fits_read(const char* path, int index, double* out, long n) {
  std::vector<Hdu> hdus;
  int rc = scan_file(path, hdus);
  if (rc) return rc;
  if (index < 0 || index >= static_cast<int>(hdus.size())) return -3;
  const Hdu& h = hdus[index];
  if (h.n_elems() != n) return -4;
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return -1;
  std::fseek(fh, h.data_offset, SEEK_SET);
  const int itemsize = h.bitpix < 0 ? (-h.bitpix / 8) : (h.bitpix / 8);
  std::vector<unsigned char> raw(static_cast<size_t>(n) * itemsize);
  if (std::fread(raw.data(), 1, raw.size(), fh) != raw.size()) {
    std::fclose(fh);
    return -5;
  }
  std::fclose(fh);
  for (long i = 0; i < n; ++i)
    out[i] = convert(raw.data() + static_cast<size_t>(i) * itemsize, h.bitpix);
  return 0;
}

}  // extern "C"
