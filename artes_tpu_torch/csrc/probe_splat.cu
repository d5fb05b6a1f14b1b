// Micro-benchmark of the image splat on Hopper: the cost of adding one
// peel's features into a random pixel, per round of 8192 peels.
//
// Replaces the two TPU kernels of tools/probe_splat.py: ::build (the MXU
// one-hot splat of F features into an (F * nrows, 128) f32 detector) and
// ::baseline (the same loop without the splat). Both kernels here run the
// same fake per-lane state as the TPU probe: lane l starts at x = l + seed,
// and every round x = x * 1664525 + 1013904223 (mod 2^32), the pixel is
// (x >> 17) % npix and v0 = (x >> 8) * 2^-24. The splat kernel adds, per
// lane and round, ncnt count features (v0 < 0.5 + 0.1 f) into an (npix,
// ncnt) 64-bit count array and nvals value features v0 * (1 + 0.25 f) into
// an (npix, nvals) double array, as pool_radial.cu's image instantiations add
// a peel (ncnt = 2, nvals = 8). The baseline kernel runs the loop alone and
// stores each lane's last (x >> 8), so its time is the loop overhead to
// subtract.
//
// The splat adds every feature with a global atomic at the L2. The 8192
// lanes run in 128 blocks of 64, so that every SM of the card but four works
// (blocks of 256 filled 32 of 132); the baseline keeps its 32 blocks of 256.
// A privatised copy of the detector in each block's shared memory, flushed
// once, was slower at 625 and 2025 pixels on an H100: shared f64 and 64-bit
// atomic adds compile to compare-and-swap loops (PERF.md, row 3).
//
// What bounds it: atomic throughput at the L2 and its serialisation on the
// same address (the TPU probe's 625 hot pixels). Plain PyTorch version:
// artes_tpu_torch/probe_splat.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 8192;
constexpr int THREADS = 64;
constexpr float TWO_M24 = 5.9604644775390625e-8f;   // 2^-24

__device__ __forceinline__ uint32_t lcg(uint32_t x) { return x * 1664525u + 1013904223u; }

__global__ void __launch_bounds__(THREADS)
probe_splat_kernel(int npix, int n_rounds, uint32_t seed, int nvals, int ncnt,
                   double* __restrict__ vals, unsigned long long* __restrict__ counts) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= LANES) return;
  uint32_t x = (uint32_t)lane + seed;
  for (int t = 0; t < n_rounds; ++t) {
    x = lcg(x);
    const int pix = (int)((x >> 17) % (uint32_t)npix);
    const float v0 = (float)(int32_t)(x >> 8) * TWO_M24;
    for (int f = 0; f < ncnt; ++f)
      if (v0 < (float)(0.5 + 0.1 * f)) atomicAdd(counts + (size_t)pix * ncnt + f, 1ull);
    for (int f = 0; f < nvals; ++f)
      atomicAdd(vals + (size_t)pix * nvals + f, (double)(v0 * (float)(1.0 + 0.25 * f)));
  }
}

__global__ void __launch_bounds__(256)
probe_baseline_kernel(int n_rounds, uint32_t seed, double* __restrict__ sink) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= LANES) return;
  uint32_t x = (uint32_t)lane + seed;
  for (int t = 0; t < n_rounds; ++t) x = lcg(x);
  sink[lane] = (double)(x >> 8);
}

}  // namespace

// C entry points for ctypes: launch on `stream`, return cudaGetLastError().
extern "C" int artes_probe_splat_launch(int npix, int n_rounds, unsigned int seed, int nvals,
                                        int ncnt, double* vals, unsigned long long* counts,
                                        void* stream) {
  if (npix < 1 || n_rounds < 0 || nvals < 0 || ncnt < 0) return (int)cudaErrorInvalidValue;
  probe_splat_kernel<<<LANES / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      npix, n_rounds, seed, nvals, ncnt, vals, counts);
  return (int)cudaGetLastError();
}

extern "C" int artes_probe_baseline_launch(int n_rounds, unsigned int seed, double* sink,
                                           void* stream) {
  if (n_rounds < 0) return (int)cudaErrorInvalidValue;
  probe_baseline_kernel<<<LANES / 256, 256, 0, (cudaStream_t)stream>>>(n_rounds, seed, sink);
  return (int)cudaGetLastError();
}

extern "C" int artes_probe_lanes() { return LANES; }
