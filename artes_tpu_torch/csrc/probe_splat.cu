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
// (blocks of 256 filled 32 of 132). The baseline is the splat's yardstick,
// so it runs the same lanes in the same grid, 128 blocks of 64, with the
// same lane state and LCG: it times the loop the splat runs. A privatised
// copy of the detector in each block's shared memory, flushed once, was
// slower at 625 and 2025 pixels on an H100: shared f64 and 64-bit atomic
// adds compile to compare-and-swap loops (PERF.md, row 3).
//
// What bounds them: the splat, atomic throughput at the L2 and its
// serialisation on the same address (the TPU probe's 625 hot pixels); the
// baseline, the latency of its chain of dependent multiply-adds, one lane's
// n_rounds IMADs in a row. probe_splat.us_per_round times both as slopes
// over n_rounds (launch costs cancel). Plain PyTorch version:
// artes_tpu_torch/probe_splat.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 8192;
constexpr int THREADS = 64;
constexpr float TWO_M24 = 5.9604644775390625e-8f;   // 2^-24

__device__ __forceinline__ uint32_t lcg(uint32_t x) { return x * 1664525u + 1013904223u; }

// One step of the chain as the splat runs it: the empty asm statement keeps
// every step's value, so that nvcc cannot fold unrolled steps into one
// multiply-add (x -> a^k x + c_k), which it does where nothing reads them.
__device__ __forceinline__ uint32_t lcg_step(uint32_t x) {
  x = lcg(x);
  asm volatile("" : "+r"(x));
  return x;
}

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

__global__ void __launch_bounds__(THREADS)
probe_baseline_kernel(int n_rounds, uint32_t seed, double* __restrict__ sink) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= LANES) return;
  uint32_t x = (uint32_t)lane + seed;
  for (int t = 0; t < n_rounds; ++t) x = lcg_step(x);
  sink[lane] = (double)(x >> 8);
}

// The latency of one step of the baseline's chain, measured: one warp runs
// `steps` dependent steps of the baseline's loop between two reads of the
// SM's cycle counter; lane 0 stores the cycles and the chain's last value.
// The empty asm statements hold the chain between the two reads.
__global__ void probe_chain_clock(int steps, uint32_t seed, long long* __restrict__ cycles,
                                  unsigned int* __restrict__ last) {
  uint32_t x = threadIdx.x + seed;
  const long long t0 = clock64();
  asm volatile("" : "+r"(x));
  for (int t = 0; t < steps; ++t) x = lcg_step(x);
  asm volatile("" : "+r"(x));
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    last[0] = x;
  }
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
  probe_baseline_kernel<<<LANES / THREADS, THREADS, 0, (cudaStream_t)stream>>>(n_rounds, seed,
                                                                              sink);
  return (int)cudaGetLastError();
}

extern "C" int artes_probe_chain_clock_launch(int steps, unsigned int seed, long long* cycles,
                                              unsigned int* last, void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  probe_chain_clock<<<1, 32, 0, (cudaStream_t)stream>>>(steps, seed, cycles, last);
  return (int)cudaGetLastError();
}

extern "C" int artes_probe_lanes() { return LANES; }
