// Masked earliest-cover reduction on Hopper (sm_90a):
//
//   out[c, s] = max_{i < b_c} min_{j < r_c} (scale_c * x[c, s, i * ld_c + j])
//
// Replaces the Pallas TPU kernel repro/kernels/cover.py::_kernel (entry
// masked_cover_times) and, in one contract, the vmapped gather + scale of
// repro/cluster/vectorized.py::_frontier_cover: the frontier packs a
// candidate's replica slots row-major as i * r + j, so with ld_c = r_c the
// kernel reads that packing directly and the padded (B_pad, r_pad) gather
// disappears.  masked_cover_times is the case C = 1, x = (reps, B_pad * r_pad),
// ld = r_pad.
//
// Exactness: every element is scaled before the min, as the reference does,
// and the reductions are min/max only, so the result is bitwise equal to the
// reference's.  NaN propagates as jnp.min / jnp.max propagate it (fminf /
// fmaxf would drop it).  Built with --fmad=false.
//
// Bound on this card: memory.  The kernel reads C * S * n_slots * sizeof(T)
// bytes once and writes C * S * sizeof(T); it does ~2 flops per element read.
//
// Design (first version): one thread per (c, s) row over a grid of
// (ceil(S / 256), C).  Each thread walks its own row, so neighbouring threads
// of a warp read addresses n_slots elements apart: the loads are uncoalesced
// and lean on L1 to reuse each 128-byte line.  The first thing to fix is
// that layout: a warp per row, or a tile of rows staged in shared memory and
// read coalesced.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T nan_min(T acc, T v) {
  // v wins if smaller or NaN; once acc is NaN no comparison replaces it
  return (v < acc || v != v) ? v : acc;
}

template <typename T>
__device__ __forceinline__ T nan_max(T acc, T v) {
  return (v > acc || v != v) ? v : acc;
}

// geom is (C, 3) int32: n_batches b, replication r, leading dim ld per row c
template <typename T>
__global__ void __launch_bounds__(kThreads)
cover_kernel(const T* __restrict__ x, const int* __restrict__ geom,
             const T* __restrict__ scale, T* __restrict__ out, int S, int n_slots) {
  const int c = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int b = geom[3 * c];
  const int r = geom[3 * c + 1];
  const int ld = geom[3 * c + 2];
  const T sc = scale[c];
  const T* row = x + (static_cast<size_t>(c) * S + s) * static_cast<size_t>(n_slots);
  T t = -static_cast<T>(INFINITY);
  for (int i = 0; i < b; ++i) {
    const T* batch = row + static_cast<size_t>(i) * ld;
    T m = static_cast<T>(INFINITY);
    for (int j = 0; j < r; ++j) m = nan_min(m, sc * batch[j]);
    t = nan_max(t, m);
  }
  out[static_cast<size_t>(c) * S + s] = t;
}

template <typename T>
int launch(const void* x, const void* geom, const void* scale, void* out, int C, int S,
           int n_slots, void* stream) {
  dim3 grid((S + kThreads - 1) / kThreads, C);
  cover_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(geom), static_cast<const T*>(scale),
      static_cast<T*>(out), S, n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cover_f32(const void* x, const void* geom, const void* scale, void* out, int C,
                         int S, int n_slots, void* stream) {
  return launch<float>(x, geom, scale, out, C, S, n_slots, stream);
}

extern "C" int cover_f64(const void* x, const void* geom, const void* scale, void* out, int C,
                         int S, int n_slots, void* stream) {
  return launch<double>(x, geom, scale, out, C, S, n_slots, stream);
}
