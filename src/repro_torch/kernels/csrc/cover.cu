// Masked earliest-cover reduction on Hopper (sm_90a), two kernels behind one
// module (kernels/cover.py):
//
//   A (cover_f32 / cover_f64), the draws-in kernel:
//     out[c, s] = max_{i < b_c} min_{j < r_c} (scale_c * x[c, s, i * ld_c + j])
//   B (sample_cover_f32 / sample_cover_f64), the fused sample-and-cover kernel:
//     out[c, s] = max_{i < b_c} min_{j < r_c} (scale_c * F^-1(u(seed, c, rep0 + s, i r_c + j)))
//
// Both replace the Pallas TPU kernel repro/kernels/cover.py::_kernel (entry
// masked_cover_times) and, in one contract, the vmapped gather + scale of
// repro/cluster/vectorized.py::_frontier_cover: the frontier packs a
// candidate's replica slots row-major as i * r + j, so with ld_c = r_c the
// padded (B_pad, r_pad) gather never exists.  masked_cover_times is kernel A
// with C = 1, x = (reps, B_pad * r_pad), ld = r_pad.  Kernel B is the
// frontier's path (cluster/vectorized.py::frontier_job_times): it draws every
// replica time in registers from the counter-based Philox stream of
// philox.cuh and writes only the (C, S) cover times.
//
// Exactness: every element is scaled before the min, as the reference does,
// and the reductions are min/max only, taken in slot order, so kernel A is
// bitwise equal to its plain version, and kernel B is too once it has drawn
// (its log1p / pow are libdevice's, torch's may differ by an ulp).  NaN
// propagates as jnp.min / jnp.max propagate it (fminf / fmaxf would drop
// it).  Built with --fmad=false, so kernel B's shifted-exponential
// log1p(-u) / a + b rounds as its plain version does.
//
// Kernel A, bound on this card: memory.  It reads C * S * n_slots *
// sizeof(T) bytes once and writes C * S * sizeof(T); ~2 flops per element.
// Design: a block of 128 threads owns 128 neighbouring rows of one candidate,
// a thread per row, and walks their columns in chunks of 32.  Warp w loads
// the chunk of its 32 rows with lane l on column l, so each load instruction
// reads 32 neighbouring words of one row (every 32-byte sector it touches is
// used; scalar loads take any row alignment, which n_slots = 41 and offset
// views need); 32 loads a lane are in flight, and the next chunk's loads are
// issued before this chunk is reduced.  The chunk goes through shared memory
// at a pitch of 33, so the 32 threads of a warp then read their own rows from
// 32 distinct banks, and each thread folds its row in order: a running min
// over the batch's r slots (masked slots j >= r skipped), folded into a
// running max at the batch's last slot.  The instructions a thread spends per
// element (a shared load, the scale, a compare-select min and the slot
// counter) stay few beside the bytes; a warp per row, reducing each batch
// with shuffles, needed more instructions than the card issues in the bytes'
// time (PERF.md).
//
// Kernel B, bound on this card: operations.  Nothing is read but the geometry
// and, for an empirical law, its table; the (C, S) output is all it writes.
// Each draw costs a quarter (float64: half) of a Philox4x32-10 call -- ten
// rounds of two 32 x 32 -> 64-bit products and a few integer ops -- plus the
// law's transform (log1p, pow or a table read) and a min and a max.
// Design: one thread per (c, s) row, 256 rows a block; every candidate at a
// budget N has b * r = N, so the rows are balanced.  The (C, S) stores are
// coalesced.  An empirical table of up to 48 KB goes into shared memory
// (job6 has 978 entries), a larger one is read through L1/L2.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace {

constexpr int kRows = 128;  // kernel A: rows (one a thread) per block
constexpr int kCols = 32;  // kernel A: columns per staged chunk (one a lane)
constexpr int kPitch = kCols + 1;  // kernel A: shared-memory row pitch, odd against the banks
constexpr int kSampleThreads = 256;  // kernel B: rows (one a thread) per block
constexpr size_t kTableSmemBytes = 48 * 1024;  // kernel B: tables up to this go to shared memory

enum Law { kExponential = 0, kShiftedExponential = 1, kPareto = 2, kEmpirical = 3 };

template <typename T>
__device__ __forceinline__ T nan_min(T acc, T v) {
  // v wins if smaller or NaN; once acc is NaN no comparison replaces it
  return (v < acc || v != v) ? v : acc;
}

template <typename T>
__device__ __forceinline__ T nan_max(T acc, T v) {
  return (v > acc || v != v) ? v : acc;
}

// ---------------------------------------------------------------------------
// kernel A: draws in, a thread per row, the rows' columns staged coalesced
// ---------------------------------------------------------------------------

// geom is (C, 3) int32: n_batches b, replication r, leading dim ld per row c
template <typename T>
__global__ void __launch_bounds__(kRows)
cover_kernel(const T* __restrict__ x, const int* __restrict__ geom,
             const T* __restrict__ scale, T* __restrict__ out, int S, int n_slots) {
  __shared__ T tile[kRows * kPitch];
  const int c = blockIdx.y;
  const int s0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, S - s0);
  const int b = geom[3 * c];
  const int r = geom[3 * c + 1];
  const int ld = geom[3 * c + 2];
  const T sc = scale[c];
  const int span = (b - 1) * ld + r;  // a masked last batch's tail is not read
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* rows = x + (static_cast<size_t>(c) * S + s0) * static_cast<size_t>(n_slots);
  const T inf = static_cast<T>(INFINITY);

  // warp w stages rows 32 w .. 32 w + 31, lane l column k0 + l of each:
  // every load instruction reads 32 neighbouring words of one row
  T held[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int row = warp * 32 + i;
    held[i] = (row < n_rows && lane < span)
                  ? rows[static_cast<size_t>(row) * n_slots + lane] : static_cast<T>(0);
  }
  T t = -inf;
  T m = inf;
  int j = 0;  // slot within the batch
  for (int k0 = 0; k0 < span; k0 += kCols) {
    __syncthreads();  // the last chunk's reads are done
#pragma unroll
    for (int i = 0; i < kCols; ++i) tile[(warp * 32 + i) * kPitch + lane] = sc * held[i];
    __syncthreads();
    const int next = k0 + kCols;
    if (next < span) {  // the next chunk's loads fly while this one is reduced
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int row = warp * 32 + i;
        held[i] = (row < n_rows && next + lane < span)
                      ? rows[static_cast<size_t>(row) * n_slots + next + lane]
                      : static_cast<T>(0);
      }
    }
    if (static_cast<int>(threadIdx.x) < n_rows) {
      const T* mine = tile + threadIdx.x * kPitch;  // pitch 33: the 32 rows of a warp
      const int n_k = min(kCols, span - k0);        // read 32 distinct banks
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (k < n_k) {
          if (j < r) {
            m = nan_min(m, mine[k]);
            if (j == r - 1) {  // the batch's last slot: fold its min into the max
              t = nan_max(t, m);
              m = inf;
            }
          }
          if (++j == ld) j = 0;
        }
      }
    }
  }
  if (static_cast<int>(threadIdx.x) < n_rows) {
    out[static_cast<size_t>(c) * S + s0 + threadIdx.x] = t;
  }
}

template <typename T>
int launch(const void* x, const void* geom, const void* scale, void* out, int C, int S,
           int n_slots, void* stream) {
  dim3 grid((S + kRows - 1) / kRows, C);
  cover_kernel<T><<<grid, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(geom), static_cast<const T*>(scale),
      static_cast<T*>(out), S, n_slots);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// kernel B: Philox draws in registers, one thread per row
// ---------------------------------------------------------------------------

__device__ __forceinline__ float log1p_t(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_t(double v) { return log1p(v); }
__device__ __forceinline__ float pow_t(float v, float e) { return powf(v, e); }
__device__ __forceinline__ double pow_t(double v, double e) { return pow(v, e); }

// slots one counter serves: 2 for float64 draws of a continuous law, else 4
template <typename T, int LAW>
struct PerCounter {
  static constexpr int value = (sizeof(T) == 8 && LAW != kEmpirical) ? 2 : 4;
};

// slot k of a counter's words as a uniform in [0, 1)
__device__ __forceinline__ float uniform_at(const uint32_t* ws, int k, float) {
  return philox::uniform_f32(ws[k]);
}
__device__ __forceinline__ double uniform_at(const uint32_t* ws, int k, double) {
  return philox::uniform_f64(ws[2 * k], ws[2 * k + 1]);
}

// slot k's draw of the law, in the order kernels/philox.py::transform computes it
template <typename T, int LAW>
__device__ __forceinline__ T law_draw(const uint32_t* ws, int k, T a, T bc, const T* tab,
                                      uint32_t n_tab) {
  if (LAW == kEmpirical) return tab[philox::table_index(ws[k], n_tab)];
  const T u = uniform_at(ws, k, T());
  if (LAW == kPareto) return pow_t(static_cast<T>(1) - u, a) * bc;
  const T e = log1p_t(-u) / a;
  return LAW == kShiftedExponential ? e + bc : e;
}

// geom as kernel A's (ld unused); consts (2,) the law's (a, b)
template <typename T, int LAW>
__device__ __forceinline__ void sample_cover(
    const int* __restrict__ geom, const T* __restrict__ scale, const T* __restrict__ consts,
    const T* __restrict__ table, int n_table, int table_in_smem, T* __restrict__ out, int S,
    uint32_t rep0, uint32_t k0, uint32_t k1) {
  const T* tab = table;
  if (LAW == kEmpirical && table_in_smem) {
    T* held = reinterpret_cast<T*>(dyn_smem);
    for (int e = threadIdx.x; e < n_table; e += blockDim.x) held[e] = table[e];
    __syncthreads();
    tab = held;
  }
  const int c = blockIdx.y;
  const int s = blockIdx.x * kSampleThreads + threadIdx.x;
  if (s >= S) return;
  const int r = geom[3 * c + 1];
  const int n = geom[3 * c] * r;
  const T sc = scale[c];
  const T a = consts[0];
  const T bc = consts[1];
  const uint32_t rep = rep0 + static_cast<uint32_t>(s);
  constexpr int P = PerCounter<T, LAW>::value;
  const T inf = static_cast<T>(INFINITY);
  T t = -inf;
  T m = inf;
  int j = 0;
#pragma unroll 1
  for (int q = 0; q * P < n; ++q) {
    const uint4 w = philox::philox4x32_10(
        make_uint4(static_cast<uint32_t>(q), rep, static_cast<uint32_t>(c), 0u), k0, k1);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (q * P + k < n) {
        m = nan_min(m, sc * law_draw<T, LAW>(ws, k, a, bc, tab, static_cast<uint32_t>(n_table)));
        if (++j == r) {
          t = nan_max(t, m);
          m = inf;
          j = 0;
        }
      }
    }
  }
  out[static_cast<size_t>(c) * S + s] = t;
}

// the stream's uniforms, written out: the check that the card draws the
// plain version's bits (kernel B itself never writes a draw)
template <typename T>
__global__ void __launch_bounds__(kSampleThreads)
uniforms_kernel(T* __restrict__ out, int S, int n_slots, uint32_t rep0, uint32_t k0,
                uint32_t k1) {
  const int c = blockIdx.y;
  const int s = blockIdx.x * kSampleThreads + threadIdx.x;
  if (s >= S) return;
  constexpr int P = sizeof(T) == 8 ? 2 : 4;
  T* row = out + (static_cast<size_t>(c) * S + s) * static_cast<size_t>(n_slots);
  for (int q = 0; q * P < n_slots; ++q) {
    const uint4 w = philox::philox4x32_10(
        make_uint4(static_cast<uint32_t>(q), rep0 + static_cast<uint32_t>(s),
                   static_cast<uint32_t>(c), 0u), k0, k1);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (q * P + k < n_slots) row[q * P + k] = uniform_at(ws, k, T());
    }
  }
}

}  // namespace

// one kernel per (dtype, law), with C names so the compiled code of each can
// be found by name (chip_smoke.py counts their instructions)
#define SAMPLE_COVER_KERNEL(NAME, T, LAW)                                                     \
  extern "C" __global__ void __launch_bounds__(kSampleThreads) NAME(                         \
      const int* __restrict__ geom, const T* __restrict__ scale, const T* __restrict__ consts, \
      const T* __restrict__ table, int n_table, int table_in_smem, T* __restrict__ out,       \
      int S, uint32_t rep0, uint32_t k0, uint32_t k1) {                                       \
    sample_cover<T, LAW>(geom, scale, consts, table, n_table, table_in_smem, out, S, rep0,   \
                         k0, k1);                                                             \
  }

SAMPLE_COVER_KERNEL(sample_cover_f32_exponential, float, kExponential)
SAMPLE_COVER_KERNEL(sample_cover_f32_shifted_exponential, float, kShiftedExponential)
SAMPLE_COVER_KERNEL(sample_cover_f32_pareto, float, kPareto)
SAMPLE_COVER_KERNEL(sample_cover_f32_empirical, float, kEmpirical)
SAMPLE_COVER_KERNEL(sample_cover_f64_exponential, double, kExponential)
SAMPLE_COVER_KERNEL(sample_cover_f64_shifted_exponential, double, kShiftedExponential)
SAMPLE_COVER_KERNEL(sample_cover_f64_pareto, double, kPareto)
SAMPLE_COVER_KERNEL(sample_cover_f64_empirical, double, kEmpirical)

namespace {

template <typename T>
using SampleKernel = void (*)(const int*, const T*, const T*, const T*, int, int, T*, int,
                              uint32_t, uint32_t, uint32_t);

template <typename T>
int launch_sample(SampleKernel<T> kernel, const void* geom, const void* scale,
                  const void* consts, const void* table, int n_table, void* out, int C, int S,
                  unsigned rep0, unsigned k0, unsigned k1, void* stream) {
  const size_t table_bytes = static_cast<size_t>(n_table) * sizeof(T);
  const int in_smem = table != nullptr && table_bytes <= kTableSmemBytes;
  dim3 grid((S + kSampleThreads - 1) / kSampleThreads, C);
  kernel<<<grid, kSampleThreads, in_smem ? table_bytes : 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(geom), static_cast<const T*>(scale),
      static_cast<const T*>(consts), static_cast<const T*>(table), n_table, in_smem,
      static_cast<T*>(out), S, rep0, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_uniforms(void* out, int C, int S, int n_slots, unsigned rep0, unsigned k0,
                    unsigned k1, void* stream) {
  dim3 grid((S + kSampleThreads - 1) / kSampleThreads, C);
  uniforms_kernel<T><<<grid, kSampleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(out), S, n_slots, rep0, k0, k1);
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

#define SAMPLE_ARGS geom, scale, consts, table, n_table, out, C, S, rep0, k0, k1, stream

extern "C" int sample_cover_f32(int law, const void* geom, const void* scale, const void* consts,
                                const void* table, int n_table, void* out, int C, int S,
                                unsigned rep0, unsigned k0, unsigned k1, void* stream) {
  switch (law) {
    case kExponential: return launch_sample<float>(sample_cover_f32_exponential, SAMPLE_ARGS);
    case kShiftedExponential:
      return launch_sample<float>(sample_cover_f32_shifted_exponential, SAMPLE_ARGS);
    case kPareto: return launch_sample<float>(sample_cover_f32_pareto, SAMPLE_ARGS);
    case kEmpirical: return launch_sample<float>(sample_cover_f32_empirical, SAMPLE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sample_cover_f64(int law, const void* geom, const void* scale, const void* consts,
                                const void* table, int n_table, void* out, int C, int S,
                                unsigned rep0, unsigned k0, unsigned k1, void* stream) {
  switch (law) {
    case kExponential: return launch_sample<double>(sample_cover_f64_exponential, SAMPLE_ARGS);
    case kShiftedExponential:
      return launch_sample<double>(sample_cover_f64_shifted_exponential, SAMPLE_ARGS);
    case kPareto: return launch_sample<double>(sample_cover_f64_pareto, SAMPLE_ARGS);
    case kEmpirical: return launch_sample<double>(sample_cover_f64_empirical, SAMPLE_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int philox_uniforms_f32(void* out, int C, int S, int n_slots, unsigned rep0,
                                   unsigned k0, unsigned k1, void* stream) {
  return launch_uniforms<float>(out, C, S, n_slots, rep0, k0, k1, stream);
}

extern "C" int philox_uniforms_f64(void* out, int C, int S, int n_slots, unsigned rep0,
                                   unsigned k0, unsigned k1, void* stream) {
  return launch_uniforms<double>(out, C, S, n_slots, rep0, k0, k1, stream);
}
