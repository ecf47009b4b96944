// Fused RMSNorm on Hopper (sm_90a):
//
//   out[row, :] = cast(x[row, :] * rsqrt(mean(x[row, :]^2) + eps) * w')
//
// with w' = w, or 1 + w for the gemma convention (plus_one), everything in
// float32 and the result cast back to x's type.  Replaces the Pallas TPU
// kernel repro/kernels/rmsnorm.py::_kernel (entry rms_norm_fused), which
// tiles rows over a parallel grid and keeps a row tile in VMEM.
//
// Bound on this card: memory.  The kernel must read rows * d elements of x
// and d of w and write rows * d elements; it does about 4 flops per element,
// far below the card's ~20 flops per byte of float32 balance.
//
// Design (first version): one block of 256 threads per row.  Each thread
// sums the squares of a strided slice of the row in float32, a warp-shuffle
// then shared-memory reduction gives the row's sum, and a second strided
// pass (the row, at most 12 KB, is still in L1) scales and stores.  Loads of
// neighbouring threads are neighbouring elements, so they coalesce; they are
// not yet vectorised (16 bytes per thread), which is the first thing to fix.
// bfloat16 converts only through the intrinsics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out, int d,
               float eps, int plus_one) {
  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  const size_t base = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(d);
  const T* row = x + base;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(row[i]);
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  T* dst = out + base;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float wi = to_f32(w[i]);
    if (plus_one) wi = 1.0f + wi;
    dst[i] = from_f32<T>((to_f32(row[i]) * inv) * wi);
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, long long rows, int d, float eps,
           int plus_one, void* stream) {
  rmsnorm_kernel<T, W><<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), d, eps,
      plus_one);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x and out share one type; w has its own)
extern "C" int rmsnorm(const void* x, const void* w, void* out, long long rows, int d, float eps,
                       int plus_one, int x_dtype, int w_dtype, void* stream) {
  if (rows < 1 || rows > 2147483647LL || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, w, out, rows, d, eps, plus_one, stream);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, plus_one, stream);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, plus_one, stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, plus_one, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
