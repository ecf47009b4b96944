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
// Design: one warp per row and kWarps rows per block, so a qwen2 prefill
// (1024 x 1536) is 128 blocks of 8 rows.  On the vector path each lane loads
// its share of the row as 16-byte vectors (8 bf16 or 4 float32 values: a
// 1536-wide bf16 row is 6 vectors a lane), all issued before any is used, and
// keeps them in registers between the sum of squares (a warp shuffle
// reduction, no shared memory, no block barrier) and the scaling, so the row
// is read once.  The block loads w' once into shared memory as float32 while
// the rows' loads are in flight.  Rows whose width is not a multiple of the
// vector, whose start is not 16-byte aligned (a view), or that are wider than
// the registers hold (NV vectors a lane) take the scalar path inside the same
// kernel: lane-strided loads, a second pass over the row from L1 / L2.
// bfloat16 converts only through the intrinsics.
//
// The split row (tensor parallelism over "model", where each rank holds a
// contiguous chunk of the row's columns: mamba2's gated norm over a sharded
// d_inner).  The mean runs over the whole row, so it needs every rank's sum
// of squares.  rmsnorm_sumsq writes each row's float32 sum of squares of the
// rank's columns (one warp a row, the same lane order and vector / scalar
// paths as the fused kernel, the row read once); the caller sums those
// totals over its model group; rmsnorm_scaled then normalises the rank's
// columns with inv = rsqrt(total / width + eps), width the whole row's, by
// the fused kernel's own code (its SPLIT instantiation, which reads the
// row's total in place of summing).  Both are memory-bound like the fused
// kernel: the pair reads x twice and writes it once.
#include <stdint.h>
#include <string.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows a block
constexpr int kThreads = kWarps * 32;

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

// a 16-byte vector as float32 values, and back
__device__ __forceinline__ void unpack(const uint4& raw, float* f, const float*) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* f, const __nv_bfloat16*) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 pair;
    memcpy(&pair, &w[i], 4);
    const float2 f2 = __bfloat1622float2(pair);
    f[2 * i] = f2.x;
    f[2 * i + 1] = f2.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    memcpy(&w[i], &pair, 4);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NV = 16-byte vectors a lane holds on the vector path (d <= 32 * NV * VEC);
// vec = 1 when x and out are 16-byte aligned and d is a multiple of VEC.
// SPLIT: the row's sum of squares is total[row] over a whole row of `width`
// values (rmsnorm_scaled); else it is summed here over d = width values.
template <typename T, typename W, int NV, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
               long long rows, int d, float eps, int plus_one, int vec,
               const float* __restrict__ total, float width) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  extern __shared__ float w_s[];  // (d,) float32: w or 1 + w
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const bool active = row < rows;
  const T* xr = x + row * d;
  T* dst = out + row * d;
  const int nvec = d / VEC;

  uint4 buf[NV];
  if (vec && active) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) buf[i] = reinterpret_cast<const uint4*>(xr)[vi];
    }
  }
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float wi = to_f32(w[i]);
    w_s[i] = plus_one ? 1.0f + wi : wi;
  }
  __syncthreads();
  if (!active) return;

  if (vec) {
    float ss = 0.0f;
    if (!SPLIT) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (lane + 32 * i < nvec) {
          float f[VEC];
          unpack(buf[i], f, static_cast<const T*>(nullptr));
#pragma unroll
          for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
        }
      }
    }
    const float inv = rsqrtf((SPLIT ? total[row] : warp_sum(ss)) / width + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        float f[VEC];
        unpack(buf[i], f, static_cast<const T*>(nullptr));
        const float4* wv = reinterpret_cast<const float4*>(w_s + vi * VEC);
#pragma unroll
        for (int e4 = 0; e4 < VEC / 4; ++e4) {
          const float4 ww = wv[e4];
          f[4 * e4] = (f[4 * e4] * inv) * ww.x;
          f[4 * e4 + 1] = (f[4 * e4 + 1] * inv) * ww.y;
          f[4 * e4 + 2] = (f[4 * e4 + 2] * inv) * ww.z;
          f[4 * e4 + 3] = (f[4 * e4 + 3] * inv) * ww.w;
        }
        reinterpret_cast<uint4*>(dst)[vi] = pack(f, static_cast<const T*>(nullptr));
      }
    }
  } else {  // scalar path: any width, any alignment
    float ss = 0.0f;
    if (!SPLIT) {
      for (int i = lane; i < d; i += 32) {
        const float f = to_f32(xr[i]);
        ss += f * f;
      }
    }
    const float inv = rsqrtf((SPLIT ? total[row] : warp_sum(ss)) / width + eps);
    for (int i = lane; i < d; i += 32) dst[i] = from_f32<T>((to_f32(xr[i]) * inv) * w_s[i]);
  }
}

template <typename T, typename W, int NV, bool SPLIT>
int launch(const void* x, const void* w, void* out, long long rows, int d, float eps,
           int plus_one, int vec, const float* total, float width, void* stream) {
  const size_t bytes = static_cast<size_t>(d) * sizeof(float);
  static size_t allowed = 48 * 1024;  // once per instantiation, past the default
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(rmsnorm_kernel<T, W, NV, SPLIT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = bytes;
  }
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  rmsnorm_kernel<T, W, NV, SPLIT>
      <<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), rows, d,
          eps, plus_one, vec, total, width);
  return static_cast<int>(cudaGetLastError());
}

// the register budget: the fewest vectors a lane that hold the row
template <typename T, typename W, bool SPLIT>
int dispatch(const void* x, const void* w, void* out, long long rows, int d, float eps,
             int plus_one, int aligned, const float* total, float width, void* stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int per_lane = (d / VEC + 31) / 32;
  const int vec = aligned && d % VEC == 0 && per_lane <= 16;
  if (!vec || per_lane <= 2)
    return launch<T, W, 2, SPLIT>(x, w, out, rows, d, eps, plus_one, vec, total, width, stream);
  if (per_lane <= 4)
    return launch<T, W, 4, SPLIT>(x, w, out, rows, d, eps, plus_one, vec, total, width, stream);
  if (per_lane <= 8)
    return launch<T, W, 8, SPLIT>(x, w, out, rows, d, eps, plus_one, vec, total, width, stream);
  return launch<T, W, 16, SPLIT>(x, w, out, rows, d, eps, plus_one, vec, total, width, stream);
}

template <bool SPLIT>
int dispatch_types(const void* x, const void* w, void* out, long long rows, int d, float eps,
                   int plus_one, int x_dtype, int w_dtype, int aligned, const float* total,
                   float width, void* stream) {
  if (x_dtype == 0 && w_dtype == 0)
    return dispatch<float, float, SPLIT>(x, w, out, rows, d, eps, plus_one, aligned, total,
                                         width, stream);
  if (x_dtype == 0 && w_dtype == 1)
    return dispatch<float, __nv_bfloat16, SPLIT>(x, w, out, rows, d, eps, plus_one, aligned,
                                                 total, width, stream);
  if (x_dtype == 1 && w_dtype == 0)
    return dispatch<__nv_bfloat16, float, SPLIT>(x, w, out, rows, d, eps, plus_one, aligned,
                                                 total, width, stream);
  if (x_dtype == 1 && w_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16, SPLIT>(x, w, out, rows, d, eps, plus_one,
                                                         aligned, total, width, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The sum of squares of each row's d values, float32, one warp a row: the
// fused kernel's loads and its order of adds (lane + 32 i vectors, each
// vector's values in order, then the warp's butterfly), with no weight and
// no output row.  The vector path walks the row in strides of 32 vectors,
// so it has no register cap; the scalar path takes any width and alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_sumsq_kernel(const T* __restrict__ x, float* __restrict__ total, long long rows, int d,
                     int vec) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  const T* xr = x + row * d;
  float ss = 0.0f;
  if (vec) {
    const int nvec = d / VEC;
    for (int vi = lane; vi < nvec; vi += 32) {
      float f[VEC];
      unpack(reinterpret_cast<const uint4*>(xr)[vi], f, static_cast<const T*>(nullptr));
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) total[row] = ss;
}

template <typename T>
int launch_sumsq(const void* x, float* total, long long rows, int d, int aligned,
                 void* stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int vec = aligned && d % VEC == 0;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  rmsnorm_sumsq_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), total, rows, d, vec);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long rows, int d) {
  return rows < 1 || rows > 2147483647LL * kWarps || d < 1 || d > 56 * 1024;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x and out share one type; w has its
// own); aligned = 1 when x and out start on 16-byte boundaries
extern "C" int rmsnorm(const void* x, const void* w, void* out, long long rows, int d, float eps,
                       int plus_one, int x_dtype, int w_dtype, int aligned, void* stream) {
  if (bad_shape(rows, d)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_types<false>(x, w, out, rows, d, eps, plus_one, x_dtype, w_dtype, aligned,
                               nullptr, static_cast<float>(d), stream);
}

// the split row, step 1: total[row] = sum of x[row, :d]^2 in float32;
// aligned = 1 when x starts on a 16-byte boundary
extern "C" int rmsnorm_sumsq(const void* x, float* total, long long rows, int d, int x_dtype,
                             int aligned, void* stream) {
  if (bad_shape(rows, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0) return launch_sumsq<float>(x, total, rows, d, aligned, stream);
  if (x_dtype == 1) return launch_sumsq<__nv_bfloat16>(x, total, rows, d, aligned, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the split row, step 2: out[row, :d] = x * rsqrt(total[row] / width + eps) * w',
// total the row's sum of squares over every rank's columns, width (>= d)
// the whole row's count of values
extern "C" int rmsnorm_scaled(const void* x, const void* w, const float* total, void* out,
                              long long rows, int d, long long width, float eps, int plus_one,
                              int x_dtype, int w_dtype, int aligned, void* stream) {
  if (bad_shape(rows, d) || width < d) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_types<true>(x, w, out, rows, d, eps, plus_one, x_dtype, w_dtype, aligned,
                              total, static_cast<float>(width), stream);
}
