// Pieces shared by the three flash-attention kernels (flash_attention.cu).
//
// Every kernel computes the same function: for q (B, Sq, H, hd), k / v
// (B, Sk, KH, hd) with H % KH == 0 (query head h reads kv head h / (H / KH))
// and int32 positions qpos (B, Sq), kvpos (B, Sk), key j is visible to query
// i iff kvpos[j] >= 0 (a written slot), and, when causal, kvpos[j] <= qpos[i],
// and, with a window, qpos[i] - kvpos[j] < window.  A masked score is the
// reference's finite NEG_INF = f32 min / 2, never -inf, so a run of keys that
// is masked for a row gives p = 1 until a real score arrives and
// exp(NEG_INF - m) = 0 wipes it; keys past Sk are not part of the softmax; the
// output is acc / max(l, 1e-30).  Tensors are addressed through their
// (batch, seq, head) element strides with hd contiguous.
#pragma once

#include <math.h>
#include <stdint.h>

#include <cfloat>
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -0.5f * FLT_MAX;  // the reference's NEG_INF

struct Strides {  // in elements; hd is contiguous
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

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

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Whether a key at position kp can be seen by some query whose position lies
// in [q_lo, q_hi]: the test that skips a tile or a split of keys.
__device__ __forceinline__ bool visible_to_range(int kp, int q_lo, int q_hi, int causal,
                                                 int window) {
  return kp >= 0 && (!causal || kp <= q_hi) && (window <= 0 || q_lo - kp < window);
}

// Whether the key at position kp is visible to the query at position qp.
__device__ __forceinline__ bool visible(int kp, int qp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// Raise a kernel's dynamic shared memory limit once per instantiation.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace attn
