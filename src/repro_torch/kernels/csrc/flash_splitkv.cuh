// Split-KV decode attention on Hopper (sm_90a), float32 and bfloat16: the
// kernel for the few query rows of a decode step against a long KV cache.
//
// Replaces, for decode, the Pallas TPU kernel
// repro/kernels/flash_attention.py::_kernel (entry flash_attention_fwd), whose
// grid walks (batch, head, q tile) in parallel and the KV tiles in order,
// with m, l and acc in VMEM scratch.  On the TPU one core walks the cache; on
// a 132-SM card a decode step (Sq = 1) has only B * H query rows, and a grid
// over query heads is 12 blocks for qwen2-1.5b that each read the whole cache
// once per query head.
//
// Bound on this card: bytes and latency.  Decode reads each K / V byte once
// and does 4 * hd flops per (row, key) pair, under one flop per byte, so it
// is bound by the bytes of the cache (qwen2-1.5b: 1056 slots x 2 kv heads x
// 128 x 2 bytes for K and again for V = 1.08 MB, 0.32 us at 3.35 TB/s) and,
// at that size, by the latency of a round trip to memory and of the launch.
//
// Design.  The wrapper routes here when the query rows of one KV group are
// few: Sq * (H / KH) <= kMaxRows = 16 (the served decode has 1 * 6), so that
// a lane's float32 accumulators for all rows stay in registers.  The grid is
// (n_split, KH, B): one block serves all g = H / KH query heads (and all Sq
// queries) of its kv head, so every K / V byte is read once, not g times, and
// n_split slices of the slots fill the card (the wrapper picks n_split so
// that B * KH * n_split covers the SMs with at least 16 slots a split; qwen2
// decode: 66 splits of 16 slots x 2 kv heads = 132 blocks).  Inside a block,
// the lanes of a group split one key's head_dim into 16-byte vectors (a
// 128-wide bf16 row is 16 lanes x 8 values), so a warp takes 32 / LPK keys at
// once; K and V come straight from global memory in 16-byte loads, two keys a
// group in flight, never staged in shared memory.  Each group of LPK lanes
// keeps its own online-softmax stream (m, l, acc[rows][its dims]) in float32
// registers; the streams merge by shuffles within a warp and through shared
// memory across warps, and the block writes its split's (m, l, acc) to
// float32 scratch.  A split in which no key is visible to any query of the
// block (all slots unwritten, or outside the causal / window range) is
// skipped: it writes m = NEG_INF, l = 0 and acc = 0, and the merge gives it
// weight 0.  An unskipped split keeps the single-pass semantics: a stream
// that has seen only masked keys holds m = NEG_INF and p = 1 for each, and
// any real score elsewhere wipes it in a merge, since exp(NEG_INF - m) = 0.
// The last block of each (b, kv head) to finish, found by an atomic ticket
// that it returns to zero, merges the splits:
// m* = max_s m_s, w_s = exp(m_s - m*) where l_s > 0 (else 0),
// out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30), 4 values a thread with
// the splits' loads unrolled 8 deep.  One launch, no second kernel.  The
// scale is folded into q as it is staged in float32.
#pragma once

#include <string.h>

#include "attention_common.cuh"

namespace splitkv {

using attn::kNegInf;
using attn::Strides;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 16;     // Sq * g at most: the wrapper's routing rule
constexpr int kMaxSplits = 256;  // n_split at most (the merge keeps its weights in shared memory)

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

constexpr size_t smem_bytes(int hdp, int rows) {
  // q (rows, hdp) and the warps' acc (kWarps, rows, hdp); the warps' (m, l)
  // (kWarps, rows, 2); the merge's weights (kMaxSplits, rows) and sums
  // (rows); float32; then the rows' positions (rows) as int32
  return (static_cast<size_t>(rows) * hdp * (1 + kWarps) + kWarps * rows * 2 +
          static_cast<size_t>(kMaxSplits) * rows + rows) * sizeof(float) + rows * sizeof(int);
}

// Block (split, kv head, b): the slice of keys [split * chunk, + chunk) for
// all Sq * g rows of one kv head.  part is float32 scratch of
// B * KH * n_split * ROWS * (2 + hd) values; tickets holds B * KH zeros.
// HDP = head_dim padded to a power of two (32 .. 256); ROWS >= Sq * g.
template <typename T, int HDP, int ROWS>
__global__ void __launch_bounds__(kThreads)
splitkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ qpos, const int* __restrict__ kvpos, T* __restrict__ o,
               float* __restrict__ part, int* __restrict__ tickets, int Sq, int Sk, int H,
               int KH, int hd, float scale, int causal, int window, int chunk, Strides st) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // values per 16-byte vector
  constexpr int VR = HDP / VEC;                            // vectors per padded row
  constexpr int LPK = VR < 32 ? VR : 32;                   // lanes per key
  constexpr int VPL = VR / LPK;                            // vectors per lane
  constexpr int KPW = 32 / LPK;                            // keys a warp takes at once
  constexpr int NG = kWarps * KPW;                         // key groups in the block
  constexpr int NV = VPL * VEC;                            // head_dim values per lane

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                            // (ROWS, HDP)
  float* acc_s = q_s + ROWS * HDP;              // (kWarps, ROWS, HDP)
  float* ml_s = acc_s + kWarps * ROWS * HDP;    // (kWarps, ROWS, 2)
  float* wts_s = ml_s + kWarps * ROWS * 2;      // (kMaxSplits, ROWS)
  float* lsum_s = wts_s + kMaxSplits * ROWS;    // (ROWS,)
  int* qp_s = reinterpret_cast<int*>(lsum_s + ROWS);  // (ROWS,)
  __shared__ int last_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int g = H / KH;
  const int R = Sq * g;  // row r is query r / g of head kvh * g + r % g
  const int s0 = split * chunk;
  const int s1 = min(Sk, s0 + chunk);
  const int* kp_b = kvpos + static_cast<size_t>(b) * Sk;
  const int* qp_b = qpos + static_cast<size_t>(b) * Sq;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;

  // stage q (scaled, float32, zero past hd and past R) and the rows' positions
  for (int idx = tid; idx < ROWS * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx % HDP;
    float val = 0.0f;
    if (r < R && d < hd) {
      const int qi = r / g, h = kvh * g + r % g;
      val = attn::to_f32(q[b * st.qb + qi * st.qs + h * st.qh + d]) * scale;
    }
    q_s[idx] = val;
  }
  if (tid < ROWS) qp_s[tid] = tid < R ? qp_b[tid / g] : 0;
  int q_lo = INT_MAX, q_hi = INT_MIN;
  for (int i = 0; i < Sq; ++i) {
    q_lo = min(q_lo, qp_b[i]);
    q_hi = max(q_hi, qp_b[i]);
  }
  // the split skip: is any key of the slice visible to any query of the block?
  int relevant = 0;
  for (int j = s0 + tid; j < s1 && !relevant; j += kThreads)
    relevant = attn::visible_to_range(kp_b[j], q_lo, q_hi, causal, window);
  relevant = __syncthreads_or(relevant);  // also publishes q_s and qp_s

  const int bk = b * KH + kvh;
  const size_t n_part = static_cast<size_t>(gridDim.x) * gridDim.y * gridDim.z;
  float* part_ml = part;                              // (B * KH, n_split, ROWS, 2)
  float* part_acc = part + n_part * ROWS * 2;         // (B * KH, n_split, ROWS, hd)
  const size_t my_part = static_cast<size_t>(bk) * n_split + split;
  const int n4 = R * hd / 4;  // hd % 4 == 0: the wrapper routes here only 16-byte rows

  if (relevant) {
    const int li = lane % LPK;                   // this lane's place in its key group
    const int grp = warp * KPW + lane / LPK;     // this lane's key group
    float m[ROWS], l[ROWS], acc[ROWS][NV];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[r] = kNegInf;
      l[r] = 0.0f;
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[r][e] = 0.0f;
    }

    for (int base = s0; base < s1; base += 2 * NG) {  // block-uniform trip count
      uint4 kr[2][VPL], vr[2][VPL];
      int kp[2];
      bool ok[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // both keys' loads in flight before any use
        const int j = base + grp + u * NG;
        ok[u] = j < s1;
        kp[u] = ok[u] ? kp_b[j] : -1;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int dim = (li + i * LPK) * VEC;
          const bool load = ok[u] && dim < hd;
          const uint4 zero = make_uint4(0, 0, 0, 0);
          kr[u][i] = load ? *reinterpret_cast<const uint4*>(kb + j * st.ks + dim) : zero;
          vr[u][i] = load ? *reinterpret_cast<const uint4*>(vb + j * st.vs + dim) : zero;
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float kf[NV], vf[NV];
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          unpack(kr[u][i], kf + i * VEC, static_cast<const T*>(nullptr));
          unpack(vr[u][i], vf + i * VEC, static_cast<const T*>(nullptr));
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r >= R) break;  // block-uniform
          float dot = 0.0f;
#pragma unroll
          for (int i = 0; i < VPL; ++i) {
            const float4* qv =
                reinterpret_cast<const float4*>(q_s + r * HDP + (li + i * LPK) * VEC);
#pragma unroll
            for (int e4 = 0; e4 < VEC / 4; ++e4) {
              const float4 qq = qv[e4];
              const float* kk = kf + i * VEC + 4 * e4;
              dot = fmaf(qq.x, kk[0], dot);
              dot = fmaf(qq.y, kk[1], dot);
              dot = fmaf(qq.z, kk[2], dot);
              dot = fmaf(qq.w, kk[3], dot);
            }
          }
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (ok[u]) {
            const float s = attn::visible(kp[u], qp_s[r], causal, window) ? dot : kNegInf;
            const float m_new = fmaxf(m[r], s);
            const float alpha = expf(m[r] - m_new);
            const float p = expf(s - m_new);
            l[r] = l[r] * alpha + p;
#pragma unroll
            for (int e = 0; e < NV; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e] * alpha);
            m[r] = m_new;
          }
        }
      }
    }

    // merge the key groups of a warp (lanes that differ in bits >= LPK)
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= R) break;
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float mn = fmaxf(m[r], mo);
        const float a = expf(m[r] - mn), c = expf(mo - mn);
        l[r] = l[r] * a + lo * c;
#pragma unroll
        for (int e = 0; e < NV; ++e)
          acc[r][e] = acc[r][e] * a + __shfl_xor_sync(0xffffffffu, acc[r][e], off) * c;
        m[r] = mn;
      }
    }
    if (lane < LPK) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r >= R) break;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          float4* dst =
              reinterpret_cast<float4*>(acc_s + (warp * ROWS + r) * HDP + (li + i * LPK) * VEC);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float* a = acc[r] + i * VEC + 4 * e4;
            dst[e4] = make_float4(a[0], a[1], a[2], a[3]);
          }
        }
        if (lane == 0) {
          ml_s[(warp * ROWS + r) * 2] = m[r];
          ml_s[(warp * ROWS + r) * 2 + 1] = l[r];
        }
      }
    }
    __syncthreads();
    // merge the warps and write the split's partials, 4 values a thread
    for (int c4 = tid; c4 < n4; c4 += kThreads) {
      const int r = 4 * c4 / hd, d = 4 * c4 - r * hd;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[(w * ROWS + r) * 2]);
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float lsum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(ml_s[(w * ROWS + r) * 2] - mx);
        const float4 x = *reinterpret_cast<const float4*>(acc_s + (w * ROWS + r) * HDP + d);
        a = make_float4(fmaf(c, x.x, a.x), fmaf(c, x.y, a.y), fmaf(c, x.z, a.z), fmaf(c, x.w, a.w));
        lsum = fmaf(c, ml_s[(w * ROWS + r) * 2 + 1], lsum);
      }
      *reinterpret_cast<float4*>(part_acc + (my_part * ROWS + r) * hd + d) = a;
      if (d == 0) {
        part_ml[(my_part * ROWS + r) * 2] = mx;
        part_ml[(my_part * ROWS + r) * 2 + 1] = lsum;
      }
    }
  } else {  // skipped: weight 0 and acc 0, so the merge reads it unconditionally
    for (int c4 = tid; c4 < n4; c4 += kThreads) {
      const int r = 4 * c4 / hd, d = 4 * c4 - r * hd;
      *reinterpret_cast<float4*>(part_acc + (my_part * ROWS + r) * hd + d) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (d == 0) {
        part_ml[(my_part * ROWS + r) * 2] = kNegInf;
        part_ml[(my_part * ROWS + r) * 2 + 1] = 0.0f;
      }
    }
  }

  // the last block of this (b, kv head) merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&tickets[bk], 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const size_t first = static_cast<size_t>(bk) * n_split;
  for (int r = warp; r < R; r += kWarps) {
    float mx = kNegInf;
    for (int s = lane; s < n_split; s += 32)
      mx = fmaxf(mx, __ldcg(part_ml + ((first + s) * ROWS + r) * 2));
    mx = attn::warp_max(mx);
    float lsum = 0.0f;
    for (int s = lane; s < n_split; s += 32) {
      const float ms = __ldcg(part_ml + ((first + s) * ROWS + r) * 2);
      const float ls = __ldcg(part_ml + ((first + s) * ROWS + r) * 2 + 1);
      const float w = ls > 0.0f ? expf(ms - mx) : 0.0f;
      wts_s[s * ROWS + r] = w;
      lsum = fmaf(w, ls, lsum);
    }
    lsum = attn::warp_sum(lsum);
    if (lane == 0) lsum_s[r] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  // 4 values a thread; the splits' loads unrolled so that 8 are in flight
  const size_t step = static_cast<size_t>(ROWS) * hd / 4;  // float4s from a split to the next
  for (int c4 = tid; c4 < n4; c4 += kThreads) {
    const int r = 4 * c4 / hd, d = 4 * c4 - r * hd;
    const float4* src = reinterpret_cast<const float4*>(part_acc + (first * ROWS + r) * hd + d);
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const float w = wts_s[s * ROWS + r];
      const float4 x = __ldcg(src + s * step);
      a = make_float4(fmaf(w, x.x, a.x), fmaf(w, x.y, a.y), fmaf(w, x.z, a.z), fmaf(w, x.w, a.w));
    }
    const int qi = r / g, h = kvh * g + r % g;
    T* dst = o + b * st.ob + qi * st.os + h * st.oh + d;
    const float den = lsum_s[r];
    dst[0] = attn::from_f32<T>(a.x / den);
    dst[1] = attn::from_f32<T>(a.y / den);
    dst[2] = attn::from_f32<T>(a.z / den);
    dst[3] = attn::from_f32<T>(a.w / den);
  }
  if (tid == 0) tickets[bk] = 0;  // ready for the next launch on this stream
}

template <typename T, int HDP, int ROWS>
int launch(const void* q, const void* k, const void* v, const void* qpos, const void* kvpos,
           void* o, void* part, void* tickets, const long long* dims, const Strides& st,
           float scale, int causal, int window, int n_split, int chunk, cudaStream_t stream) {
  const int B = static_cast<int>(dims[0]), Sq = static_cast<int>(dims[1]);
  const int Sk = static_cast<int>(dims[2]), H = static_cast<int>(dims[3]);
  const int KH = static_cast<int>(dims[4]), hd = static_cast<int>(dims[5]);
  constexpr size_t bytes = smem_bytes(HDP, ROWS);
  static bool attr_set = false;
  cudaError_t err = attn::allow_smem(splitkv_kernel<T, HDP, ROWS>, bytes, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_split, KH, B);
  splitkv_kernel<T, HDP, ROWS><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(qpos), static_cast<const int*>(kvpos), static_cast<T*>(o),
      static_cast<float*>(part), static_cast<int*>(tickets), Sq, Sk, H, KH, hd, scale, causal,
      window, chunk, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ROWS>
int dispatch_hd(const void* q, const void* k, const void* v, const void* qpos, const void* kvpos,
                void* o, void* part, void* tickets, const long long* dims, const Strides& st,
                float scale, int causal, int window, int n_split, int chunk, cudaStream_t s) {
  const long long hd = dims[5];
#define SPLITKV_LAUNCH(HDP)                                                                  \
  launch<T, HDP, ROWS>(q, k, v, qpos, kvpos, o, part, tickets, dims, st, scale, causal, window, \
                       n_split, chunk, s)
  if (hd <= 32) return SPLITKV_LAUNCH(32);
  if (hd <= 64) return SPLITKV_LAUNCH(64);
  if (hd <= 128) return SPLITKV_LAUNCH(128);
  if (hd <= 256) return SPLITKV_LAUNCH(256);
#undef SPLITKV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// rows = Sq * g picks the register budget: 8 or 16 rows
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* qpos, const void* kvpos,
             void* o, void* part, void* tickets, const long long* dims, const Strides& st,
             float scale, int causal, int window, int n_split, int chunk, cudaStream_t s) {
  const long long rows = dims[1] * (dims[3] / dims[4]);
  if (rows <= 8)
    return dispatch_hd<T, 8>(q, k, v, qpos, kvpos, o, part, tickets, dims, st, scale, causal,
                             window, n_split, chunk, s);
  if (rows <= kMaxRows)
    return dispatch_hd<T, kMaxRows>(q, k, v, qpos, kvpos, o, part, tickets, dims, st, scale,
                                    causal, window, n_split, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace splitkv
