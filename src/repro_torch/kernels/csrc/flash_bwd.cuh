// Attention backward on Hopper's tensor cores (sm_90a, bfloat16): the
// FlashAttention-2 recurrence on wgmma, deterministic, from the forward's
// row log-sum-exp (flash_wgmma.cuh writes it when asked).
//
// Replaces no TPU kernel: the JAX package trains through XLA's
// differentiation of its jnp attention.  The port's closed form
// (repro_torch/kernels/flash_attention.py::attention_bwd) builds every score
// matrix whole in float32 (S x S per head: 3.2 GB a layer at 4 x 4096 tokens)
// and runs its products on the CUDA cores; it stays the CPU path and the plain
// version these kernels are held to.
//
// Bound on this card: operations.  Causal qwen2-1.5b at 4 x 4096 tokens is
// five products of 2 B H S^2 hd / 2 a layer (P again, dV, dP, dQ, dK), 0.52
// TFLOP over about 60 MB of q, k, v, o, dO and the gradients: 0.52 ms at the
// tensor cores' 989 TFLOP/s against 18 us of memory.
//
// Design.  Three launches, no float atomics, so one input gives bitwise one
// output.
// * delta_kernel: delta = rowsum(dO o O) in float32, (B, H, Sq), a warp a row.
// * dkdv_kernel: a block (one warpgroup) owns (b, kv head, 64 keys); K and V
//   stay in shared memory; it walks the group's H / KH query heads and, for
//   each, the 64-query tiles that can see one of its keys (a skip mask
//   decided from the positions, as the forward's).  Per tile: S^T = K Q^T and
//   dP^T = V dO^T (wgmma, both operands K-major in shared memory), then in
//   registers P^T = exp(scale S^T - lse) under the positions mask and dS^T =
//   P^T o (dP^T - delta), each rounded to bf16 straight into wgmma's A
//   fragments; dV += P^T dO and dK += dS^T Q with dO and Q as MN-major B
//   operands.  dV and dK stay in float32 registers over the whole walk, so
//   the group's heads are summed in one fixed order.  Q, dO and their
//   lse / delta / positions fill a 2-stage cp.async ring one tile ahead.
// * dq_kernel: a block owns (b, head, 64 queries) with Q, dO, lse and delta
//   resident and walks the visible key tiles (K, V in the ring): S = Q K^T,
//   dP = dO V^T, dS as above, dQ += dS K.  This costs S and dP twice (seven
//   products for the five of the closed form) and needs no reduction of dQ
//   across blocks.
// Both walks go longest first: under a causal mask the first key tiles and
// the last query tiles see the most tiles, and their blocks come first in the
// grid so that no long block starts in the last wave.  The shared-memory
// layout, descriptors and wgmma wrappers are the forward's (flash_wgmma.cuh).
// head_dim: a multiple of 8 up to 128 (64 float32 accumulators a thread for
// each of dK and dV at 128); wider heads keep the plain backward.  Shared
// memory is 6 tiles, 98 KB at hd 128: two blocks an SM.
#pragma once

#include <stdint.h>

#include "attention_common.cuh"
#include "flash_wgmma.cuh"

namespace flash_bwd {

using wgmma_fa::cp_async4;
using wgmma_fa::cp_async_commit;
using wgmma_fa::cp_async_wait;
using wgmma_fa::fence_proxy_async;
using wgmma_fa::fence_regs;
using wgmma_fa::kKeys;
using wgmma_fa::kMaskWords;
using wgmma_fa::kMaxKeys;
using wgmma_fa::kRows;
using wgmma_fa::kThreads;
using wgmma_fa::load_tile;
using wgmma_fa::next_tile;
using wgmma_fa::pack_bf16;
using wgmma_fa::smem_u32;
using wgmma_fa::sw128_desc;
using wgmma_fa::tile_bytes;
using wgmma_fa::wg_commit;
using wgmma_fa::wg_fence;
using wgmma_fa::wg_wait0;
using wgmma_fa::wgmma_rs_tb;
using wgmma_fa::wgmma_ss;

constexpr int kMaxHeadDim = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // in elements, (batch, seq, head) of each tensor; hd is contiguous
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, db, ds, dh;  // d = dO
  long long dqb, dqs, dqh, dkb, dks, dkh, dvb, dvs, dvh;
};

constexpr size_t smem_bytes(int nb) {
  // 6 tiles; lse, delta and positions of 64 queries a stage (dkdv) or key
  // positions a stage (dq); the skip bits; 1 KB to align the tiles
  return 6 * tile_bytes(nb) + 2 * 3 * kRows * sizeof(float) + kMaskWords * sizeof(uint32_t) +
         1024;
}

// Whether some key at a position in [kp_lo, kp_hi] can be visible to a query
// at qp: the test that skips a query tile for a block of keys.
__device__ __forceinline__ bool sees_range(int qp, int kp_lo, int kp_hi, int causal, int window) {
  return (!causal || kp_lo <= qp) && (window <= 0 || qp - kp_hi < window);
}

// delta[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d], a warp a row, rows in
// (b, i, h) order so that neighbouring warps read neighbouring heads
__global__ void __launch_bounds__(256)
delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
             float* __restrict__ delta, int B, int Sq, int H, int hd, Strides st) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(B) * Sq * H) return;
  const int h = static_cast<int>(row % H);
  const int i = static_cast<int>((row / H) % Sq);
  const int b = static_cast<int>(row / (static_cast<long long>(H) * Sq));
  const __nv_bfloat16* orow = o + b * st.ob + i * st.os + h * st.oh;
  const __nv_bfloat16* drow = dout + b * st.db + i * st.ds + h * st.dh;
  float acc = 0.0f;
  for (int d = 2 * lane; d < hd; d += 64) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + d));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + d));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  acc = attn::warp_sum(acc);
  if (lane == 0) delta[(static_cast<long long>(b) * H + h) * Sq + i] = acc;
}

// the 16 bf16 A fragments of a 64 x 64 float32 accumulator (as the forward's P)
__device__ __forceinline__ void to_a_frags(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk2 = 0; kk2 < 4; ++kk2)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk2][r] = pack_bf16(x[8 * kk2 + 2 * r], x[8 * kk2 + 2 * r + 1]);
}

// two K-major products into zeroed accumulators: x = A1 B1^T, y = A2 B2^T
// over the k-steps of head_dim
template <int NB>
__device__ __forceinline__ void two_products(float (&x)[32], float (&y)[32], uint32_t a1,
                                             uint32_t b1, uint32_t a2, uint32_t b2, int ks) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = y[i] = 0.0f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    if (kk < ks) {
      const uint32_t off = (kk >> 2) * (kRows * 128) + (kk & 3) * 32;
      wgmma_ss(x, sw128_desc(a1 + off, 16), sw128_desc(b1 + off, 16));
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    if (kk < ks) {
      const uint32_t off = (kk >> 2) * (kRows * 128) + (kk & 3) * 32;
      wgmma_ss(y, sw128_desc(a2 + off, 16), sw128_desc(b2 + off, 16));
    }
  }
  wg_commit();
  wg_wait0();
  fence_regs(x);
  fence_regs(y);
}

// acc[nb] += A (registers, 64 x 64) B, B the 64 x hd tile at b_s read MN-major
template <int NB>
__device__ __forceinline__ void product_rs(float (&acc)[NB][32], const uint32_t (&a)[4][4],
                                           uint32_t b_s) {
#pragma unroll
  for (int kk2 = 0; kk2 < 4; ++kk2)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      wgmma_rs_tb(acc[nb], a[kk2], sw128_desc(b_s + nb * (kRows * 128) + kk2 * (16 * 128),
                                              kRows * 128));
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ qpos, const int* __restrict__ kvpos,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B, int Sq, int Sk,
            int H, int KH, int hd, float scale, int causal, int window, Strides st) {
  constexpr uint32_t TILE = static_cast<uint32_t>(tile_bytes(NB));
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + TILE;  // stage s: Q at (2 + 2 s), dO at (3 + 2 s)
  float* vec_s = reinterpret_cast<float*>(sm + 6 * TILE);  // (2 stages, lse | delta | qpos, 64)
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(vec_s + 2 * 3 * kRows);
  __shared__ int range_s[8];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // key tile slowest in the grid, tile 0 first: under a causal mask it sees every query tile
  const int bk = blockIdx.x % (B * KH), kt = blockIdx.x / (B * KH);
  const int b = bk / KH, kvh = bk % KH, g = H / KH;
  const int k0 = kt * kKeys, n_keys = min(kKeys, Sk - k0);
  const int* qp_b = qpos + static_cast<size_t>(b) * Sq;
  const int* kp_b = kvpos + static_cast<size_t>(b) * Sk;
  const float scale_log2 = scale * kLog2e;

  // the block's valid key positions' range, then the query tiles that can see one
  const int my_kp = tid < n_keys ? kp_b[k0 + tid] : -1;
  const int lo = __reduce_min_sync(0xffffffffu, my_kp >= 0 ? my_kp : INT_MAX);
  const int hi = __reduce_max_sync(0xffffffffu, my_kp >= 0 ? my_kp : INT_MIN);
  if (lane == 0) {
    range_s[warp] = lo;
    range_s[4 + warp] = hi;
  }
  const int n_tiles = (Sq + kRows - 1) / kRows;
  const int words = (n_tiles + 31) / 32;
  for (int i = tid; i < words; i += kThreads) mask_s[i] = 0;
  __syncthreads();
  const int kp_lo = min(min(range_s[0], range_s[1]), min(range_s[2], range_s[3]));
  const int kp_hi = max(max(range_s[4], range_s[5]), max(range_s[6], range_s[7]));
  if (kp_lo <= kp_hi) {  // else no key is valid and nothing is visible
    for (int i0 = warp * 32; i0 < Sq; i0 += kThreads) {  // 32 queries of one tile a warp
      const int i = i0 + lane;
      const bool vis = i < Sq && sees_range(qp_b[i], kp_lo, kp_hi, causal, window);
      if (__any_sync(0xffffffffu, vis) && lane == 0)
        atomicOr(&mask_s[i0 >> 11], 1u << ((i0 >> 6) & 31));
    }
  }
  __syncthreads();

  // this thread's two rows (keys) of the accumulator layout
  const int ra = warp * 16 + lane / 4, rb = ra + 8;
  const int kpa = ra < n_keys ? kp_b[k0 + ra] : -1;
  const int kpb = rb < n_keys ? kp_b[k0 + rb] : -1;
  const int quad = lane & 3;
  const int ks = (hd + 15) / 16;

  auto issue = [&](int tile, int head, int stage) {
    const int q0 = tile * kRows;
    const uint32_t q_s = base + (2 + 2 * stage) * TILE;
    load_tile(q_s, q + b * st.qb + head * st.qh + q0 * st.qs, st.qs, Sq - q0, hd, tid);
    load_tile(q_s + TILE, dout + b * st.db + head * st.dh + q0 * st.ds, st.ds, Sq - q0, hd, tid);
    if (tid < kRows) {
      const int i = q0 + tid;
      const bool ok = i < Sq;
      const size_t row = (static_cast<size_t>(b) * H + head) * Sq;
      float* vs = vec_s + stage * 3 * kRows;
      cp_async4(smem_u32(vs + tid), ok ? lse + row + i : lse, ok ? 4 : 0);
      cp_async4(smem_u32(vs + kRows + tid), ok ? delta + row + i : delta, ok ? 4 : 0);
      cp_async4(smem_u32(vs + 2 * kRows + tid), ok ? qp_b + i : qp_b, ok ? 4 : 0);
    }
  };
  // the walk: the visible query tiles, and within each the group's heads
  auto advance = [&](int& tile, int& i) {
    if (++i == g) {
      i = 0;
      tile = next_tile(mask_s, words, tile);
    }
  };

  float acc_dv[NB][32], acc_dk[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dv[nb][i] = acc_dk[nb][i] = 0.0f;

  int cur = next_tile(mask_s, words, -1), cur_i = 0;
  int nxt = cur, nxt_i = 0;
  if (cur >= 0) advance(nxt, nxt_i);
  load_tile(k_s, k + b * st.kb + kvh * st.kh + k0 * st.ks, st.ks, n_keys, hd, tid);
  load_tile(v_s, v + b * st.vb + kvh * st.vh + k0 * st.vs, st.vs, n_keys, hd, tid);
  if (cur >= 0) issue(cur, kvh * g + cur_i, 0);
  cp_async_commit();
  if (nxt >= 0) issue(nxt, kvh * g + nxt_i, 1);
  cp_async_commit();
  int stage = 0;
  while (cur >= 0) {
    cp_async_wait<1>();  // this stage (and K, V) landed; the next may be in flight
    fence_proxy_async();
    __syncthreads();
    const uint32_t q_s = base + (2 + 2 * stage) * TILE, do_s = q_s + TILE;

    // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
    float s[32], dp[32];
    two_products<NB>(s, dp, k_s, q_s, v_s, do_s, ks);

    // P^T = exp(scale S^T - lse) where visible, else 0; dS^T = P^T (dP^T - delta)
    const float* vs = vec_s + stage * 3 * kRows;
    const int* qp_s = reinterpret_cast<const int*>(vs + 2 * kRows);
    const int n_q = Sq - cur * kRows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * quad + c;
        const int qp = qp_s[col];
        const float lse2 = vs[col] * kLog2e, dl = vs[kRows + col];
        const bool ok = col < n_q;
        const float pa = ok && attn::visible(kpa, qp, causal, window)
                             ? exp2f(fmaf(s[4 * j + c], scale_log2, -lse2)) : 0.0f;
        const float pb = ok && attn::visible(kpb, qp, causal, window)
                             ? exp2f(fmaf(s[4 * j + 2 + c], scale_log2, -lse2)) : 0.0f;
        s[4 * j + c] = pa;
        s[4 * j + 2 + c] = pb;
        dp[4 * j + c] = pa * (dp[4 * j + c] - dl);
        dp[4 * j + 2 + c] = pb * (dp[4 * j + 2 + c] - dl);
      }
    }
    uint32_t pt[4][4], dst[4][4];
    to_a_frags(s, pt);
    to_a_frags(dp, dst);

    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(acc_dv[nb]);
      fence_regs(acc_dk[nb]);
    }
    wg_fence();
    product_rs<NB>(acc_dv, pt, do_s);
    product_rs<NB>(acc_dk, dst, q_s);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(acc_dv[nb]);
      fence_regs(acc_dk[nb]);
    }
    __syncthreads();  // every warp is done with this stage

    int after = nxt, after_i = nxt_i;
    if (after >= 0) advance(after, after_i);
    if (after >= 0) issue(after, kvh * g + after_i, stage);
    cp_async_commit();
    cur = nxt;
    cur_i = nxt_i;
    nxt = after;
    nxt_i = after_i;
    stage ^= 1;
  }
  cp_async_wait<0>();

  __nv_bfloat16* dkb = dk + b * st.dkb + kvh * st.dkh;
  __nv_bfloat16* dvb = dv + b * st.dvb + kvh * st.dvh;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * 64 + 8 * j + 2 * quad;
      if (col >= hd) continue;
      if (ra < n_keys) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + (k0 + ra) * st.dks + col) =
            __floats2bfloat162_rn(acc_dk[nb][4 * j] * scale, acc_dk[nb][4 * j + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + (k0 + ra) * st.dvs + col) =
            __floats2bfloat162_rn(acc_dv[nb][4 * j], acc_dv[nb][4 * j + 1]);
      }
      if (rb < n_keys) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + (k0 + rb) * st.dks + col) =
            __floats2bfloat162_rn(acc_dk[nb][4 * j + 2] * scale, acc_dk[nb][4 * j + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + (k0 + rb) * st.dvs + col) =
            __floats2bfloat162_rn(acc_dv[nb][4 * j + 2], acc_dv[nb][4 * j + 3]);
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ qpos, const int* __restrict__ kvpos,
          __nv_bfloat16* __restrict__ dq, int B, int Sq, int Sk, int H, int KH, int hd,
          float scale, int causal, int window, Strides st) {
  constexpr uint32_t TILE = static_cast<uint32_t>(tile_bytes(NB));
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + TILE;  // stage s: K at (2 + 2 s), V at (3 + 2 s)
  int* kp_s = reinterpret_cast<int*>(sm + 6 * TILE);                 // (2, kKeys)
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(kp_s + 2 * 3 * kRows);
  __shared__ int range_s[8];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // query tile slowest in the grid, the last first: under a causal mask it sees every key tile
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int bh = blockIdx.x % (B * H), qt = n_qt - 1 - static_cast<int>(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H, kvh = h / (H / KH);
  const int q0 = qt * kRows, n_rows = min(kRows, Sq - q0);
  const __nv_bfloat16* kb = k + b * st.kb + kvh * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + kvh * st.vh;
  const int* qp_b = qpos + static_cast<size_t>(b) * Sq;
  const int* kp_b = kvpos + static_cast<size_t>(b) * Sk;
  const float scale_log2 = scale * kLog2e;

  // the block's position range, then the key tiles that hold a key visible to it
  const int my_qp = tid < n_rows ? qp_b[q0 + tid] : 0;
  const int lo = __reduce_min_sync(0xffffffffu, tid < n_rows ? my_qp : INT_MAX);
  const int hi = __reduce_max_sync(0xffffffffu, tid < n_rows ? my_qp : INT_MIN);
  if (lane == 0) {
    range_s[warp] = lo;
    range_s[4 + warp] = hi;
  }
  const int n_tiles = (Sk + kKeys - 1) / kKeys;
  const int words = (n_tiles + 31) / 32;
  for (int i = tid; i < words; i += kThreads) mask_s[i] = 0;
  __syncthreads();
  const int q_lo = min(min(range_s[0], range_s[1]), min(range_s[2], range_s[3]));
  const int q_hi = max(max(range_s[4], range_s[5]), max(range_s[6], range_s[7]));
  for (int j0 = warp * 32; j0 < Sk; j0 += kThreads) {  // 32 keys of one tile a warp
    const int j = j0 + lane;
    const bool vis = j < Sk && attn::visible_to_range(kp_b[j], q_lo, q_hi, causal, window);
    if (__any_sync(0xffffffffu, vis) && lane == 0)
      atomicOr(&mask_s[j0 >> 11], 1u << ((j0 >> 6) & 31));
  }
  __syncthreads();

  // this thread's two rows (queries): positions, lse in log2 units, delta
  const int ra = warp * 16 + lane / 4, rb = ra + 8;
  const bool oka = ra < n_rows, okb = rb < n_rows;
  const size_t row = (static_cast<size_t>(b) * H + h) * Sq + q0;
  const int qpa = oka ? qp_b[q0 + ra] : 0, qpb = okb ? qp_b[q0 + rb] : 0;
  const float lse_a = oka ? lse[row + ra] * kLog2e : 0.0f;
  const float lse_b = okb ? lse[row + rb] * kLog2e : 0.0f;
  const float dl_a = oka ? delta[row + ra] : 0.0f, dl_b = okb ? delta[row + rb] : 0.0f;
  const int quad = lane & 3;
  const int ks = (hd + 15) / 16;

  auto issue = [&](int tile, int stage) {
    const int j0 = tile * kKeys;
    const uint32_t k_s = base + (2 + 2 * stage) * TILE;
    load_tile(k_s, kb + j0 * st.ks, st.ks, Sk - j0, hd, tid);
    load_tile(k_s + TILE, vb + j0 * st.vs, st.vs, Sk - j0, hd, tid);
    if (tid < kKeys) {
      const int j = j0 + tid;
      cp_async4(smem_u32(kp_s + stage * kKeys + tid), j < Sk ? kp_b + j : kp_b, j < Sk ? 4 : 0);
    }
  };

  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.0f;

  int cur = next_tile(mask_s, words, -1);
  int nxt = cur >= 0 ? next_tile(mask_s, words, cur) : -1;
  load_tile(q_s, q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, n_rows, hd, tid);
  load_tile(do_s, dout + b * st.db + h * st.dh + q0 * st.ds, st.ds, n_rows, hd, tid);
  if (cur >= 0) issue(cur, 0);
  cp_async_commit();
  if (nxt >= 0) issue(nxt, 1);
  cp_async_commit();
  int stage = 0;
  while (cur >= 0) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t k_s = base + (2 + 2 * stage) * TILE, v_s = k_s + TILE;

    // S = Q K^T and dP = dO V^T: rows queries, columns keys
    float s[32], dp[32];
    two_products<NB>(s, dp, q_s, k_s, do_s, v_s, ks);

    const int* kp = kp_s + stage * kKeys;
    const int key0 = cur * kKeys;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * quad + c;
        const int kpv = kp[col];
        const bool in_range = key0 + col < Sk;
        const float pa = oka && in_range && attn::visible(kpv, qpa, causal, window)
                             ? exp2f(fmaf(s[4 * j + c], scale_log2, -lse_a)) : 0.0f;
        const float pb = okb && in_range && attn::visible(kpv, qpb, causal, window)
                             ? exp2f(fmaf(s[4 * j + 2 + c], scale_log2, -lse_b)) : 0.0f;
        dp[4 * j + c] = pa * (dp[4 * j + c] - dl_a);
        dp[4 * j + 2 + c] = pb * (dp[4 * j + 2 + c] - dl_b);
      }
    }
    uint32_t dsa[4][4];
    to_a_frags(dp, dsa);

    // dQ += dS K
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    wg_fence();
    product_rs<NB>(acc, dsa, k_s);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    __syncthreads();

    const int after = nxt >= 0 ? next_tile(mask_s, words, nxt) : -1;
    if (after >= 0) issue(after, stage);
    cp_async_commit();
    cur = nxt;
    nxt = after;
    stage ^= 1;
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqb = dq + b * st.dqb + h * st.dqh;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * 64 + 8 * j + 2 * quad;
      if (col >= hd) continue;
      if (oka)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (q0 + ra) * st.dqs + col) =
            __floats2bfloat162_rn(acc[nb][4 * j] * scale, acc[nb][4 * j + 1] * scale);
      if (okb)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (q0 + rb) * st.dqs + col) =
            __floats2bfloat162_rn(acc[nb][4 * j + 2] * scale, acc[nb][4 * j + 3] * scale);
    }
  }
}

template <int NB>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, const void* qpos, const void* kvpos, void* dq, void* dk, void* dv,
           void* delta, const long long* dims, const Strides& st, float scale, int causal,
           int window, cudaStream_t stream) {
  const int B = static_cast<int>(dims[0]), Sq = static_cast<int>(dims[1]);
  const int Sk = static_cast<int>(dims[2]), H = static_cast<int>(dims[3]);
  const int KH = static_cast<int>(dims[4]), hd = static_cast<int>(dims[5]);
  using bf = __nv_bfloat16;
  const bf *q_ = static_cast<const bf*>(q), *k_ = static_cast<const bf*>(k);
  const bf *v_ = static_cast<const bf*>(v), *do_ = static_cast<const bf*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  const int *qp = static_cast<const int*>(qpos), *kp = static_cast<const int*>(kvpos);
  constexpr size_t bytes = smem_bytes(NB);
  static bool dkdv_set = false, dq_set = false;
  cudaError_t err = attn::allow_smem(dkdv_kernel<NB>, bytes, dkdv_set);
  if (err == cudaSuccess) err = attn::allow_smem(dq_kernel<NB>, bytes, dq_set);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long rows = static_cast<long long>(B) * Sq * H;
  delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf*>(o), do_, delta_, B, Sq, H, hd, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const unsigned n_kv = static_cast<unsigned>((Sk + kKeys - 1) / kKeys) * B * KH;
  dkdv_kernel<NB><<<n_kv, kThreads, bytes, stream>>>(q_, k_, v_, do_, lse_, delta_, qp, kp,
                                                     static_cast<bf*>(dk), static_cast<bf*>(dv),
                                                     B, Sq, Sk, H, KH, hd, scale, causal,
                                                     window, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const unsigned n_q = static_cast<unsigned>((Sq + kRows - 1) / kRows) * B * H;
  dq_kernel<NB><<<n_q, kThreads, bytes, stream>>>(q_, k_, v_, do_, lse_, delta_, qp, kp,
                                                  static_cast<bf*>(dq), B, Sq, Sk, H, KH, hd,
                                                  scale, causal, window, st);
  return static_cast<int>(cudaGetLastError());
}

inline int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const void* lse, const void* qpos, const void* kvpos, void* dq, void* dk,
                    void* dv, void* delta, const long long* dims, const Strides& st, float scale,
                    int causal, int window, cudaStream_t s) {
  const long long hd = dims[5];
  if (dims[1] > kMaxKeys || dims[2] > kMaxKeys || hd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64)
    return launch<1>(q, k, v, o, dout, lse, qpos, kvpos, dq, dk, dv, delta, dims, st, scale,
                     causal, window, s);
  if (hd <= kMaxHeadDim)
    return launch<2>(q, k, v, o, dout, lse, qpos, kvpos, dq, dk, dv, delta, dims, st, scale,
                     causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash_bwd
