// Prefill attention on Hopper's tensor cores (sm_90a, bfloat16): S = Q K^T and
// O += P V as warpgroup matrix multiplies (wgmma), online softmax in float32
// registers.
//
// Replaces, for bf16 prefill, the Pallas TPU kernel
// repro/kernels/flash_attention.py::_kernel (entry flash_attention_fwd): the
// TPU's grid walks KV tiles in order with m, l and acc in VMEM; here a block
// owns (b, head, 64 query rows) and a loop over KV tiles takes the place of
// that sequential dimension.
//
// Bound on this card: operations.  A qwen2-1.5b prefill (1024 tokens, 12
// heads of 128, causal) is 3.2 GFLOP over 6.8 MB of q, k, v and o, about 470
// flops per byte, above the card's bf16 balance of ~295; the tensor cores'
// 989 TFLOP/s put it at 3.3 us, the CUDA cores' 67 TFLOP/s at 48 us.
//
// Design.  One warpgroup (128 threads) per block and 64 query rows per
// warpgroup.  Q (64 x hd) and the K and V tiles (64 keys x hd) live in shared
// memory in the layout wgmma reads with 128-byte swizzle: each 64-column
// block of a tile is 64 rows of 128 bytes, the 16-byte chunk c of row r at
// chunk c ^ (r % 8), 8-row groups 1024 bytes apart, every block 1024-byte
// aligned.  S = Q K^T is hd / 16 wgmma.m64n64k16 with Q and K both K-major
// (head_dim contiguous); the 64 x 64 float32 scores land in registers in the
// accumulator layout (row warp * 16 + lane / 4 (+ 8), columns 8 j + 2 (lane %
// 4) + {0, 1}), where the positions mask, NEG_INF and the online softmax run
// with the row max and sum over the 4 lanes of a quad.  P is rounded to bf16
// in registers, and the accumulator layout is wgmma's A-from-registers layout,
// so P never touches shared memory; O += P V is 4 x ceil(hd / 64)
// wgmma.m64n64k16 with V as an MN-major B operand (transpose bit set, which
// 16-bit types allow), read from the same layout as K.  K / V tiles fill a
// ring of 2 stages by cp.async (16 bytes a thread, zero-filled past Sk)
// issued one tile ahead, so the next tile's loads overlap this tile's
// products.  The tile skip is decided from positions before the loop: a tile
// none of whose keys is visible to any row of the block is never loaded.
// head_dim pads to a multiple of 16 (k-steps of S) and to 64 in shared memory
// (the P V column blocks; columns past hd are computed and never stored).
// Shared memory is 5 tiles: 80 KB at hd 128 (two blocks an SM), 160 KB at
// hd 256.  Given an lse pointer (training: the backward, flash_bwd.cuh, reads
// it), the kernel also writes each row's log-sum-exp m + log(l) of the scaled
// scores in float32, (B, H, Sq); given null (serving) it writes nothing more.
#pragma once

#include <stdint.h>

#include "attention_common.cuh"

namespace wgmma_fa {

using attn::kNegInf;
using attn::Strides;

constexpr int kThreads = 128;      // one warpgroup
constexpr int kRows = 64;          // query rows a block
constexpr int kKeys = 64;          // keys a KV tile
constexpr int kMaskWords = 64;     // tile-skip bits: Sk <= 64 * 32 * kMaskWords
constexpr int kMaxKeys = kKeys * 32 * kMaskWords;

__host__ __device__ constexpr size_t tile_bytes(int nb) {
  return static_cast<size_t>(nb) * kRows * 128;
}
constexpr size_t smem_bytes(int nb) {
  // Q, K x 2 stages, V x 2 stages; key positions (2, 64); the skip bits; and
  // 1 KB to align the tiles to 1024 bytes
  return 5 * tile_bytes(nb) + 2 * kKeys * sizeof(int) + kMaskWords * sizeof(uint32_t) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (the stride of 64-column blocks for MN-major; unused K-major),
// stride byte offset 1024 (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's generic-proxy writes to shared memory visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across a wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT32(d)                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) += A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32 ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 64 rows of hd bf16 values (row r at base + r * row_stride) into the
// swizzled layout at dst; rows >= n_valid and chunks past hd read as zeros.
// Chunks are copied up to the last k-step (hd rounded up to 16).
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* base,
                                          long long row_stride, int n_valid, int hd, int tid) {
  const int cpr = ((hd + 15) / 16) * 2;
  for (int idx = tid; idx < kRows * cpr; idx += kThreads) {
    const int r = idx / cpr, c = idx % cpr;
    const bool ok = r < n_valid && c * 8 < hd;
    const uint32_t off = (c >> 3) * (kRows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    cp_async16(dst + off, ok ? base + r * row_stride + c * 8 : base, ok ? 16 : 0);
  }
}

__device__ __forceinline__ int next_tile(const uint32_t* mask, int words, int after) {
  const int t = after + 1;
  for (int w = t >> 5; w < words; ++w) {
    uint32_t bits = mask[w];
    if (w == (t >> 5)) bits &= ~0u << (t & 31);
    if (bits) return (w << 5) + __ffs(bits) - 1;
  }
  return -1;
}

// NB = 64-column blocks of head_dim (hd <= 64 * NB)
template <int NB>
__global__ void __launch_bounds__(kThreads)
wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
             const int* __restrict__ kvpos, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int H, int KH, int hd, float scale,
             int causal, int window, Strides st) {
  constexpr uint32_t TILE = static_cast<uint32_t>(tile_bytes(NB));
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t q_s = base, k_s = base + TILE, v_s = base + 3 * TILE;  // stage s: + s * TILE
  int* kp_s = reinterpret_cast<int*>(sm + 5 * TILE);                   // (2, kKeys)
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(kp_s + 2 * kKeys);    // (kMaskWords,)
  __shared__ int range_s[8];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the last q tiles first: under a causal mask they walk the most KV tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int n_rows = min(kRows, Sq - q0);
  const __nv_bfloat16* qb = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kb = k + b * st.kb + kvh * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + kvh * st.vh;
  const int* qp_b = qpos + static_cast<size_t>(b) * Sq;
  const int* kp_b = kvpos + static_cast<size_t>(b) * Sk;
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)

  // the block's position range, then the tiles that hold a key visible to it
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

  // this thread's two rows of the accumulator layout
  const int ra = warp * 16 + lane / 4, rb = ra + 8;
  const int qpa = ra < n_rows ? qp_b[q0 + ra] : 0;
  const int qpb = rb < n_rows ? qp_b[q0 + rb] : 0;
  const int quad = lane & 3;
  const int ks = (hd + 15) / 16;

  auto issue = [&](int tile, int stage) {
    const int j0 = tile * kKeys;
    load_tile(k_s + stage * TILE, kb + j0 * st.ks, st.ks, Sk - j0, hd, tid);
    load_tile(v_s + stage * TILE, vb + j0 * st.vs, st.vs, Sk - j0, hd, tid);
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
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  int cur = next_tile(mask_s, words, -1);
  int nxt = cur >= 0 ? next_tile(mask_s, words, cur) : -1;
  load_tile(q_s, qb + q0 * st.qs, st.qs, n_rows, hd, tid);
  if (cur >= 0) issue(cur, 0);
  cp_async_commit();
  if (nxt >= 0) issue(nxt, 1);
  cp_async_commit();
  int stage = 0;
  while (cur >= 0) {
    cp_async_wait<1>();  // this tile (and Q) landed; the next may be in flight
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      if (kk < ks) {
        const uint32_t off = (kk >> 2) * (kRows * 128) + (kk & 3) * 32;
        wgmma_ss(s, sw128_desc(q_s + off, 16), sw128_desc(k_s + stage * TILE + off, 16));
      }
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // mask, then the online softmax of rows ra (s[4j + c]) and rb (s[4j + 2 + c])
    const int* kp = kp_s + stage * kKeys;
    const int key0 = cur * kKeys;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * quad + c;
        const bool in_range = key0 + col < Sk;
        const int kpv = kp[col];
        const float xa =
            attn::visible(kpv, qpa, causal, window) ? s[4 * j + c] * scale_log2 : kNegInf;
        const float xb =
            attn::visible(kpv, qpb, causal, window) ? s[4 * j + 2 + c] * scale_log2 : kNegInf;
        s[4 * j + c] = in_range ? xa : -INFINITY;
        s[4 * j + 2 + c] = in_range ? xb : -INFINITY;
        mx_a = fmaxf(mx_a, s[4 * j + c]);
        mx_b = fmaxf(mx_b, s[4 * j + 2 + c]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[4 * j + c] = exp2f(s[4 * j + c] - mn_a);  // -inf (past Sk) gives 0
        s[4 * j + 2 + c] = exp2f(s[4 * j + 2 + c] - mn_b);
        sum_a += s[4 * j + c];
        sum_b += s[4 * j + 2 + c];
      }
    }
    l_a = l_a * alpha_a + sum_a;  // this thread's share; the quad's sum at the end
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[nb][4 * j] *= alpha_a;
        acc[nb][4 * j + 1] *= alpha_a;
        acc[nb][4 * j + 2] *= alpha_b;
        acc[nb][4 * j + 3] *= alpha_b;
      }
    }
    // P as wgmma's A fragments: keys 16 kk2 .. 16 kk2 + 15 are s[8 kk2 .. 8 kk2 + 7]
    uint32_t pa[4][4];
#pragma unroll
    for (int kk2 = 0; kk2 < 4; ++kk2)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk2][r] = pack_bf16(s[8 * kk2 + 2 * r], s[8 * kk2 + 2 * r + 1]);

    // O += P V
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    wg_fence();
#pragma unroll
    for (int kk2 = 0; kk2 < 4; ++kk2) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint32_t addr = v_s + stage * TILE + nb * (kRows * 128) + kk2 * (16 * 128);
        wgmma_rs_tb(acc[nb], pa[kk2], sw128_desc(addr, kRows * 128));
      }
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    __syncthreads();  // every warp is done with this stage

    const int after = nxt >= 0 ? next_tile(mask_s, words, nxt) : -1;
    if (after >= 0) issue(after, stage);
    cp_async_commit();
    cur = nxt;
    nxt = after;
    stage ^= 1;
  }
  cp_async_wait<0>();

  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  if (lse != nullptr && quad == 0) {  // m is in log2 units of the scaled score
    float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq + q0;
    if (ra < n_rows) lb[ra] = (m_a + log2f(den_a)) * 0.6931471805599453f;
    if (rb < n_rows) lb[rb] = (m_b + log2f(den_b)) * 0.6931471805599453f;
  }
  __nv_bfloat16* ob = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * 64 + 8 * j + 2 * quad;
      if (col >= hd) continue;
      if (ra < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(ob + (q0 + ra) * st.os + col) =
            __floats2bfloat162_rn(acc[nb][4 * j] / den_a, acc[nb][4 * j + 1] / den_a);
      if (rb < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(ob + (q0 + rb) * st.os + col) =
            __floats2bfloat162_rn(acc[nb][4 * j + 2] / den_b, acc[nb][4 * j + 3] / den_b);
    }
  }
}

#undef WG_D32
#undef WG_OUT32

template <int NB>
int launch(const void* q, const void* k, const void* v, const void* qpos, const void* kvpos,
           void* o, float* lse, const long long* dims, const Strides& st, float scale, int causal,
           int window, cudaStream_t stream) {
  const int B = static_cast<int>(dims[0]), Sq = static_cast<int>(dims[1]);
  const int Sk = static_cast<int>(dims[2]), H = static_cast<int>(dims[3]);
  const int KH = static_cast<int>(dims[4]), hd = static_cast<int>(dims[5]);
  constexpr size_t bytes = smem_bytes(NB);
  static bool attr_set = false;
  cudaError_t err = attn::allow_smem(wgmma_kernel<NB>, bytes, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  wgmma_kernel<NB><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, KH, hd,
      scale, causal, window, st);
  return static_cast<int>(cudaGetLastError());
}

inline int dispatch(const void* q, const void* k, const void* v, const void* qpos,
                    const void* kvpos, void* o, float* lse, const long long* dims,
                    const Strides& st, float scale, int causal, int window, cudaStream_t s) {
  const long long hd = dims[5];
  if (dims[2] > kMaxKeys || hd % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64)
    return launch<1>(q, k, v, qpos, kvpos, o, lse, dims, st, scale, causal, window, s);
  if (hd <= 128)
    return launch<2>(q, k, v, qpos, kvpos, o, lse, dims, st, scale, causal, window, s);
  if (hd <= 192)
    return launch<3>(q, k, v, qpos, kvpos, o, lse, dims, st, scale, causal, window, s);
  if (hd <= 256)
    return launch<4>(q, k, v, qpos, kvpos, o, lse, dims, st, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wgmma_fa
