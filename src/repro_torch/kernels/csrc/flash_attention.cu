// Flash attention on Hopper (sm_90a): three forward kernels behind one
// contract (attention_common.cuh), chosen by the wrapper
// (repro_torch/kernels/flash_attention.py::route) for each call:
//
// * flash_splitkv.cuh -- decode: few query rows per kv head (Sq * g <= 16)
//   against a long cache; split-KV, one block per kv group, float32 and bf16;
// * flash_wgmma.cuh -- bf16 prefill on the tensor cores (wgmma);
// * simt_kernel below -- float32 prefill, and any call whose rows are not
//   16-byte aligned (the other two read 16-byte vectors).
//
// All three replace the Pallas TPU kernel
// repro/kernels/flash_attention.py::_kernel (entry flash_attention_fwd),
// whose grid runs (batch, head, q tile) in parallel and walks KV tiles along a
// sequential 4th dimension with m, l and acc in VMEM scratch.  Each wrapper
// call launches exactly one of them.  The backward of a bf16 call that took
// the wgmma kernel is flash_bwd.cuh's (three launches, flash_attention_bwd).
//
// simt_kernel: float32 prefill stays on the CUDA cores.  wgmma takes no
// float32 inputs, and TF32 (10-bit mantissa) would break the float32
// tolerance of 2e-5 and the full-width float32 cache check that the port is
// held to, so it runs on FMA at 67 TFLOP/s, far under the bf16 tensor-core
// bound.  A block owns (b, h, 16-row q tile) and loops over KV tiles: 4 warps,
// 4 query rows a warp, KV tiles of 32 keys staged in shared memory as float32
// (K transposed with a padded row (33) so that lane j reads key j
// conflict-free, V row-major).  Lane j scores key j of the tile for its warp's
// 4 rows; warp shuffles give the tile max and sum; each lane then owns
// head-dim elements lane, lane + 32, ... of acc and takes p_j from lane j by
// shuffle.  Before a tile is loaded the block checks (__syncthreads_or)
// whether any key can be visible to any of its rows and skips it if none can:
// the causal / window tile skip, decided from the positions themselves.
// head_dim up to 256 needs 81 KB of shared memory, so it is dynamic.
#include <math.h>
#include <string.h>

#include "attention_common.cuh"
#include "flash_bwd.cuh"
#include "flash_splitkv.cuh"
#include "flash_wgmma.cuh"

namespace {

using attn::from_f32;
using attn::kNegInf;
using attn::Strides;
using attn::to_f32;
using attn::warp_max;
using attn::warp_sum;

constexpr int kWarps = 4;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kBK = 32;                  // keys per KV tile (one per lane)
constexpr int kThreads = kWarps * 32;

constexpr size_t smem_bytes(int nc) {
  // q tile (kBQ, HDP) + K^T tile (HDP, kBK + 1) + V tile (kBK, HDP), float32,
  // then kBK int32 key positions
  return (static_cast<size_t>(kBQ) * 32 * nc + static_cast<size_t>(32 * nc) * (kBK + 1) +
          static_cast<size_t>(kBK) * 32 * nc) * sizeof(float) + kBK * sizeof(int);
}

// NC = head-dim chunks of 32: HDP = 32 * NC >= hd, the tail zero-filled
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ qpos, const int* __restrict__ kvpos, T* __restrict__ o, int Sq,
            int Sk, int H, int KH, int hd, float scale, int causal, int window, Strides st) {
  constexpr int HDP = 32 * NC;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                       // (kBQ, HDP)
  float* kt_s = q_s + kBQ * HDP;           // (HDP, kBK + 1): K transposed
  float* v_s = kt_s + HDP * (kBK + 1);     // (kBK, HDP)
  int* kp_s = reinterpret_cast<int*>(v_s + kBK * HDP);  // (kBK,)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int n_rows = min(kBQ, Sq - q0);

  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;
  const int* qp_b = qpos + static_cast<size_t>(b) * Sq;
  const int* kp_b = kvpos + static_cast<size_t>(b) * Sk;

  for (int idx = tid; idx < kBQ * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx % HDP;
    q_s[idx] = (r < n_rows && d < hd) ? to_f32(qb[(q0 + r) * st.qs + d]) : 0.0f;
  }
  // the block's position range, for the tile skip
  int q_lo = INT_MAX, q_hi = INT_MIN;
  for (int r = 0; r < n_rows; ++r) {
    q_lo = min(q_lo, qp_b[q0 + r]);
    q_hi = max(q_hi, qp_b[q0 + r]);
  }
  // this warp's rows and their positions
  const int r0 = warp * kRows;
  const bool warp_active = r0 < n_rows;
  int my_qp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) my_qp[r] = r0 + r < n_rows ? qp_b[q0 + r0 + r] : 0;

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    int relevant = 0;
    if (tid < kBK) {
      const int j = k0 + tid;
      const int p = j < Sk ? kp_b[j] : -1;
      kp_s[tid] = p;
      relevant = p >= 0 && (!causal || p <= q_hi) && (window <= 0 || q_lo - p < window);
    }
    if (!__syncthreads_or(relevant)) continue;  // no key of this tile is visible to any row

    for (int idx = tid; idx < kBK * HDP; idx += kThreads) {
      const int j = idx / HDP, d = idx % HDP;
      const bool ok = k0 + j < Sk && d < hd;
      kt_s[d * (kBK + 1) + j] = ok ? to_f32(kb[(k0 + j) * st.ks + d]) : 0.0f;
      v_s[idx] = ok ? to_f32(vb[(k0 + j) * st.vs + d]) : 0.0f;
    }
    __syncthreads();

    if (warp_active) {
      // lane = key j of the tile: raw scores of this warp's rows
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
#pragma unroll 4
      for (int d4 = 0; d4 < HDP / 4; ++d4) {
        float4 qv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) qv[r] = reinterpret_cast<const float4*>(q_s + (r0 + r) * HDP)[d4];
        const float* kcol = kt_s + 4 * d4 * (kBK + 1) + lane;
        const float k0v = kcol[0], k1v = kcol[kBK + 1], k2v = kcol[2 * (kBK + 1)],
                    k3v = kcol[3 * (kBK + 1)];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          s[r] = fmaf(qv[r].x, k0v, s[r]);
          s[r] = fmaf(qv[r].y, k1v, s[r]);
          s[r] = fmaf(qv[r].z, k2v, s[r]);
          s[r] = fmaf(qv[r].w, k3v, s[r]);
        }
      }
      // online softmax update, row by row
      const int kp = kp_s[lane];
      const bool in_range = k0 + lane < Sk;
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool visible = kp >= 0 && (!causal || kp <= my_qp[r]) &&
                             (window <= 0 || my_qp[r] - kp < window);
        const float sr = visible ? s[r] * scale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(in_range ? sr : -INFINITY));
        const float alpha = expf(m[r] - m_new);
        p[r] = in_range ? expf(sr - m_new) : 0.0f;
        l[r] = l[r] * alpha + warp_sum(p[r]);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      }
      // acc += p @ V: lane owns head-dim elements lane + 32 c, p_j comes from lane j
      for (int j = 0; j < kBK; ++j) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = v_s[j * HDP + c * 32 + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

  if (!warp_active) return;
  T* ob = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r >= n_rows) break;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = c * 32 + lane;
      if (d < hd) ob[(q0 + r0 + r) * st.os + d] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const void* qpos, const void* kvpos,
           void* o, const long long* dims, const Strides& st, float scale, int causal,
           int window, cudaStream_t stream) {
  const int B = static_cast<int>(dims[0]), Sq = static_cast<int>(dims[1]);
  const int Sk = static_cast<int>(dims[2]), H = static_cast<int>(dims[3]);
  const int KH = static_cast<int>(dims[4]), hd = static_cast<int>(dims[5]);
  constexpr size_t bytes = smem_bytes(NC);
  static bool attr_set = false;  // once per instantiation, on the calling thread's device
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(simt_kernel<T, NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  simt_kernel<T, NC><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(qpos), static_cast<const int*>(kvpos), static_cast<T*>(o), Sq, Sk,
      H, KH, hd, scale, causal, window, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* qpos, const void* kvpos,
             void* o, const long long* dims, const Strides& st, float scale, int causal,
             int window, cudaStream_t stream) {
  const long long hd = dims[5];
  if (hd <= 32) return launch<T, 1>(q, k, v, qpos, kvpos, o, dims, st, scale, causal, window, stream);
  if (hd <= 64) return launch<T, 2>(q, k, v, qpos, kvpos, o, dims, st, scale, causal, window, stream);
  if (hd <= 128) return launch<T, 4>(q, k, v, qpos, kvpos, o, dims, st, scale, causal, window, stream);
  if (hd <= 256) return launch<T, 8>(q, k, v, qpos, kvpos, o, dims, st, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

namespace {

bool read_dims(const long long* dims, const long long* strides, Strides* st) {
  for (int i = 0; i < 6; ++i)
    if (dims[i] < 1 || dims[i] > 2147483647LL) return false;
  if (dims[3] % dims[4] != 0 || dims[3] > 65535 || dims[4] > 65535 || dims[0] > 65535)
    return false;
  *st = Strides{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
                strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  return true;
}

}  // namespace

// Common arguments: dims = (B, Sq, Sk, H, KH, hd); strides = 12 element
// strides (batch, seq, head) of q, k, v, o in that order; window <= 0 means
// none; dtype code 0 = float32, 1 = bfloat16 (q, k, v and o share it).

// The CUDA-core kernel: any shape, any strides (hd contiguous).
extern "C" int flash_attention_simt(const void* q, const void* k, const void* v, const void* qpos,
                                    const void* kvpos, void* o, const long long* dims,
                                    const long long* strides, float scale, int causal, int window,
                                    int dtype, void* stream) {
  Strides st;
  if (!read_dims(dims, strides, &st)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, qpos, kvpos, o, dims, st, scale, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, qpos, kvpos, o, dims, st, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split-KV decode kernel: Sq * (H / KH) <= 16, rows 16-byte aligned;
// part = float32 scratch of B * KH * n_split * rows * (2 + hd) values with
// rows = 8 if Sq * (H / KH) <= 8 else 16; tickets = B * KH int32 zeros,
// returned to zero by the kernel; chunk = slots a split, n_split =
// ceil(Sk / chunk) <= 256.
extern "C" int flash_attention_splitkv(const void* q, const void* k, const void* v,
                                       const void* qpos, const void* kvpos, void* o, void* part,
                                       void* tickets, const long long* dims,
                                       const long long* strides, float scale, int causal,
                                       int window, int n_split, int chunk, int dtype,
                                       void* stream) {
  Strides st;
  if (!read_dims(dims, strides, &st)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_split < 1 || n_split > splitkv::kMaxSplits || chunk < 1 ||
      static_cast<long long>(n_split - 1) * chunk >= dims[2] ||
      static_cast<long long>(n_split) * chunk < dims[2])
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return splitkv::dispatch<float>(q, k, v, qpos, kvpos, o, part, tickets, dims, st, scale,
                                    causal, window, n_split, chunk, s);
  if (dtype == 1)
    return splitkv::dispatch<__nv_bfloat16>(q, k, v, qpos, kvpos, o, part, tickets, dims, st,
                                            scale, causal, window, n_split, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma prefill kernel: bfloat16 only, hd % 8 == 0, rows 16-byte
// aligned, Sk <= 131072; lse = null, or float32 (B, H, Sq) contiguous for
// the rows' log-sum-exp.
extern "C" int flash_attention_wgmma(const void* q, const void* k, const void* v,
                                     const void* qpos, const void* kvpos, void* o, void* lse,
                                     const long long* dims, const long long* strides,
                                     float scale, int causal, int window, void* stream) {
  Strides st;
  if (!read_dims(dims, strides, &st)) return static_cast<int>(cudaErrorInvalidValue);
  return wgmma_fa::dispatch(q, k, v, qpos, kvpos, o, static_cast<float*>(lse), dims, st, scale,
                            causal, window, static_cast<cudaStream_t>(stream));
}

// The backward of a wgmma call: bfloat16 only, hd % 8 == 0 and <= 128, rows
// 16-byte aligned, Sq and Sk <= 131072.  strides = 24 element strides
// (batch, seq, head) of q, k, v, o, dO, dq, dk, dv in that order; lse the
// forward's (B, H, Sq) float32; delta float32 scratch of B * H * Sq values.
// Three launches on the stream: delta, then dK and dV, then dQ.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, const void* qpos,
                                   const void* kvpos, void* dq, void* dk, void* dv, void* delta,
                                   const long long* dims, const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  Strides fwd;
  if (!read_dims(dims, strides, &fwd)) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd::Strides st;
  static_assert(sizeof(st) == 24 * sizeof(long long), "24 strides");
  memcpy(&st, strides, sizeof(st));
  return flash_bwd::dispatch(q, k, v, o, dout, lse, qpos, kvpos, dq, dk, dv, delta, dims, st,
                             scale, causal, window, static_cast<cudaStream_t>(stream));
}
