// B4: flash-attention backward, two kernels, O(S) memory.
//
// Replaces the Pallas kernels mxnet_tpu/ops/pallas/flash_attention.py:
// _bwd_dkdv_kernel (:223) and _bwd_dq_kernel (:273), launched by
// _flash_bwd_pallas (:355, :379). Same contract: q, dout (B*H, Sq, D) and
// k, v (B*H, Sk, D) in f32 or bf16; lse (the forward's) and delta =
// rowsum(dout * out) f32 (B*H, Sq); an optional per-batch valid_length vl
// (B,) clamped to Sk masks keys at or past vl; `causal` masks keys above
// the query's position. Both kernels recompute p = exp(q.k * scale - lse)
// in f32 and keep p = 0 exactly outside the mask (:205-220): a masked pair
// is skipped, never evaluated, so a row whose keys are all masked (vl = 0,
// lse about -1e30) contributes nothing. ds = p * (dp - delta) * scale with
// dp = dout.v.
//   dkdv: one block per (b*h, tile of kBK keys); dk = sum_q ds * q and
//         dv = sum_q p * dout over the streamed query tiles. Keys at or past
//         vl get zero gradients; causal runs start at the tile's first key
//         (no query above it sees the tile).
//   dq:   one block per (b*h, tile of kBQ queries); dq = sum_k ds * k over
//         the streamed key tiles, skipping tiles at or past vl and, causal,
//         tiles above the block's last query.
// delta is a PyTorch op outside the kernels, as in the JAX package (:329).
//
// Bound on the H100: the backward needs 10 * D operations per visible
// (query, key) pair (five products: q.k, dout.v, p^T dout, ds^T q, ds k).
// At the training path's shape (B=16, H=12, S=512, D=64, bf16) that is at
// most 32 GFLOP (33 us at the bf16 tensor-core rate) against at most
// 88 MB moved (26 us at 3.35 TB/s); ragged valid lengths cut both. These
// kernels compute in f32 on CUDA cores, whose 67 TFLOP/s make about
// 0.5 ms their own floor, and recompute q.k and dout.v in both kernels.
//
// Design: the TPU kernels hold a whole head's Q (dkdv) or K/V (dq) in
// VMEM; a Hopper block cannot, so each block keeps its own tile of rows in
// shared memory, one row per thread, and streams the other side through
// shared memory in small tiles that every thread reads as a broadcast.
// Per-thread rows use a stride of D + 4 floats, so the float4 reads of 32
// different rows hit 32 different banks. Each thread accumulates its f32
// gradient rows (dk and dv, or dq) in registers and writes them once, so
// nothing is summed across blocks and no atomics are needed. Head dim 64
// only; tensor cores (mma.sync / wgmma) are later work.
#include "common.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kPad = kD + 4;  // stride of per-thread rows in shared memory
constexpr int kD4 = kD / 4;
constexpr int kBK = 64;       // dkdv: keys per block, one per thread
constexpr int kTQ = 16;       // dkdv: queries per streamed tile
constexpr int kBQ = 64;       // dq: queries per block, one per thread
constexpr int kTK = 16;       // dq: keys per streamed tile

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc += a.x * b.x;
  acc += a.y * b.y;
  acc += a.z * b.z;
  acc += a.w * b.w;
  return acc;
}

__device__ __forceinline__ int kv_length(const int* vl, int bh, int H,
                                         int Sk) {
  return vl == nullptr ? Sk : min(max(vl[bh / H], 0), Sk);
}

template <typename T>
__global__ void __launch_bounds__(kBK)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ vl, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Sq, int Sk,
                      float sm_scale, int causal) {
  __shared__ __align__(16) float ks[kBK][kPad];
  __shared__ __align__(16) float vs[kBK][kPad];
  __shared__ __align__(16) float qs[kTQ][kD];
  __shared__ __align__(16) float dos[kTQ][kD];
  __shared__ float lses[kTQ];
  __shared__ float dls[kTQ];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int t = threadIdx.x;
  const int key = k0 + t;
  const int kv_len = kv_length(vl, bh, H, Sk);
  const bool live = key < kv_len;
  const long kv_base = (long)bh * Sk * kD;
  const long q_base = (long)bh * Sq * kD;

  for (int i = t; i < kBK * kD; i += kBK) {
    const int j = i / kD, d = i % kD;
    const bool in = k0 + j < Sk;
    const long off = kv_base + (long)(k0 + j) * kD + d;
    ks[j][d] = in ? mxtt_load(k, off) : 0.f;
    vs[j][d] = in ? mxtt_load(v, off) : 0.f;
  }
  float dk_acc[kD], dv_acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }
  // a tile with no key below vl has zero gradients; causal: no query
  // above the tile's first key sees any of its keys
  const int q_begin = causal ? k0 : 0;
  const int q_end = k0 < kv_len ? Sq : q_begin;
  const float4* kr = reinterpret_cast<const float4*>(ks[t]);
  const float4* vr = reinterpret_cast<const float4*>(vs[t]);
  for (int q0 = q_begin; q0 < q_end; q0 += kTQ) {
    __syncthreads();  // the previous query tile is no longer read
    for (int i = t; i < kTQ * kD; i += kBK) {
      const int r = i / kD, d = i % kD;
      const bool in = q0 + r < Sq;
      const long off = q_base + (long)(q0 + r) * kD + d;
      qs[r][d] = in ? mxtt_load(q, off) : 0.f;
      dos[r][d] = in ? mxtt_load(dout, off) : 0.f;
    }
    if (t < kTQ) {
      const bool in = q0 + t < Sq;
      lses[t] = in ? lse[(long)bh * Sq + q0 + t] : 0.f;
      dls[t] = in ? delta[(long)bh * Sq + q0 + t] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < kTQ; ++r) {
      const int row = q0 + r;
      if (row >= Sq) break;
      if (causal && key > row) continue;  // masked: p = 0 exactly
      const float4* qr = reinterpret_cast<const float4*>(qs[r]);
      const float4* dr = reinterpret_cast<const float4*>(dos[r]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kD4; ++d4) {
        s = dot4(qr[d4], kr[d4], s);
        dp = dot4(dr[d4], vr[d4], dp);
      }
      const float p = expf(s * sm_scale - lses[r]);
      const float ds = p * (dp - dls[r]) * sm_scale;
#pragma unroll
      for (int d4 = 0; d4 < kD4; ++d4) {
        const float4 qq = qr[d4];
        const float4 dd = dr[d4];
        dk_acc[4 * d4] += ds * qq.x;
        dk_acc[4 * d4 + 1] += ds * qq.y;
        dk_acc[4 * d4 + 2] += ds * qq.z;
        dk_acc[4 * d4 + 3] += ds * qq.w;
        dv_acc[4 * d4] += p * dd.x;
        dv_acc[4 * d4 + 1] += p * dd.y;
        dv_acc[4 * d4 + 2] += p * dd.z;
        dv_acc[4 * d4 + 3] += p * dd.w;
      }
    }
  }
  if (key >= Sk) return;
  const long off = kv_base + (long)key * kD;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    mxtt_store(dk, off + d, dk_acc[d]);
    mxtt_store(dv, off + d, dv_acc[d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBQ)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ vl, T* __restrict__ dq, int H,
                    int Sq, int Sk, float sm_scale, int causal) {
  __shared__ __align__(16) float qs[kBQ][kPad];
  __shared__ __align__(16) float dos[kBQ][kPad];
  __shared__ __align__(16) float ks[kTK][kD];
  __shared__ __align__(16) float vs[kTK][kD];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int t = threadIdx.x;
  const int row = q0 + t;
  const bool live = row < Sq;
  const int kv_len = kv_length(vl, bh, H, Sk);
  const long kv_base = (long)bh * Sk * kD;
  const long q_base = (long)bh * Sq * kD;

  for (int i = t; i < kBQ * kD; i += kBQ) {
    const int r = i / kD, d = i % kD;
    const bool in = q0 + r < Sq;
    const long off = q_base + (long)(q0 + r) * kD + d;
    qs[r][d] = in ? mxtt_load(q, off) : 0.f;
    dos[r][d] = in ? mxtt_load(dout, off) : 0.f;
  }
  const float my_lse = live ? lse[(long)bh * Sq + row] : 0.f;
  const float my_dl = live ? delta[(long)bh * Sq + row] : 0.f;
  float dq_acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) dq_acc[d] = 0.f;
  // keys at or past k_end are masked for every row of the block
  int k_end = kv_len;
  if (causal) k_end = min(k_end, min(q0 + kBQ, Sq));
  const float4* qr = reinterpret_cast<const float4*>(qs[t]);
  const float4* dr = reinterpret_cast<const float4*>(dos[t]);
  for (int kt = 0; kt < k_end; kt += kTK) {
    __syncthreads();  // the previous key tile is no longer read
    for (int i = t; i < kTK * kD; i += kBQ) {
      const int j = i / kD, d = i % kD;
      const bool in = kt + j < Sk;
      const long off = kv_base + (long)(kt + j) * kD + d;
      ks[j][d] = in ? mxtt_load(k, off) : 0.f;
      vs[j][d] = in ? mxtt_load(v, off) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < kTK; ++j) {
      const int key = kt + j;
      if (key >= kv_len || (causal && key > row)) continue;  // p = 0
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kD4; ++d4) {
        s = dot4(qr[d4], kr[d4], s);
        dp = dot4(dr[d4], vr[d4], dp);
      }
      const float p = expf(s * sm_scale - my_lse);
      const float ds = p * (dp - my_dl) * sm_scale;
#pragma unroll
      for (int d4 = 0; d4 < kD4; ++d4) {
        const float4 kk = kr[d4];
        dq_acc[4 * d4] += ds * kk.x;
        dq_acc[4 * d4 + 1] += ds * kk.y;
        dq_acc[4 * d4 + 2] += ds * kk.z;
        dq_acc[4 * d4 + 3] += ds * kk.w;
      }
    }
  }
  if (!live) return;
  const long off = q_base + (long)row * kD;
#pragma unroll
  for (int d = 0; d < kD; ++d) mxtt_store(dq, off + d, dq_acc[d]);
}

int check_shape(int BH, int H, int Sq, int Sk, int D) {
  if (BH < 0 || BH > 65535 || H < 1 || BH % H != 0 || Sq < 0 || Sk < 0 ||
      D != kD)
    return MXTT_ERR_SHAPE;
  return 0;
}

}  // namespace

// q, dout (BH, Sq, D); k, v, dk, dv (BH, Sk, D), all in `dtype`; lse,
// delta f32 (BH, Sq); vl (BH / H,) int32 or null. BH = B * H, b-major.
extern "C" int mxtt_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* vl, void* dk, void* dv,
    int BH, int H, int Sq, int Sk, int D, float sm_scale, int causal,
    int dtype, void* stream) {
  if (const int err = check_shape(BH, H, Sq, Sk, D)) return err;
  if (BH == 0 || Sk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Sk + kBK - 1) / kBK, BH);
  if (dtype == MXTT_F32) {
    flash_bwd_dkdv_kernel<float><<<grid, kBK, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, vl, static_cast<float*>(dk), static_cast<float*>(dv), H, Sq,
        Sk, sm_scale, causal);
  } else if (dtype == MXTT_BF16) {
    using B16 = __nv_bfloat16;
    flash_bwd_dkdv_kernel<B16><<<grid, kBK, 0, s>>>(
        static_cast<const B16*>(q), static_cast<const B16*>(k),
        static_cast<const B16*>(v), static_cast<const B16*>(dout), lse,
        delta, vl, static_cast<B16*>(dk), static_cast<B16*>(dv), H, Sq, Sk,
        sm_scale, causal);
  } else {
    return MXTT_ERR_DTYPE;
  }
  return static_cast<int>(cudaGetLastError());
}

// q, dout, dq (BH, Sq, D); k, v (BH, Sk, D), all in `dtype`; lse, delta
// f32 (BH, Sq); vl (BH / H,) int32 or null.
extern "C" int mxtt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* vl, void* dq, int BH,
    int H, int Sq, int Sk, int D, float sm_scale, int causal, int dtype,
    void* stream) {
  if (const int err = check_shape(BH, H, Sq, Sk, D)) return err;
  if (BH == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  if (dtype == MXTT_F32) {
    flash_bwd_dq_kernel<float><<<grid, kBQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, vl, static_cast<float*>(dq), H, Sq, Sk, sm_scale, causal);
  } else if (dtype == MXTT_BF16) {
    using B16 = __nv_bfloat16;
    flash_bwd_dq_kernel<B16><<<grid, kBQ, 0, s>>>(
        static_cast<const B16*>(q), static_cast<const B16*>(k),
        static_cast<const B16*>(v), static_cast<const B16*>(dout), lse,
        delta, vl, static_cast<B16*>(dq), H, Sq, Sk, sm_scale, causal);
  } else {
    return MXTT_ERR_DTYPE;
  }
  return static_cast<int>(cudaGetLastError());
}
