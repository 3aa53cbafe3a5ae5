// B6: paged window attention, an S-query window per row, pools read in
// place.
//
// Replaces the Pallas kernel mxnet_tpu/ops/pallas/paged_flash_attention.py:
// _window_kernel (:181), launched by paged_window_attention (:239). Same
// contract: q (B, S, H, D); K/V pools (num_pages, page_size, H, D) in q's
// dtype (float32, the serving path's cache; head dim 64); page_table
// (B, P) int32; q_offset and window_vl (B,) int32. Query i of row b sits
// at absolute position q_offset[b] + i (>= 0) and attends the keys at
// positions <= its own, read through the row's table: causal across the
// cached history and within the window, whose K/V the caller has already
// scattered into the pools. An online softmax runs in f32 with the -1e30
// sentinel for masked keys and l clamped to 1e-30 (:233). Queries
// i >= window_vl[b] are padding and output exactly 0 (:234-236). Output
// (B, S, H, D) in q's dtype.
//
// Bound on the H100: at the forced-prefix replay's longest window (8
// rows, S=128, H=8, D=64, q_offset 1, at most 129 keys a row) one call
// moves about 8.4 MB (4.2 MB of K/V read once, 4.2 MB of q and output),
// 2.5 us at 3.35 TB/s, and does 4*D operations per visible (query, key)
// pair, 0.14 GFLOP, 2.0 us at 67 TFLOP/s of f32 outside the tensor
// cores: the two are close, bytes slightly ahead.
//
// Design: on the TPU the grid is (B, P) with the page axis sequential,
// and the m/l/acc scratch carries across it (initialised at p == 0,
// written at the last page, :192, :229). On Hopper nothing carries
// between blocks: one block per (row, head, tile of up to 8 queries),
// one warp per query, owns the whole loop over its row's keys. The block
// reads its own table entries and stages each chunk of 32 consecutive key
// positions (a chunk may span pages; page_size need not divide 32) in
// shared memory once for all its warps, K at a D+1 stride so that lane t
// reads key t without bank conflicts. Each warp then scores and
// accumulates as K3's warp does (paged_attention.cu): lane t scores key t
// against the warp's query, a warp max/sum gives the chunk's softmax
// update, and each lane accumulates D/32 output dims from the staged V
// rows. The block's key loop stops at the position of its last live
// query and at the table width P (pages past q_offset + S - 1 are never
// read, as the TPU kernel skips them); a warp skips the chunks wholly past
// its own query. A tile with no live query writes zeros and reads
// nothing. No wgmma or TMA yet.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 32;     // key positions staged per round
constexpr int kMaxWarps = 8;   // queries of a block, one warp each

template <int D>
__global__ void __launch_bounds__(32 * kMaxWarps)
paged_window_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ q_offset,
                    const int* __restrict__ window_vl,
                    float* __restrict__ out, int S, int H, int page_size,
                    int P, float sm_scale) {
  constexpr int NPL = D / 32;  // output dims per lane
  constexpr int D4 = D / 4;
  __shared__ float qs[kMaxWarps][D];
  __shared__ float ks[kChunk][D + 1];
  __shared__ __align__(16) float vs[kChunk][D];

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * warps;
  const int i = i0 + warp;  // this warp's query
  const int vl = min(max(window_vl[b], 0), S);
  const int off = q_offset[b];
  const bool live = i < vl;
  const long row_stride = (long)H * D;  // between consecutive keys
  const long qo = (((long)b * S + i) * H + h) * D;

  // the tile's last live query bounds the keys any of its warps sees
  const int last = min(i0 + warps, vl) - 1;
  if (last < i0) {  // padding only: nothing to read (uniform per block)
    if (i < S) {
#pragma unroll
      for (int c = 0; c < NPL; ++c) out[qo + lane + 32 * c] = 0.f;
    }
    return;
  }
  const int n_keys = max(0, min(P * page_size, off + last + 1));
  const int q_abs = off + i;
  if (live) {
#pragma unroll
    for (int c = 0; c < NPL; ++c)
      qs[warp][lane + 32 * c] = q[qo + lane + 32 * c];
  }

  float acc[NPL];
#pragma unroll
  for (int c = 0; c < NPL; ++c) acc[c] = 0.f;
  float m = MXTT_NEG_INF;
  float l = 0.f;
  const int* table = page_table + (long)b * P;

  for (int k0 = 0; k0 < n_keys; k0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done (and qs set)
    for (int idx = threadIdx.x; idx < kChunk * D4; idx += blockDim.x) {
      const int r = idx / D4;
      const int c4 = idx % D4;
      const int kp = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (kp < n_keys) {
        const long page = table[kp / page_size];
        const long base = (page * page_size + kp % page_size) * row_stride
                          + (long)h * D;
        kv = reinterpret_cast<const float4*>(k_pool + base)[c4];
        vv = reinterpret_cast<const float4*>(v_pool + base)[c4];
      }
      ks[r][4 * c4 + 0] = kv.x;
      ks[r][4 * c4 + 1] = kv.y;
      ks[r][4 * c4 + 2] = kv.z;
      ks[r][4 * c4 + 3] = kv.w;
      reinterpret_cast<float4*>(&vs[r][0])[c4] = vv;
    }
    __syncthreads();
    if (!live || k0 > q_abs) continue;  // uniform per warp

    const int kp = k0 + lane;
    const bool has_key = kp < n_keys;
    float s = -CUDART_INF_F;  // lanes without a key take no part
    if (has_key) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qs[warp][d] * ks[lane][d];
      s = kp <= q_abs ? dot * sm_scale : MXTT_NEG_INF;
    }
    const float m_new = fmaxf(m, mxtt_warp_max(s));
    const float alpha = expf(m - m_new);
    const float pr = has_key ? expf(s - m_new) : 0.f;
    l = alpha * l + mxtt_warp_sum(pr);
#pragma unroll
    for (int c = 0; c < NPL; ++c) acc[c] *= alpha;
    const int n = min(kChunk, n_keys - k0);
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
      for (int c = 0; c < NPL; ++c) acc[c] += pj * vs[j][lane + 32 * c];
    }
    m = m_new;
  }
  if (i < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < NPL; ++c)
      out[qo + lane + 32 * c] = live ? acc[c] * inv : 0.f;
  }
}

}  // namespace

// q/out (B, S, H, D), pools (num_pages, page_size, H, D), all f32
// (`dtype`), 16-byte aligned; page_table (B, P), q_offset and window_vl
// (B,) int32.
extern "C" int mxtt_paged_window_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* page_table, const int* q_offset, const int* window_vl,
    void* out, int B, int S, int H, int D, int page_size, int P,
    float sm_scale, int dtype, void* stream) {
  if (B < 0 || B > 65535 || S < 0 || H < 1 || H > 65535 || page_size < 1
      || P < 1)
    return MXTT_ERR_SHAPE;
  if (B == 0 || S == 0) return 0;
  // the serving path's f32 cache and head dim, as K3's
  if (dtype != MXTT_F32) return MXTT_ERR_DTYPE;
  if (D != 64) return MXTT_ERR_SHAPE;
  if ((reinterpret_cast<std::uintptr_t>(k_pool)
       | reinterpret_cast<std::uintptr_t>(v_pool)) % 16)
    return MXTT_ERR_SHAPE;
  const int warps = S < kMaxWarps ? S : kMaxWarps;
  const dim3 grid((S + warps - 1) / warps, H, B);
  paged_window_kernel<64><<<grid, 32 * warps, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), page_table, q_offset, window_vl,
      static_cast<float*>(out), S, H, page_size, P, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
