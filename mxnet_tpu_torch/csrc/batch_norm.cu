// B7 and B8: the BatchNorm reductions over the channel-last (M, C) view.
//
// B7 replaces the Pallas kernel mxnet_tpu/ops/pallas/batch_norm.py:
// _stats_kernel (:80), launched by _stats_call (:112) under bn_stats
// (:133): per-channel mean and population variance from shifted one-pass
// sums S1 = sum(x - s), S2 = sum((x - s)^2) in f32, s = the channel's
// value in row 0; mean = s + S1 / M, var = S2 / M - (S1 / M)^2. The shift
// keeps the one-pass form accurate when |mean| >> std (s lies within a
// few std of the mean, so the subtraction cancels O(1) bits, never the
// mean^2 / var ratio of the unshifted form).
//
// B8 replaces _bwd_kernel (:160), launched by _bwd_call (:196) under
// bn_bwd_reduce (:211): per-channel sum(dy) and sum(dy * xhat), xhat =
// (x - mean) * inv, in one joint read of x and dy, f32.
//
// The TPU kernels carry their sums in VMEM across a sequential grid
// (the init at i == 0, batch_norm.py:85,166). Blocks on Hopper run in
// parallel and in no order, so here every block reduces a tile of
// channels over one chunk of rows into a partial row (f32, nchunks x C),
// and a second kernel adds the partial rows in a fixed order. No
// atomics: two calls give the same bits. B7 uses one shift for every
// block (row 0 of the view), so the partial sums simply add. The JAX
// package folds C < 128 channels into 128 lanes and merges the copies
// with Chan's formula (batch_norm.py:123-157); that is an artefact of the
// TPU's lane width and has no counterpart here.
//
// Bound on the H100: device-memory bytes. B7 reads x once, B8 reads x and
// dy once; a few operations per element. At ResNet-50's stem (802,816 x
// 64 bf16) that is 0.0307 ms (B7) and 0.0614 ms (B8) at 3.35 TB/s; the
// partials add 2 x nchunks x C f32 written and read again (0.27 MB at
// the stem, 0.8 MB at 3,136 x 2,048).
//
// Design: thread (tx, ty) of a 256-thread block owns V neighbouring
// channels (V = 16 bytes / element size when C allows: float4 or eight
// bf16 in one 16-byte load; else V = 1), so neighbouring threads read
// neighbouring addresses, and walks the rows ty, ty + TY, ... of its
// chunk, four rows in flight. TX = min(C / V, 32) threads span the
// channel tile, TY = 256 / TX the rows: at C = 64 bf16 a warp reads four
// whole rows (512 contiguous bytes). The caller picks the chunk length so
// that about four blocks per SM fill the card at both ends of ResNet-50
// (the stem, one channel tile; stage 4, eight tiles of 256 channels).
// Each block parks its threads' sums in shared memory and one thread per
// channel adds them in ty order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // rows in flight per thread
constexpr int kRedCols = 32;    // reduce kernel: channels per block
constexpr int kRedSlices = 16;  // reduce kernel: threads per channel

// V neighbouring channels of one row as f32: one 16-byte load for V > 1
__device__ __forceinline__ void load_vec(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[1]) {
  o[0] = mxtt_load(p, 0);
}

// Block (blockIdx.x = channel tile, blockIdx.y = row chunk). B7 (kBwd
// false): part1 = sum(x - s), part2 = sum((x - s)^2), s = x[0, c]. B8:
// part1 = sum(dy), part2 = sum(dy * (x - mean) * inv). Rows at or past
// M are never read.
template <typename T, int V, bool kBwd>
__global__ void __launch_bounds__(kThreads)
bn_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ mean,
                  const float* __restrict__ inv, int M, int C,
                  int chunk_rows, float* __restrict__ part1,
                  float* __restrict__ part2) {
  __shared__ float red1[kThreads * V];
  __shared__ float red2[kThreads * V];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int c0 = (blockIdx.x * TX + tx) * V;
  const long r0 = (long)blockIdx.y * chunk_rows;
  const long r1 = r0 + chunk_rows < M ? r0 + chunk_rows : (long)M;
  float a[V], b[V], s[V], sc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = 0.f;
    b[j] = 0.f;
    sc[j] = 1.f;
  }
  if (c0 < C) {
    if (kBwd) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] = mean[c0 + j];
        sc[j] = inv[c0 + j];
      }
    } else {
      load_vec(x + c0, s);  // the shift: row 0
    }
    for (long r = r0 + ty; r < r1; r += (long)kUnroll * TY) {
      float xv[kUnroll][V], dv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long row = r + (long)u * TY;
        if (row < r1) {
          load_vec(x + row * C + c0, xv[u]);
          if (kBwd) load_vec(dy + row * C + c0, dv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + (long)u * TY < r1) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if (kBwd) {
              const float xh = (xv[u][j] - s[j]) * sc[j];
              a[j] += dv[u][j];
              b[j] += dv[u][j] * xh;
            } else {
              const float d = xv[u][j] - s[j];
              a[j] += d;
              b[j] += d * d;
            }
          }
        }
      }
    }
  }
  // the block's partial row: every thread parks its sums, then one thread
  // per channel of the tile adds them in ty order
  const int t = ty * TX + tx;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red1[t * V + j] = a[j];
    red2[t * V + j] = b[j];
  }
  __syncthreads();
  const int tile = TX * V;
  for (int k = t; k < tile; k += TX * TY) {
    const int c = blockIdx.x * tile + k;
    if (c < C) {
      float s1 = 0.f, s2 = 0.f;
      for (int y = 0; y < TY; ++y) {
        s1 += red1[y * tile + k];
        s2 += red2[y * tile + k];
      }
      part1[(long)blockIdx.y * C + c] = s1;
      part2[(long)blockIdx.y * C + c] = s2;
    }
  }
}

// out1[c], out2[c] = the sums of the nchunks partial rows, in a fixed
// order: kRedSlices threads per channel each add every kRedSlices-th
// partial, then one thread adds the slice sums in slice order. B7
// (kStats) finishes: mean = s + S1 / M, var = S2 / M - (S1 / M)^2.
template <typename T, bool kStats>
__global__ void __launch_bounds__(kRedCols * kRedSlices)
bn_reduce_kernel(const float* __restrict__ part1,
                 const float* __restrict__ part2, int nchunks, int C,
                 const T* __restrict__ x, int M, float* __restrict__ out1,
                 float* __restrict__ out2) {
  __shared__ float sh1[kRedSlices][kRedCols];
  __shared__ float sh2[kRedSlices][kRedCols];
  const int tx = threadIdx.x;  // channel within the block
  const int ty = threadIdx.y;  // slice
  const int c = blockIdx.x * kRedCols + tx;
  float a1 = 0.f, a2 = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int p = ty; p < nchunks; p += kRedSlices) {
      a1 += part1[(long)p * C + c];
      a2 += part2[(long)p * C + c];
    }
  }
  sh1[ty][tx] = a1;
  sh2[ty][tx] = a2;
  __syncthreads();
  if (ty == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int k = 0; k < kRedSlices; ++k) {
      t1 += sh1[k][tx];
      t2 += sh2[k][tx];
    }
    if (kStats) {
      const float m1 = t1 / (float)M;
      out1[c] = mxtt_load(x, c) + m1;
      out2[c] = t2 / (float)M - m1 * m1;
    } else {
      out1[c] = t1;
      out2[c] = t2;
    }
  }
}

template <typename T, int V, bool kBwd>
int launch(const void* x, const void* dy, const float* mean,
           const float* inv, float* out, float* partials, int M, int C,
           int chunk_rows, int nchunks, cudaStream_t stream) {
  const int nvec = (C + V - 1) / V;
  const int TX = nvec < 32 ? nvec : 32;
  const int TY = kThreads / TX;
  const dim3 grid((nvec + TX - 1) / TX, nchunks);
  float* part1 = partials;
  float* part2 = partials + (long)nchunks * C;
  const T* xp = static_cast<const T*>(x);
  bn_partial_kernel<T, V, kBwd><<<grid, dim3(TX, TY), 0, stream>>>(
      xp, static_cast<const T*>(dy), mean, inv, M, C, chunk_rows, part1,
      part2);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bn_reduce_kernel<T, !kBwd>
      <<<(C + kRedCols - 1) / kRedCols, dim3(kRedCols, kRedSlices), 0,
         stream>>>(part1, part2, nchunks, C, xp, M, out, out + C);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// Checks the tiling the caller sized the partials from, then picks the
// element type and the vector width (16-byte loads need C % V == 0 and
// 16-byte aligned operands).
template <bool kBwd>
int dispatch(const void* x, const void* dy, const float* mean,
             const float* inv, float* out, float* partials, int M, int C,
             int chunk_rows, int nchunks, int vec, int dtype, void* stream) {
  if (M < 1 || C < 1 || chunk_rows < 1 || nchunks < 1 || nchunks > 65535 ||
      (long)(nchunks - 1) * chunk_rows >= M ||
      (long)nchunks * chunk_rows < M)
    return MXTT_ERR_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec && !(aligned16(x) && (!kBwd || aligned16(dy))))
    return MXTT_ERR_SHAPE;
  if (dtype == MXTT_F32) {
    if (vec) {
      if (C % 4) return MXTT_ERR_SHAPE;
      return launch<float, 4, kBwd>(x, dy, mean, inv, out, partials, M, C,
                                    chunk_rows, nchunks, s);
    }
    return launch<float, 1, kBwd>(x, dy, mean, inv, out, partials, M, C,
                                  chunk_rows, nchunks, s);
  }
  if (dtype == MXTT_BF16) {
    if (vec) {
      if (C % 8) return MXTT_ERR_SHAPE;
      return launch<__nv_bfloat16, 8, kBwd>(x, dy, mean, inv, out, partials,
                                            M, C, chunk_rows, nchunks, s);
    }
    return launch<__nv_bfloat16, 1, kBwd>(x, dy, mean, inv, out, partials, M,
                                          C, chunk_rows, nchunks, s);
  }
  return MXTT_ERR_DTYPE;
}

}  // namespace

// x (M, C) in `dtype`; out f32 (2, C): mean, then population variance;
// partials f32 with 2 * nchunks * C floats, nchunks = ceil(M /
// chunk_rows). vec != 0 asks for 16-byte loads.
extern "C" int mxtt_bn_stats(const void* x, float* out, float* partials,
                             int M, int C, int chunk_rows, int nchunks,
                             int vec, int dtype, void* stream) {
  return dispatch<false>(x, nullptr, nullptr, nullptr, out, partials, M, C,
                         chunk_rows, nchunks, vec, dtype, stream);
}

// x, dy (M, C) in `dtype`; mean, inv f32 (C,); out f32 (2, C): sum(dy),
// then sum(dy * (x - mean) * inv); partials as for mxtt_bn_stats.
extern "C" int mxtt_bn_bwd_reduce(const void* x, const void* dy,
                                  const float* mean, const float* inv,
                                  float* out, float* partials, int M, int C,
                                  int chunk_rows, int nchunks, int vec,
                                  int dtype, void* stream) {
  return dispatch<true>(x, dy, mean, inv, out, partials, M, C, chunk_rows,
                        nchunks, vec, dtype, stream);
}
