// B2: LayerNorm backward over the last axis of a (rows, C) view.
//
// Replaces the Pallas kernel mxnet_tpu/ops/pallas/layer_norm.py:_bwd_kernel
// (:51), launched by _ln_bwd_impl (:124). Same arithmetic, in f32, from
// the forward's f32 per-row mean and rstd: xhat = (x - mean) * rstd,
// dyg = dy * gamma, dx = (dyg - mean(dyg) - xhat * mean(dyg * xhat)) *
// rstd in x's dtype; dgamma = sum over rows of dy * xhat and dbeta = sum
// over rows of dy, both f32.
//
// The TPU kernel sums dgamma and dbeta into one (1, C) block that every
// grid step revisits (layer_norm.py:62-72); that is race-free only because
// a TPU grid runs in order. Blocks on Hopper run in parallel and in no
// order, so here every block writes one partial row and a second kernel
// adds the partials up in a fixed order. No atomics: the result is the
// same bits on every run.
//
// Bound on the H100: device-memory bytes. It reads x and dy once and
// writes dx once (a few operations per element). At the training path's
// shape (8192 x 768 bf16) that is 37.7 MB, about 11 us at 3.35 TB/s; the
// partials add 2 x 256 x 768 f32 written and read again (1.6 MB each way).
//
// Design: kernel 1 keeps the forward's layout (csrc/layer_norm.cu): one
// warp per row, lane t holding columns t + 32 i in registers, so every
// load and store of the warp is coalesced and each row is read once. A
// block of four warps owns kRowsPerBlock consecutive rows (warp w takes
// rows w, w + 4, ...); each lane sums dy * xhat and dy for its columns
// over its rows, and the four warps add their sums into shared memory in
// warp order, giving the block's partial row. Kernel 2 reduces the
// partials column by column: kSlices threads per column each sum every
// kSlices-th partial, then one thread adds the slice sums in order.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
// 8 rows per warp; the caller sizes the partials workspace from it
// (ROWS_PER_BLOCK in ops/kernels/layer_norm.py)
constexpr int kRowsPerBlock = 32;
constexpr int kCols = 32;          // reduce kernel: columns per block
constexpr int kSlices = 16;        // reduce kernel: threads per column

int num_partials(int rows) { return (rows + kRowsPerBlock - 1) / kRowsPerBlock; }

template <typename T, int VPT>
__global__ void __launch_bounds__(32 * kWarps)
ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ part_g,
                   float* __restrict__ part_b, int rows, int C) {
  extern __shared__ float sred[];  // 2 * C: the block's dgamma, dbeta
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long row0 = (long)blockIdx.x * kRowsPerBlock;
  const long row_end =
      row0 + kRowsPerBlock < rows ? row0 + kRowsPerBlock : (long)rows;
  float g[VPT], acc_g[VPT], acc_b[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    g[i] = c < C ? mxtt_load(gamma, c) : 0.f;
    acc_g[i] = 0.f;
    acc_b[i] = 0.f;
  }
  for (long row = row0 + warp; row < row_end; row += kWarps) {
    const T* xr = x + row * C;
    const T* dyr = dy + row * C;
    const float mu = mean[row];
    const float rs = rstd[row];
    float xh[VPT], dyg[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      float xv = 0.f, dv = 0.f;
      if (c < C) {
        xv = mxtt_load(xr, c);
        dv = mxtt_load(dyr, c);
      }
      xh[i] = c < C ? (xv - mu) * rs : 0.f;
      dyg[i] = dv * g[i];
      acc_g[i] += dv * xh[i];
      acc_b[i] += dv;
      s1 += dyg[i];
      s2 += dyg[i] * xh[i];
    }
    const float m1 = mxtt_warp_sum(s1) / C;
    const float m2 = mxtt_warp_sum(s2) / C;
    T* dxr = dx + row * C;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < C) mxtt_store(dxr, c, (dyg[i] - m1 - xh[i] * m2) * rs);
    }
  }
  // the block's partial row: the warps add their sums in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int c = lane + 32 * i;
        if (c < C) {
          sred[c] = w == 0 ? acc_g[i] : sred[c] + acc_g[i];
          sred[C + c] = w == 0 ? acc_b[i] : sred[C + c] + acc_b[i];
        }
      }
    }
    __syncthreads();
  }
  float* pg = part_g + (long)blockIdx.x * C;
  float* pb = part_b + (long)blockIdx.x * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    pg[c] = sred[c];
    pb[c] = sred[C + c];
  }
}

// dgamma[c] = sum of part_g[p][c] over p < nparts (and dbeta from part_b),
// always in the same order; nparts == 0 writes zeros.
__global__ void __launch_bounds__(kCols * kSlices)
ln_bwd_reduce_kernel(const float* __restrict__ part_g,
                     const float* __restrict__ part_b, int nparts, int C,
                     float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float sg[kSlices][kCols];
  __shared__ float sb[kSlices][kCols];
  const int tx = threadIdx.x;  // column within the block
  const int ty = threadIdx.y;  // slice
  const int c = blockIdx.x * kCols + tx;
  float accg = 0.f, accb = 0.f;
  if (c < C) {
    for (int p = ty; p < nparts; p += kSlices) {
      accg += part_g[(long)p * C + c];
      accb += part_b[(long)p * C + c];
    }
  }
  sg[ty][tx] = accg;
  sb[ty][tx] = accb;
  __syncthreads();
  if (ty == 0 && c < C) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      tg += sg[s][tx];
      tb += sb[s][tx];
    }
    dgamma[c] = tg;
    dbeta[c] = tb;
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const float* mean,
           const float* rstd, const void* dy, void* dx, float* dgamma,
           float* dbeta, float* partials, int rows, int C,
           cudaStream_t stream) {
  const int nparts = num_partials(rows);
  float* part_g = partials;
  float* part_b = partials + (long)nparts * C;
  if (rows > 0) {
    const T* xp = static_cast<const T*>(x);
    const T* gp = static_cast<const T*>(gamma);
    const T* dyp = static_cast<const T*>(dy);
    T* dxp = static_cast<T*>(dx);
    const size_t smem = 2 * (size_t)C * sizeof(float);
    const int need = (C + 31) / 32;
#define MXTT_LNB(VPT)                                                    \
  ln_bwd_rows_kernel<T, VPT><<<nparts, 32 * kWarps, smem, stream>>>(     \
      xp, gp, mean, rstd, dyp, dxp, part_g, part_b, rows, C)
    if (need <= 4) MXTT_LNB(4);
    else if (need <= 8) MXTT_LNB(8);
    else if (need <= 16) MXTT_LNB(16);
    else if (need <= 24) MXTT_LNB(24);
    else if (need <= 32) MXTT_LNB(32);
    else if (need <= 64) MXTT_LNB(64);
    else MXTT_LNB(128);
#undef MXTT_LNB
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  ln_bwd_reduce_kernel<<<(C + kCols - 1) / kCols, dim3(kCols, kSlices), 0,
                         stream>>>(part_g, part_b, nparts, C, dgamma, dbeta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, gamma, dy, dx in `dtype`; mean, rstd f32 (rows,) from the forward;
// dgamma, dbeta f32 (C,); partials f32 with 2 * ceil(rows /
// kRowsPerBlock) * C floats. The same C range as the forward
// (layer_norm.py:170-177).
extern "C" int mxtt_layer_norm_bwd(const void* x, const void* gamma,
                                   const float* mean, const float* rstd,
                                   const void* dy, void* dx, float* dgamma,
                                   float* dbeta, float* partials, int rows,
                                   int C, int dtype, void* stream) {
  if (C < 128 || C > 4096 || C % 128 != 0 || rows < 0) return MXTT_ERR_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MXTT_F32)
    return launch<float>(x, gamma, mean, rstd, dy, dx, dgamma, dbeta,
                         partials, rows, C, s);
  if (dtype == MXTT_BF16)
    return launch<__nv_bfloat16>(x, gamma, mean, rstd, dy, dx, dgamma, dbeta,
                                 partials, rows, C, s);
  return MXTT_ERR_DTYPE;
}
