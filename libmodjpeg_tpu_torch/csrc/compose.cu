// DCT-domain compose and blend steps for NVIDIA Hopper (sm_90a).
//
// One kernel body, templated on the mode, serves two entry points.
//
// mjt_compose_blocks (compose mode) replaces
// libmodjpeg_tpu/ops/pallas_compose.py:_compose_kernel (wrapper
// compose_blocks_pallas).  Per 8x8 block, in row-major flattened [64] form:
//
//   x1  = region * q                       (dequantize, f32)
//   t   = ((x0 - x1) @ U) * m              (to the pixel domain, masked)
//   acc = x1 + t @ U^T                     (back to the DCT domain)
//   corr = trunc(acc - x1);  vq = region * q + corr          (int32)
//   out  = clip(vq / q, -32768, 32767)     (C division truncates toward zero,
//                                           i.e. sign(vq) * (|vq| // q))
//
// mjt_blend_blocks (blend mode) replaces
// libmodjpeg_tpu/ops/pallas_compose.py:_blend_kernel (wrapper
// blend_blocks_pallas): the f32 blend alone, y = x1 + ((x0 - x1) @ U * m)
// @ U^T, with x1 read as f32 and y stored as f32.  It moves 4 * 4 * 64 =
// 1 KiB per block (x1, x0, m in, y out) against the same 16 K FLOPs, so it is
// bound like the compose mode.  It must not become the library's blend path:
// nothing in the library calls a bare blend (every compose goes through the
// fused compose mode); this mode exists for the kernel bench and for parity
// with the TPU kernel.
//
// U = C (x) C is the 64x64 orthonormal 2-D DCT-II.  All float arithmetic is
// full IEEE f32 on the CUDA cores (the TPU kernels run their GEMMs at
// Precision.HIGHEST; TF32 would miss the +-1 bar).  The prologue and the
// epilogue use the _rn intrinsics so the compiler cannot contract them into
// FMAs: that keeps an all-zero-mask block an exact pass-through (t == 0,
// y == x1 in blend mode; acc == x1, corr == 0, vq / q == region in compose
// mode), which transparent logo padding relies on.
//
// What bounds it: each block moves (2 + 4 + 4 + 4 + 2) * 64 = 1 KiB through
// device memory against 2 * 2 * 64 * 64 = 16 K FLOPs, about 16 FLOP/byte,
// which sits near the FP32 CUDA-core balance point of the card.  The design
// keeps U resident in shared memory for a CTA's whole run of blocks (padded
// to a row stride of 65 floats so both U and U^T reads are bank-conflict
// free) and gives each thread one coefficient of four blocks, so every U
// value read from shared memory feeds four FMAs and the block operands are
// read as float4 broadcasts.  The grid is sized from the occupancy API (see
// launch below).  The f32
// dropon/mask inputs are the TPU kernel's wrapper contract; fusing them away
// (a per-row quant index, the uplink scatter and the downlink pack) is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 64;        // blocks in flight per pass
constexpr int kPerThread = 4;               // blocks per thread per pass
constexpr int kGroup = kRows * kPerThread;  // blocks per CTA per iteration
constexpr int kStride = 65;                 // padded row stride of U in smem

// kBlend: blend mode (image/yout used; region, quant and out are null).
// Otherwise compose mode (region, quant and out used; image and yout null).
template <bool kBlend>
__global__ void __launch_bounds__(kThreads)
blocks_kernel(const int16_t* __restrict__ region,
              const float* __restrict__ image,
              const float* __restrict__ x0,
              const float* __restrict__ mask,
              const int32_t* __restrict__ quant,
              const float* __restrict__ u,
              int16_t* __restrict__ out,
              float* __restrict__ yout, long long n) {
  __shared__ float su[64 * kStride];
  __shared__ __align__(16) float sx[kGroup][64];

  for (int i = threadIdx.x; i < 64 * 64; i += kThreads)
    su[(i >> 6) * kStride + (i & 63)] = u[i];

  const int j = threadIdx.x & 63;   // coefficient this thread owns
  const int r = threadIdx.x >> 6;   // first block row of this thread
  const long long groups = (n + kGroup - 1) / kGroup;

  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long base = g * kGroup;
    int reg[kPerThread], q[kPerThread];
    float x1[kPerThread], m[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int b = r + kRows * i;
      const long long blk = base + b;
      float d = 0.f;
      reg[i] = 0;
      q[i] = 1;
      m[i] = 0.f;
      x1[i] = 0.f;
      if (blk < n) {
        const long long idx = blk * 64 + j;
        m[i] = mask[idx];
        if constexpr (kBlend) {
          x1[i] = image[idx];
        } else {
          reg[i] = region[idx];
          q[i] = quant[idx];
          x1[i] = __fmul_rn((float)reg[i], (float)q[i]);
        }
        d = __fsub_rn(x0[idx], x1[i]);
      }
      sx[b][j] = d;
    }
    __syncthreads();  // also orders the U fill on the first iteration

    // t[b][j] = m[b][j] * sum_k X[b][k] * U[k][j]
    float acc[kPerThread] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < 64; k += 4) {
      const float u0 = su[(k + 0) * kStride + j];
      const float u1 = su[(k + 1) * kStride + j];
      const float u2 = su[(k + 2) * kStride + j];
      const float u3 = su[(k + 3) * kStride + j];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(&sx[r + kRows * i][k]);
        acc[i] = fmaf(xv.x, u0, acc[i]);
        acc[i] = fmaf(xv.y, u1, acc[i]);
        acc[i] = fmaf(xv.z, u2, acc[i]);
        acc[i] = fmaf(xv.w, u3, acc[i]);
      }
    }
    __syncthreads();  // every read of X is done before t overwrites it
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      sx[r + kRows * i][j] = __fmul_rn(acc[i], m[i]);
    __syncthreads();

    // y[b][j] = sum_k t[b][k] * U^T[k][j] = sum_k t[b][k] * U[j][k]
    float y[kPerThread] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < 64; k += 4) {
      const float u0 = su[j * kStride + k + 0];
      const float u1 = su[j * kStride + k + 1];
      const float u2 = su[j * kStride + k + 2];
      const float u3 = su[j * kStride + k + 3];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float4 tv = *reinterpret_cast<const float4*>(&sx[r + kRows * i][k]);
        y[i] = fmaf(tv.x, u0, y[i]);
        y[i] = fmaf(tv.y, u1, y[i]);
        y[i] = fmaf(tv.z, u2, y[i]);
        y[i] = fmaf(tv.w, u3, y[i]);
      }
    }

#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const long long blk = base + r + kRows * i;
      if (blk < n) {
        const float a = __fadd_rn(x1[i], y[i]);
        if constexpr (kBlend) {
          yout[blk * 64 + j] = a;
        } else {
          const int corr = (int)truncf(__fsub_rn(a, x1[i]));
          const int vq = reg[i] * q[i] + corr;
          int o = vq / q[i];
          o = o < -32768 ? -32768 : (o > 32767 ? 32767 : o);
          out[blk * 64 + j] = (int16_t)o;
        }
      }
    }
    __syncthreads();  // t is read by all rows before the next group's X
  }
}

// Shared launch: a grid of at most kWaves times as many CTAs as fit on the
// card at once (SMs x resident CTAs per SM from the occupancy API), walking
// the block groups with a grid stride.  One resident wave (kWaves = 1) was
// 3-10% slower on an H100 at 12,288 to 1,048,576 blocks: a CTA has no loads
// in flight while it computes, and fresh CTAs filling freed slots hide part
// of that latency.  Returns the launch's cudaGetLastError().
constexpr int kWaves = 2;

template <bool kBlend>
int launch(const int16_t* region, const float* image, const float* x0,
           const float* mask, const int32_t* quant, const float* u,
           int16_t* out, float* yout, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, blocks_kernel<kBlend>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long groups = (n + kGroup - 1) / kGroup;
  const long long cap = (long long)sms * per_sm * kWaves;
  const unsigned grid = (unsigned)(groups < cap ? groups : cap);
  blocks_kernel<kBlend><<<grid, kThreads, 0, stream>>>(
      region, image, x0, mask, quant, u, out, yout, n);
  return (int)cudaGetLastError();
}

}  // namespace

// region/out: [n, 64] int16; x0/mask: [n, 64] f32; quant: [n, 64] int32
// (every value >= 1); u: [64, 64] f32 row-major.  All pointers on the
// current device, contiguous.  Launches on `stream`; returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int mjt_compose_blocks(const void* region, const void* x0,
                                  const void* mask, const void* quant,
                                  const void* u, void* out, long long n,
                                  void* stream) {
  return launch<false>(
      static_cast<const int16_t*>(region), nullptr,
      static_cast<const float*>(x0), static_cast<const float*>(mask),
      static_cast<const int32_t*>(quant), static_cast<const float*>(u),
      static_cast<int16_t*>(out), nullptr, n, (cudaStream_t)stream);
}

// image (x1)/x0/mask/out (y): [n, 64] f32; u: [64, 64] f32 row-major.  All
// pointers on the current device, contiguous.  Launches on `stream`; returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int mjt_blend_blocks(const void* image, const void* x0,
                                const void* mask, const void* u, void* out,
                                long long n, void* stream) {
  return launch<true>(
      nullptr, static_cast<const float*>(image),
      static_cast<const float*>(x0), static_cast<const float*>(mask),
      nullptr, static_cast<const float*>(u), nullptr,
      static_cast<float*>(out), n, (cudaStream_t)stream);
}
