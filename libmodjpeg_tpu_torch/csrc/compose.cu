// DCT-domain compose and blend steps for NVIDIA Hopper (sm_90a).
//
// One kernel body, templated on the mode, serves two entry points.
//
// mjt_compose_rows (compose mode) replaces
// libmodjpeg_tpu/ops/pallas_compose.py:_compose_kernel (wrapper
// compose_blocks_pallas).  Per 8x8 block X (row-major, natural order):
//
//   x1  = region * q                       (dequantize, f32)
//   t   = (C^T (x0 - x1) C) * m            (to the pixel domain, masked)
//   acc = x1 + C t C^T                     (back to the DCT domain)
//   corr = trunc(acc - x1);  vq = region * q + corr          (int32)
//   out  = clip(vq / q, -32768, 32767)     (C division truncates toward zero)
//
// C is the orthonormal 8-point DCT-II (C[k][n] = c_k cos((2n+1) k pi / 16)),
// so C^T X C is the TPU kernel's X @ U with U = C (x) C, evaluated as 8-point
// column and row passes: at most 4 * 8 * 8 * 8 = 2 K FMAs (4 K FLOPs) per
// block instead of the dense 16 K FLOPs, and the even/odd butterflies of
// mul_ct and mul_c take that down to about 1.1 K operations.
//
// Its operands are compact, as the packed batch holds them: the region is
// n images of h block rows of w blocks, each block 64 contiguous int16 and
// the blocks of a block row adjacent, images and block rows at any element
// stride (so a component's slice of the packed [n, per_file] row, or a
// footprint window of a [N, H, W, 8, 8] grid, is read where it lies); the
// output is written at the same position of its own strided tensor (which
// may be the region itself).  The quant table is one int32 [64] per image
// (stride 0: shared).  The dropon and mask are f32 [h * w, 64] per image
// (stride 0: shared by every image, as in the stream, grid and CLI paths).
//
// mjt_blend_blocks (blend mode) replaces
// libmodjpeg_tpu/ops/pallas_compose.py:_blend_kernel (wrapper
// blend_blocks_pallas): the f32 blend alone, y = x1 + C((C^T (x0 - x1) C)
// * m)C^T, on contiguous [n, 64] f32 operands (the TPU blend kernel's
// contract).  Nothing in the library calls a bare blend; this mode exists
// for the kernel bench and for parity with the TPU kernel.
//
// All float arithmetic is full IEEE f32 on the CUDA cores (the TPU kernels
// run their GEMMs at Precision.HIGHEST; TF32 would miss the +-1 bar).  The
// prologue and the epilogue use the _rn intrinsics so the compiler cannot
// contract them into FMAs: that keeps an all-zero-mask block an exact
// pass-through (t == 0, y == x1 in blend mode; acc == x1, corr == 0,
// vq / q == region in compose mode), which transparent logo padding relies
// on.
//
// What bounds it.  Compose mode: its only per-block device-memory traffic is
// the int16 region in and the int16 result out, 256 B per block (the
// dropon, mask and quant are read once per batch and then come from L2),
// against 4 K FLOPs, about 16 FLOP/B, so the card's memory sets the bound.
// The kernel still runs well above it (PERF.md): taking out the transforms,
// or the dropon and mask loads, or deepening the ring each moved it little,
// which leaves the chain each warp walks per group (shared-memory round
// trips between the passes, int/float conversions) with too few warps
// resident to hide it.  Blend mode moves 4 * 4 * 64 = 1 KiB per block and
// is memory bound.  The design:
//   * eight threads per 8x8 block: thread t holds column t, then row t, of
//     the block in registers; the 8-point passes read C from constant
//     memory as FMA operands, and the two transposes between them go
//     through a padded (9-float row) shared tile that only the block's own
//     eight lanes touch, so they need a __syncwarp, not a CTA barrier;
//   * a CTA walks a contiguous range of 32-block groups; every group's
//     image tile (the region, or x1) travels by cp.async into a ring of
//     shared-memory stages, and the copies of group g + kStages - 1 are
//     issued before group g is transformed, so loads are always in flight;
//     each thread reads its x0 column and mask row of group g + 1 into
//     registers while group g is transformed;
//   * the requantization multiplies by the f32 reciprocal of q, exact for
//     every coefficient of an 8-bit JPEG (see the epilogue), with the int32
//     division of the plain version for a column that falls outside;
//   * an opaque block (mask all ones: a logo's core, a dropon without
//     alpha) is recomputed in the plain version's dense order, so that the
//     truncation of its integer result falls where the plain version's
//     does (dense_blocks; 16 K FLOPs for such a block);
//   * the results leave through shared memory as 16-byte row stores.
// The grid is one resident wave (SMs x CTAs per SM from the occupancy API);
// the register cap of two CTAs per SM keeps the body free of spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                    // threads per 8x8 block
constexpr int kGroup = kThreads / kLanes;    // blocks per CTA per group (32)
constexpr int kTile = 72;    // elements per block in a column-read tile
constexpr int kTRow = 9;     // floats per row in the transpose tile

// kC[i * 8 + k] = C[i][k], the orthonormal 8-point DCT-II rounded to f32.
__constant__ float kC[64] = {
    3.535533845e-01f, 3.535533845e-01f, 3.535533845e-01f, 3.535533845e-01f,
    3.535533845e-01f, 3.535533845e-01f, 3.535533845e-01f, 3.535533845e-01f,
    4.903926253e-01f, 4.157347977e-01f, 2.777851224e-01f, 9.754516184e-02f,
    -9.754516184e-02f, -2.777851224e-01f, -4.157347977e-01f, -4.903926253e-01f,
    4.619397521e-01f, 1.913417131e-01f, -1.913417131e-01f, -4.619397521e-01f,
    -4.619397521e-01f, -1.913417131e-01f, 1.913417131e-01f, 4.619397521e-01f,
    4.157347977e-01f, -9.754516184e-02f, -4.903926253e-01f, -2.777851224e-01f,
    2.777851224e-01f, 4.903926253e-01f, 9.754516184e-02f, -4.157347977e-01f,
    3.535533845e-01f, -3.535533845e-01f, -3.535533845e-01f, 3.535533845e-01f,
    3.535533845e-01f, -3.535533845e-01f, -3.535533845e-01f, 3.535533845e-01f,
    2.777851224e-01f, -4.903926253e-01f, 9.754516184e-02f, 4.157347977e-01f,
    -4.157347977e-01f, -9.754516184e-02f, 4.903926253e-01f, -2.777851224e-01f,
    1.913417131e-01f, -4.619397521e-01f, 4.619397521e-01f, -1.913417131e-01f,
    -1.913417131e-01f, 4.619397521e-01f, -4.619397521e-01f, 1.913417131e-01f,
    9.754516184e-02f, -2.777851224e-01f, 4.157347977e-01f, -4.903926253e-01f,
    4.903926253e-01f, -4.157347977e-01f, 2.777851224e-01f, -9.754516184e-02f,
};

// Shared-memory layout, per mode, in bytes: a ring of kStages stages, each
// one group's image tile (int16 region or f32 x1, kTile elements per block:
// column reads are bank-conflict free), then the transpose tile (kGroup
// blocks of 8 rows of kTRow floats).  Deeper rings (up to 12 stages) did
// not time faster on an H100; these depths did best.
template <bool kBlend>
struct Layout {
  static constexpr int kStages = kBlend ? 3 : 4;
  static constexpr int kStage = kGroup * kTile * (kBlend ? 4 : 2);
  static constexpr int kTrans = kStages * kStage;
  static constexpr int kBytes = kTrans + kGroup * kTile * 4;
};

struct Rows {
  const void* image;       // compose: int16 region; blend: f32 x1
  const float* x0;         // dropon (compose) / x0 (blend)
  const float* mask;
  const int32_t* quant;    // compose mode only
  const float* u;          // compose mode: U = C (x) C and U^T, [64, 64] each
  const float* ut;
  void* out;               // compose: int16; blend: f32
  long long n, h, w;       // images, block rows per image, blocks per row
  long long img_si, img_sy;  // element strides: next image, next block row
  long long out_si, out_sy;
  long long dm_si;         // x0/mask element stride between images (0: shared)
  long long q_si;          // quant element stride between images (0: shared)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The 8-point passes, split by the symmetry C[k][7 - n] = (-1)^k C[k][n]
// into even and odd halves (35 and 36 operations instead of 64 FMAs).

// out[n] = sum_k C[k][n] in[k]   (C^T applied to a column or a row vector)
__device__ __forceinline__ void mul_ct(const float (&in)[8], float (&out)[8]) {
  const float p = in[0] * kC[0];
  const float ee0 = fmaf(in[4], kC[32], p);
  const float ee1 = fmaf(-in[4], kC[32], p);
  const float eo0 = fmaf(in[2], kC[16], in[6] * kC[48]);
  const float eo1 = fmaf(in[2], kC[17], in[6] * kC[49]);
  const float e[4] = {ee0 + eo0, ee1 + eo1, ee1 - eo1, ee0 - eo0};
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float o = in[1] * kC[8 + n];
    o = fmaf(in[3], kC[24 + n], o);
    o = fmaf(in[5], kC[40 + n], o);
    o = fmaf(in[7], kC[56 + n], o);
    out[n] = e[n] + o;
    out[7 - n] = e[n] - o;
  }
}

// out[k] = sum_n C[k][n] in[n]   (C applied to a column or a row vector)
__device__ __forceinline__ void mul_c(const float (&in)[8], float (&out)[8]) {
  float s[4], d[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    s[n] = in[n] + in[7 - n];
    d[n] = in[n] - in[7 - n];
  }
  const float ss0 = s[0] + s[3], ss1 = s[1] + s[2];
  const float sd0 = s[0] - s[3], sd1 = s[1] - s[2];
  out[0] = fmaf(ss1, kC[0], ss0 * kC[0]);
  out[4] = fmaf(-ss1, kC[32], ss0 * kC[32]);
  out[2] = fmaf(sd1, kC[17], sd0 * kC[16]);
  out[6] = fmaf(sd1, kC[49], sd0 * kC[48]);
#pragma unroll
  for (int k = 1; k < 8; k += 2) {
    float o = d[0] * kC[k * 8];
    o = fmaf(d[1], kC[k * 8 + 1], o);
    o = fmaf(d[2], kC[k * 8 + 2], o);
    o = fmaf(d[3], kC[k * 8 + 3], o);
    out[k] = o;
  }
}

// y = (d U) U^T for the four blocks of a warp (the opaque ones need it: their
// mask is all ones, so the plain version's mask multiply is an identity),
// in the plain version's order: each of the 64 sums of both products
// accumulated by sequential FMAs from k = 0.  Block b's tile (64 floats,
// row-major, at tiles + b * kTile) holds its d = x0 - x1 and gets y back.
// Lane l computes sums 2l and 2l + 1 of all four blocks, so each U value it
// loads (coalesced across the warp: U's rows in the first product, U^T's
// in the second) feeds four blocks, and each float4 of d or t it reads is
// a broadcast.  Not inlined: it is the rare path, and keeping it out of the
// kernel body keeps the body's register allocation its own.
__device__ __noinline__ void dense_blocks(float* tiles,
                                             const float* __restrict__ u,
                                             const float* __restrict__ ut,
                                             int lane) {
  const float* mats[2] = {u, ut};
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const float* mat = mats[pass] + 2 * lane;
    float acc[4][2];
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[b][0] = acc[b][1] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < 64; k += 4) {
      float2 w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = __ldg(reinterpret_cast<const float2*>(mat + (k + e) * 64));
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float4 d =
            *reinterpret_cast<const float4*>(tiles + b * kTile + k);
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[b][0] = fmaf(dv[e], w[e].x, acc[b][0]);
          acc[b][1] = fmaf(dv[e], w[e].y, acc[b][1]);
        }
      }
    }
    __syncwarp();  // every lane has read the tiles
#pragma unroll
    for (int b = 0; b < 4; ++b)
      *reinterpret_cast<float2*>(tiles + b * kTile + 2 * lane) =
          make_float2(acc[b][0], acc[b][1]);
    __syncwarp();
  }
}

// Position of a 32-block group: image i, first block j0 of the image's
// h * w blocks (row-major over block rows), and the element offsets of image
// i in the image, out and x0/mask operands.
struct Cursor {
  int i, j0;
  long long img, out, dm;
  __device__ __forceinline__ Cursor(const Rows& p, long long g, int gpi)
      : i((int)(g / gpi)), j0((int)(g % gpi) * kGroup),
        img(i * p.img_si), out(i * p.out_si), dm(i * p.dm_si) {}
  __device__ __forceinline__ void next(const Rows& p, int hw) {
    j0 += kGroup;
    if (j0 >= hw) {
      j0 = 0;
      ++i;
      img += p.img_si;
      out += p.out_si;
      dm += p.dm_si;
    }
  }
};

template <bool kBlend>
__global__ void __launch_bounds__(kThreads, 2)
blocks_kernel(const Rows p) {
  using L = Layout<kBlend>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  float* trans = reinterpret_cast<float*>(smem + L::kTrans);

  const int lane = threadIdx.x & 31;
  const int s = (threadIdx.x >> 5) * 4 + (lane >> 3);  // block slot, 0..31
  const int t = lane & 7;                              // column / row owned
  const int hw = (int)(p.h * p.w);  // < 2^31, checked by the wrapper
  const int gpi = (hw + kGroup - 1) / kGroup;  // groups per image
  const long long groups = p.n * gpi;
  const long long g0 = groups * blockIdx.x / gridDim.x;
  const int count = (int)(groups * (blockIdx.x + 1) / gridDim.x - g0);
  if (count <= 0) return;

  // element offset, within its image, of block jj in an operand whose block
  // rows lie `sy` elements apart
  auto block_at = [&](int jj, long long sy) -> long long {
    if (p.h == 1) return (long long)jj * 64;
    const int y = jj / (int)p.w;
    return y * sy + (long long)(jj - y * (int)p.w) * 64;
  };

  // this thread's copies of group `c` into stage `slot`: one 16-byte row of
  // its block's image tile (two in blend mode); a block past the image's
  // end is zero-filled
  auto issue = [&](const Cursor& c, int slot) {
    unsigned char* st = smem + slot * L::kStage;
    const int jj = c.j0 + s;
    const int bytes = jj < hw ? 16 : 0;
    const long long img = c.img + (bytes ? block_at(jj, p.img_sy) : 0);
    if constexpr (kBlend) {
      const float* src = static_cast<const float*>(p.image) + img;
      float* dst = reinterpret_cast<float*>(st) + s * kTile;
      cp_async16(dst + t * 4, src + t * 4, bytes);
      cp_async16(dst + 32 + t * 4, src + 32 + t * 4, bytes);
    } else {
      const int16_t* src = static_cast<const int16_t*>(p.image) + img;
      int16_t* dst = reinterpret_cast<int16_t*>(st) + s * kTile;
      cp_async16(dst + t * 8, src + t * 8, bytes);
    }
  };

  // x0 column t and mask row t of this thread's block of group `c`, read
  // straight into registers (in compose mode they are shared by the images
  // and come from L2); zeros past the image's end
  auto fetch = [&](const Cursor& c, float (&fx)[8], float (&fm)[8]) {
    const int jj = c.j0 + s;
    if (jj < hw) {
      const long long dm = c.dm + (long long)jj * 64;
#pragma unroll
      for (int k = 0; k < 8; ++k) fx[k] = __ldg(p.x0 + dm + k * 8 + t);
      const float4* pm = reinterpret_cast<const float4*>(p.mask + dm + t * 8);
      const float4 a = __ldg(pm), b = __ldg(pm + 1);
      fm[0] = a.x; fm[1] = a.y; fm[2] = a.z; fm[3] = a.w;
      fm[4] = b.x; fm[5] = b.y; fm[6] = b.z; fm[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) fx[k] = fm[k] = 0.f;
    }
  };

  Cursor ld(p, g0, gpi);
  Cursor cu = ld;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < count) {
      issue(ld, k);
      ld.next(p, hw);
    }
    cp_async_commit();
  }

  // x0/mask of the current group, and of the next one, in flight while the
  // current one is transformed
  float cx0[8], cm[8], nx0[8], nm[8];
  fetch(cu, cx0, cm);
  // compose mode: this thread's column of the current image's quant table,
  // as f32 and as its f32 reciprocal (reloaded when the image changes)
  float qf[8], rq[8];
  int q_image = -1;
  int slot = 0;
  for (int it = 0; it < count; ++it) {
    // keep kStages - 1 groups in flight: refill the stage freed last round
    if (it + kStages - 1 < count) {
      issue(ld, slot == 0 ? kStages - 1 : slot - 1);
      ld.next(p, hw);
    }
    cp_async_commit();
    Cursor nc = cu;
    nc.next(p, hw);
    if (it + 1 < count) fetch(nc, nx0, nm);
    cp_async_wait<kStages - 1>();  // this thread's copies of group g landed
    __syncwarp();                  // ... and its block's other lanes' too

    if constexpr (!kBlend) {
      if (cu.i != q_image) {
        const int32_t* q = p.quant + (long long)cu.i * p.q_si + t;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          qf[k] = (float)q[k * 8];
          rq[k] = 1.0f / qf[k];
        }
        q_image = cu.i;
      }
    }

    unsigned char* st = smem + slot * L::kStage;
    int16_t* reg = reinterpret_cast<int16_t*>(st) + s * kTile;
    float* tr = trans + s * kTile;  // this block's 8 x kTRow tile

    // column t: x1 (dequantized) and x0 - x1
    float x1[8], v[8], a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (kBlend) {
        x1[k] = reinterpret_cast<const float*>(st)[s * kTile + k * 8 + t];
      } else {
        x1[k] = __fmul_rn((float)reg[k * 8 + t], qf[k]);
      }
      v[k] = __fsub_rn(cx0[k], x1[k]);
    }
    mul_ct(v, a);                  // column t of C^T X
#pragma unroll
    for (int k = 0; k < 8; ++k) tr[k * kTRow + t] = a[k];
    __syncwarp();
#pragma unroll
    for (int l = 0; l < 8; ++l) v[l] = tr[t * kTRow + l];
    mul_ct(v, a);                  // row t of P = C^T X C
#pragma unroll
    for (int l = 0; l < 8; ++l) a[l] = __fmul_rn(a[l], cm[l]);
    mul_c(a, v);                   // row t of T C^T
    __syncwarp();                  // every lane has read its row of tr
#pragma unroll
    for (int j = 0; j < 8; ++j) tr[t * kTRow + j] = v[j];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = tr[k * kTRow + t];
    mul_c(a, v);                   // column t of C T C^T

    const int jj = cu.j0 + s;
    const long long off =
        cu.out + (jj < hw ? block_at(jj, p.out_sy) : 0) + t * 8;
    if constexpr (kBlend) {
      // y = x1 + C T C^T, column t, staged in tr for row-wise stores
      __syncwarp();                // every lane has read its column of tr
#pragma unroll
      for (int k = 0; k < 8; ++k) tr[k * kTRow + t] = __fadd_rn(x1[k], v[k]);
      __syncwarp();
      if (jj < hw) {
        float* dst = static_cast<float*>(p.out) + off;
        *reinterpret_cast<float4*>(dst) =
            make_float4(tr[t * kTRow + 0], tr[t * kTRow + 1],
                        tr[t * kTRow + 2], tr[t * kTRow + 3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(tr[t * kTRow + 4], tr[t * kTRow + 5],
                        tr[t * kTRow + 6], tr[t * kTRow + 7]);
      }
    } else {
      // An opaque block (every mask value exactly 1) has an integer exact
      // result, acc - x1 = x0 - x1, so any rounding decides which side of
      // it the truncation falls on, and the separable order's rounding
      // would part from the plain version's on a few percent of its
      // coefficients.  Such a block is recomputed in the plain version's
      // own order (dense_blocks), which reproduces its result bit for bit.
      bool one = jj < hw;
#pragma unroll
      for (int l = 0; l < 8; ++l) one &= cm[l] == 1.0f;
      const unsigned ones = __ballot_sync(0xffffffffu, one);
      unsigned opaque = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        opaque |= (((ones >> (8 * b)) & 0xffu) == 0xffu ? 1u : 0u) << b;
      if (opaque) {                  // the same for every lane
        __syncwarp();                // every lane has read its column of tr
#pragma unroll
        for (int k = 0; k < 8; ++k) tr[k * 8 + t] = __fsub_rn(cx0[k], x1[k]);
        __syncwarp();
        dense_blocks(trans + (s & ~3) * kTile, p.u, p.ut, lane);
        if ((opaque >> (s & 3)) & 1u) {
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = tr[k * 8 + t];
        }
      }
      // requantize column t.  Where |x1| and |acc| are below 2^19 (every
      // 8-bit JPEG coefficient) the integers r*q, corr and vq are exact in
      // f32 and |vq| < 2^21, so floor(|vq| / q) = trunc((|vq| + 0.5) * rcp(q))
      // exactly: the product's error stays under 0.25 / q.  A column with
      // any larger value takes the int32 path, the plain version's own
      // arithmetic.
      int o[8];
      float big = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float acc = __fadd_rn(x1[k], v[k]);
        big = fmaxf(big, fmaxf(fabsf(x1[k]), fabsf(acc)));
        const float vq = __fadd_rn(x1[k], truncf(__fsub_rn(acc, x1[k])));
        const float f = __fmul_rn(__fadd_rn(fabsf(vq), 0.5f), rq[k]);
        o[k] = (int)fminf(fmaxf(copysignf(f, vq), -32768.0f), 32767.0f);
      }
      if (!(big < 524288.0f)) {
        const int32_t* q = p.quant + (long long)cu.i * p.q_si + t;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float acc = __fadd_rn(x1[k], v[k]);
          const int corr = (int)truncf(__fsub_rn(acc, x1[k]));
          const int vq = (int)reg[k * 8 + t] * q[k * 8] + corr;
          const int r = vq / q[k * 8];
          o[k] = r < -32768 ? -32768 : (r > 32767 ? 32767 : r);
        }
      }
      // the result replaces the region in this stage (each lane writes the
      // values it alone read) and leaves as one 16-byte row per lane
#pragma unroll
      for (int k = 0; k < 8; ++k) reg[k * 8 + t] = (int16_t)o[k];
      __syncwarp();
      if (jj < hw) {
        *reinterpret_cast<uint4*>(static_cast<int16_t*>(p.out) + off) =
            *reinterpret_cast<const uint4*>(reg + t * 8);
      }
    }
    __syncwarp();  // tr and this stage are free for the next group

    cu = nc;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cx0[k] = nx0[k];
      cm[k] = nm[k];
    }
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// One resident wave: SMs x CTAs per SM (occupancy API, at the mode's
// dynamic shared memory), each CTA taking a contiguous range of groups.
// Returns the launch's cudaGetLastError().
template <bool kBlend>
int launch(const Rows& p, cudaStream_t stream) {
  constexpr int bytes = Layout<kBlend>::kBytes;
  const long long hw = p.h * p.w;
  if (p.n <= 0 || hw <= 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(blocks_kernel<kBlend>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, blocks_kernel<kBlend>, kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long groups = p.n * ((hw + kGroup - 1) / kGroup);
  const long long cap = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(groups < cap ? groups : cap);
  blocks_kernel<kBlend><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// region: int16, n images of h block rows of w blocks; block (i, y, b) at
// element i * region_si + y * region_sy + b * 64, its 64 coefficients
// contiguous.  out: int16, the same geometry at out_si / out_sy (it may be
// region itself; it must not otherwise overlap it).  quant: int32 [64] per
// image at element stride quant_si (0: one table for all; every value
// >= 1).  dropon/mask: f32 [h * w, 64] per image at element stride dm_si
// (0: shared).  u/ut: the plain version's f32 U = C (x) C and its
// transpose, [64, 64] row-major each (for opaque blocks).  Every pointer
// 16-byte aligned and every stride a multiple of 64 elements, on the
// current device.  Launches on `stream`; returns
// the launch's cudaGetLastError() (0 on success).
extern "C" int mjt_compose_rows(const void* region, long long region_si,
                                long long region_sy, const void* quant,
                                long long quant_si, const void* dropon,
                                const void* mask, long long dm_si, void* out,
                                long long out_si, long long out_sy,
                                long long n, long long h, long long w,
                                const void* u, const void* ut, void* stream) {
  Rows p;
  p.image = region;
  p.x0 = static_cast<const float*>(dropon);
  p.mask = static_cast<const float*>(mask);
  p.quant = static_cast<const int32_t*>(quant);
  p.out = out;
  p.n = n;
  p.h = h;
  p.w = w;
  p.img_si = region_si;
  p.img_sy = region_sy;
  p.out_si = out_si;
  p.out_sy = out_sy;
  p.dm_si = dm_si;
  p.q_si = quant_si;
  p.u = static_cast<const float*>(u);
  p.ut = static_cast<const float*>(ut);
  return launch<false>(p, (cudaStream_t)stream);
}

// image (x1)/x0/mask/out (y): [n, 64] f32, contiguous and 16-byte aligned,
// on the current device.  Launches on `stream`; returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int mjt_blend_blocks(const void* image, const void* x0,
                                const void* mask, void* out, long long n,
                                void* stream) {
  Rows p;
  p.image = image;
  p.x0 = static_cast<const float*>(x0);
  p.mask = static_cast<const float*>(mask);
  p.quant = nullptr;
  p.u = p.ut = nullptr;
  p.out = out;
  p.n = 1;
  p.h = 1;
  p.w = n;
  p.img_si = p.out_si = p.dm_si = p.q_si = 0;
  p.img_sy = p.out_sy = 0;
  return launch<true>(p, (cudaStream_t)stream);
}
