// The CUDA-core tile of the head kernels: the named precisions of the TPU
// kernels' _dot/_dot3 as fp32 FMAs, and the (64 rows x 128 columns) logits
// tile. It serves B1 (fused_ce.cu) and B6 (fused_argmax.cu) at every
// precision, and B2 and B5 in "highest". B2 and B5 in "high" and "default"
// run on the bf16 tensor cores instead (mma_tile.cuh).
//
// Precision P of a product, as ikea_recommender_tpu/ops/fused_ce.py::_dot:
//   0 "highest": fp32 FMA.
//   1 "high": each operand x is split into hi = bf16(x), lo = bf16(x - hi),
//     and the product is hi*hi + hi*lo + lo*hi summed in fp32. A product of
//     two bf16 values is exact in fp32, so this is the TPU's bf16x3 function
//     up to the order of the sums.
//   2 "default": bf16(a) * bf16(b) summed in fp32.
// Here "high" costs three FMAs per multiply-accumulate on the 67 TFLOP/s
// fp32 CUDA cores, so B1 and B6 sit 35-40x above their tensor-core bounds
// (fused_ce.cu, fused_argmax.cu); they are the next to move onto
// mma_tile.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace head_tile {

// The masked-logit sentinel of the TPU kernels: finite, so a running max
// or a merge never sees inf - inf.
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// hi and lo parts of x for precision P (lo is used by P == 1 only).
template <int P>
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  if constexpr (P == 0) {
    hi = x;
    lo = 0.0f;
  } else {
    hi = bf16_round(x);
    lo = P == 1 ? bf16_round(x - hi) : 0.0f;
  }
}

template <int P>
__device__ __forceinline__ float mac(float ahi, float alo, float bhi, float blo, float acc) {
  acc = fmaf(ahi, bhi, acc);
  if constexpr (P == 1) {
    acc = fmaf(ahi, blo, acc);
    acc = fmaf(alo, bhi, acc);
  }
  return acc;
}

// The logits tile: a block of kTileThreads threads owns kTileRows rows and
// kTileCols columns; thread (tx, ty) = (tid % 16, tid / 16) holds the 4 x 8
// entries at rows ty + 16 i and columns tx + 16 j. F goes through shared
// memory in chunks of kTileK.
constexpr int kTileThreads = 256, kTileRows = 64, kTileCols = 128, kTileK = 16;

template <int P>
struct TileSmem {
  float h_hi[kTileRows][kTileK + 1], h_lo[P == 1 ? kTileRows : 1][kTileK + 1];
  float w_hi[kTileK][kTileCols], w_lo[P == 1 ? kTileK : 1][kTileCols];
};

// acc[i][j] = (h W)[m0 + ty + 16 i, n0 + tx + 16 j] at precision P, for
// h (B, F) and W (F, A) contiguous; rows >= B and columns >= A read as 0, so
// nothing past either array is read. Every thread of the block must call it;
// it leaves `s` free for the next call.
template <int P>
__device__ __forceinline__ void logits_tile(const float* __restrict__ h,
                                            const float* __restrict__ w, int B, int F, int A,
                                            int m0, int n0, TileSmem<P>& s, float (&acc)[4][8]) {
  constexpr bool LO = P == 1;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < F; k0 += kTileK) {
    for (int e = tid; e < kTileRows * kTileK; e += kTileThreads) {
      const int m = e / kTileK, k = e % kTileK;
      const float x = (m0 + m < B && k0 + k < F) ? h[(size_t)(m0 + m) * F + k0 + k] : 0.0f;
      float hi, lo;
      split<P>(x, hi, lo);
      s.h_hi[m][k] = hi;
      if constexpr (LO) s.h_lo[m][k] = lo;
    }
    for (int e = tid; e < kTileK * kTileCols; e += kTileThreads) {
      const int k = e / kTileCols, n = e % kTileCols;
      const float x = (k0 + k < F && n0 + n < A) ? w[(size_t)(k0 + k) * A + n0 + n] : 0.0f;
      float hi, lo;
      split<P>(x, hi, lo);
      s.w_hi[k][n] = hi;
      if constexpr (LO) s.w_lo[k][n] = lo;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTileK; ++k) {
      float ahi[4], alo[4], bhi[8], blo[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ahi[i] = s.h_hi[ty + 16 * i][k];
        alo[i] = LO ? s.h_lo[ty + 16 * i][k] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bhi[j] = s.w_hi[k][tx + 16 * j];
        blo[j] = LO ? s.w_lo[k][tx + 16 * j] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = mac<P>(ahi[i], alo[i], bhi[j], blo[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace head_tile
