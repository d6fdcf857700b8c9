// The CUDA-core tile of the head kernels in "highest": B1 (fused_ce.cu), B5
// and B6 (fused_argmax.cu) as fp32 FMAs, the TPU kernels' _dot at
// Precision.HIGHEST. In "high" and "default" B1, B5 and B6 run on the bf16
// tensor cores instead (mma_tile.cuh's head walk), and B2 has kernels of its
// own.
#pragma once

#include <cuda_runtime.h>

namespace head_tile {

// The masked-logit sentinel of the TPU kernels: finite, so a running max
// or a merge never sees inf - inf.
constexpr float kNeg = -1e30f;

// The logits tile: a block of kTileThreads threads owns kTileRows rows and
// kTileCols columns; thread (tx, ty) = (tid % 16, tid / 16) holds the 4 x 8
// entries at rows ty + 16 i and columns tx + 16 j. F goes through shared
// memory in chunks of kTileK.
constexpr int kTileThreads = 256, kTileRows = 64, kTileCols = 128, kTileK = 16;

// With AM (B5 and B6 on an action-major W) the rows of w's tile are padded
// by one float, so that its transposing stores fall on distinct banks.
template <bool AM>
struct TileSmemT {
  float h[kTileRows][kTileK + 1];
  float w[kTileK][kTileCols + (AM ? 1 : 0)];
};
using TileSmem = TileSmemT<false>;

// acc[i][j] = (h W)[m0 + ty + 16 i, n0 + tx + 16 j] in fp32, for h (B, F)
// and W (F, A) contiguous; rows >= B and columns >= A read as 0, so nothing
// past either array is read. With AM, W is read action-major: column n of
// W is w[n ld ..], F floats (`w` at the head's first float, ld = K F), read
// along F by neighbouring threads. Every thread of the block must call it;
// it leaves `s` free for the next call.
template <bool AM>
__device__ __forceinline__ void logits_tile(const float* __restrict__ h,
                                            const float* __restrict__ w, int B, int F, int A,
                                            int m0, int n0, TileSmemT<AM>& s, float (&acc)[4][8],
                                            int ld = 0) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < F; k0 += kTileK) {
    for (int e = tid; e < kTileRows * kTileK; e += kTileThreads) {
      const int m = e / kTileK, k = e % kTileK;
      s.h[m][k] = (m0 + m < B && k0 + k < F) ? h[(size_t)(m0 + m) * F + k0 + k] : 0.0f;
    }
    for (int e = tid; e < kTileK * kTileCols; e += kTileThreads) {
      if constexpr (AM) {
        const int k = e % kTileK, n = e / kTileK;
        s.w[k][n] = (k0 + k < F && n0 + n < A) ? w[(size_t)(n0 + n) * ld + k0 + k] : 0.0f;
      } else {
        const int k = e / kTileCols, n = e % kTileCols;
        s.w[k][n] = (k0 + k < F && n0 + n < A) ? w[(size_t)(k0 + k) * A + n0 + n] : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTileK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.h[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = s.w[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace head_tile
