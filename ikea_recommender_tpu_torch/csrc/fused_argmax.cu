// B5 and B6 on Hopper: the argmax over the catalog of a linear head (B5) or
// of a weighted sum of K linear heads (B6), without writing the (B, A)
// logits.
//
// Replaces ikea_recommender_tpu/ops/fused_argmax.py::_argmax_kernel (B5,
// launched by fused_linear_argmax) and ::_wargmax_kernel (B6, launched by
// fused_weighted_multihead_argmax), in their canonical layouts: W (F, A) for
// B5 and (K, F, A) for B6; the action-major forms are not ported yet. With
//   B5: v[i, col] = (h W + b)[i, col]
//   B6: v[i, col] = sum_k qw[k] * ((h W_k)[i, col] + b[k, col]), summed in
//       k order from 0 with separate roundings (no fused multiply-add), as
//       the TPU kernel and the plain twin sum it,
// and v masked to -1e30 at columns col >= valid_dim (a runtime argument) before
// any comparison, the outputs are idx[i] = the lowest col at which v[i, :]
// is largest (jnp.argmax's rule), and mx[i] = that largest value.
// Layouts, all contiguous: h (B, F), W as above, b (A) or (K, A), qw (K),
// all fp32; idx (B) int64, mx (B) fp32. Columns >= valid_dim of W and b may
// hold anything, NaN included: they never reach a comparison. Nothing past A
// is read.
//
// Precision of the products: head_tile.cuh ("highest", "high" bf16x3,
// "default"), as B1.
//
// What bounds it: at the sqn train point (B=256, F=64, A=70852) B5 reads W
// once (18.1 MB, 0.0054 ms at 3.35 TB/s) and does 2 B F A = 2.32 GFLOP per
// pass; in "high" (three passes on bf16 tensor cores, 989 TFLOP/s) that is
// 0.00704 ms, so operations bound it. B6 at smorl's K = 3 reads 54.4 MB and
// does three times the operations: 0.0211 ms. Here every product runs on
// the CUDA cores (67 TFLOP/s fp32), three FMAs each in "high", so the
// kernels sit far above those bounds; tensor cores are later work.
//
// Design: the TPU walks column blocks in order, carrying a running (max,
// argmax) from one grid step to the next with a strict > (earlier blocks win
// ties) and the lowest id inside a block. Here each block owns 64 rows x 128
// columns, computes its tile of v in registers (head_tile.cuh's logits tile,
// once per head for B6, summed into a second register tile), and writes per
// row the (max, lowest column at the max) of its columns; a merge kernel, one
// warp a row, keeps the larger max and, on equal maxima, the lower column.
// That is the TPU kernel's rule in any order of blocks.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "head_tile.cuh"

namespace {

using namespace head_tile;

// (m, i) wins over (mo, io): the larger value, the lower column on a tie.
__device__ __forceinline__ void take_better(float& m, int& i, float mo, int io) {
  if (mo > m || (mo == m && io < i)) {
    m = mo;
    i = io;
  }
}

// Per (row, column block): the block's (max, lowest column at the max) of v.
// qw == nullptr is B5 (K = 1, v = h W + b).
template <int P>
__global__ void __launch_bounds__(kTileThreads)
argmax_tile_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ qw,
                   float* __restrict__ part_max, int* __restrict__ part_idx, int B, int F, int A,
                   int K, int valid) {
  __shared__ TileSmem<P> smem;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kTileCols, m0 = blockIdx.y * kTileRows;

  float v[4][8];
  for (int k = 0; k < K; ++k) {
    float acc[4][8];
    logits_tile<P>(h, w + (size_t)k * F * A, B, F, A, m0, n0, smem, acc);
    const float q = qw == nullptr ? 1.0f : qw[k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      const float bk = col < A ? bias[(size_t)k * A + col] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float l = __fadd_rn(acc[i][j], bk);
        if (qw == nullptr)
          v[i][j] = l;
        else
          v[i][j] = __fadd_rn(k == 0 ? 0.0f : v[i][j], __fmul_rn(q, l));
      }
    }
  }

  // Per row over this block's columns; the 16 threads of a row (equal ty)
  // are one half-warp. Columns >= A (the edge block's tail) take no part.
  const int nblk = gridDim.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float m = -CUDART_INF_F;
    int idx = INT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < A) take_better(m, idx, col < valid ? v[i][j] : kNeg, col);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, o);
      const int io = __shfl_xor_sync(0xffffffffu, idx, o);
      take_better(m, idx, mo, io);
    }
    const int row = m0 + ty + 16 * i;
    if (tx == 0 && row < B) {
      part_max[(size_t)row * nblk + blockIdx.x] = m;
      part_idx[(size_t)row * nblk + blockIdx.x] = idx;
    }
  }
}

// One warp per row merges the row's nblk partials.
__global__ void __launch_bounds__(kTileThreads)
argmax_merge_kernel(const float* __restrict__ part_max, const int* __restrict__ part_idx,
                    long long* __restrict__ out_idx, float* __restrict__ out_max, int B,
                    int nblk) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kTileThreads / 32) + threadIdx.x / 32;
  if (row >= B) return;
  float m = -CUDART_INF_F;
  int idx = INT_MAX;
  for (int i = lane; i < nblk; i += 32)
    take_better(m, idx, part_max[(size_t)row * nblk + i], part_idx[(size_t)row * nblk + i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const int io = __shfl_xor_sync(0xffffffffu, idx, o);
    take_better(m, idx, mo, io);
  }
  if (lane == 0) {
    out_idx[row] = idx;
    out_max[row] = m;
  }
}

}  // namespace

// Entries of each of the two scratch arrays (float max, int32 column) that
// fused_argmax needs for (B, A): one per (row, column block).
extern "C" long long fused_argmax_scratch(int B, int A) {
  return (long long)B * ((A + kTileCols - 1) / kTileCols);
}

// Launches B5 (qw == NULL, K == 1) or B6 on `stream`: idx (B) int64 and mx
// (B) fp32 of the argmax described above. Returns cudaGetLastError() (0 on
// success).
extern "C" int fused_argmax(const float* h, const float* w, const float* b, const float* qw,
                            long long* idx, float* mx, float* part_max, int* part_idx, int B,
                            int F, int A, int K, int valid, int precision, void* stream) {
  if (B < 1 || F < 1 || A < 1 || K < 1 || (qw == nullptr && K != 1) || valid < 0 ||
      valid > A || precision < 0 || precision > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((A + kTileCols - 1) / kTileCols, (B + kTileRows - 1) / kTileRows);
  if (precision == 0)
    argmax_tile_kernel<0><<<grid, kTileThreads, 0, st>>>(h, w, b, qw, part_max, part_idx, B, F, A,
                                                         K, valid);
  else if (precision == 1)
    argmax_tile_kernel<1><<<grid, kTileThreads, 0, st>>>(h, w, b, qw, part_max, part_idx, B, F, A,
                                                         K, valid);
  else
    argmax_tile_kernel<2><<<grid, kTileThreads, 0, st>>>(h, w, b, qw, part_max, part_idx, B, F, A,
                                                         K, valid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = kTileThreads / 32;
  argmax_merge_kernel<<<(B + rows_per_block - 1) / rows_per_block, kTileThreads, 0, st>>>(
      part_max, part_idx, idx, mx, B, (int)grid.x);
  return (int)cudaGetLastError();
}
