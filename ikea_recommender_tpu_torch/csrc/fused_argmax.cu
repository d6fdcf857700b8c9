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
// Precision of the products: "highest" fp32, "high" bf16x3, "default" one
// bf16 pass, as B1. B5 in "high" and "default" runs on the bf16 tensor
// cores (mma_tile.cuh); B6, and B5 in "highest", on the CUDA cores
// (head_tile.cuh: fp32 FMAs, three per multiply-accumulate in "high").
//
// What bounds it: at the sqn train point (B=256, F=64, A=70852) B5 reads W
// once (18.1 MB, 0.0054 ms at 3.35 TB/s) and does 2 B F A = 2.32 GFLOP per
// pass; in "high" (three passes on bf16 tensor cores, 989 TFLOP/s) that is
// 0.00704 ms, so operations bound it. B6 at smorl's K = 3 reads 54.4 MB and
// does three times the operations: 0.0211 ms. B6 on the CUDA cores (67
// TFLOP/s fp32) sits far above that; moving it onto the tensor-core tile is
// the next kernel work. At B = 1 B5 is bound by W's bytes.
//
// Design: the TPU walks column blocks in order, carrying a running (max,
// argmax) from one grid step to the next with a strict > (earlier blocks win
// ties) and the lowest id inside a block. Here each block owns 128 columns
// and writes per row the (max, lowest column at the max) of its columns; a
// merge kernel, one warp a row, keeps the larger max and, on equal maxima,
// the lower column. That is the TPU kernel's rule in any order of blocks.
// - B5 in "high" and "default" (argmax_mma_kernel): the block splits its
//   128 columns of W into bf16 planes once (W is read from device memory
//   once) and walks all of B in tiles of 64 rows of h (re-read from L2 by
//   every block), each split as it is staged; per row tile the mma
//   accumulators get the bias and the mask, then (max, lowest column) over
//   the C fragment, the quad's shuffles and the two warps of a row.
// - B6, and "highest" (argmax_tile_kernel): the block owns 64 rows x 128
//   columns and computes its tile of v in registers (head_tile.cuh's
//   logits tile, once per head for B6, summed into a second register tile).

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "head_tile.cuh"
#include "mma_tile.cuh"

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

// B5 in "high" and "default" on the bf16 tensor cores (mma_tile.cuh): the
// block owns 128 columns, splits W's columns into planes once, and loops
// over all of B in tiles of 64 rows of h, split as each is staged. W and
// the h tiles come through a staging buffer by cp.async (16 bytes a copy
// where rows allow it), the next tile in flight while the block computes
// the current one. Eight warps; warp (wr, wc) = (warp % 4, warp / 4)
// computes rows 16 wr.. at columns 64 wc.. of the tile; the two column
// halves of a row meet in shared memory.
constexpr int kMmaRows = 64, kMmaLdW = kTileCols + 8;

// W's and h's planes, the staging buffer (W's F x 128 columns, or two h
// tiles of 64 x F), and the two halves' (max, column) of 64 rows.
__host__ __device__ inline size_t argmax_mma_smem(int F, int P) {
  const size_t fp = (F + 15) / 16 * 16, planes = P == 1 ? 2 : 1;
  return 2 * planes * (fp * kMmaLdW + (size_t)kMmaRows * (fp + 8)) +
         4 * (size_t)F * kTileCols + 8 * 2 * kMmaRows;
}

template <int P>
__global__ void __launch_bounds__(kTileThreads)
argmax_mma_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ part_max,
                  int* __restrict__ part_idx, int B, int F, int A, int valid, int vec_w,
                  int vec_h) {
  using namespace mma_tile;
  constexpr bool LO = P == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fp = (F + 15) / 16 * 16;
  unsigned char* p = smem_raw;
  auto planes = [&](int n_rows, int ld) {
    Planes s{reinterpret_cast<bf16*>(p), nullptr, ld};
    p += 2 * (size_t)n_rows * ld;
    if (LO) {
      s.lo = reinterpret_cast<bf16*>(p);
      p += 2 * (size_t)n_rows * ld;
    }
    return s;
  };
  const Planes ws = planes(fp, kMmaLdW);       // W's columns (fp, 128), >= valid 0
  const Planes hs = planes(kMmaRows, fp + 8);  // the tile's rows of h (64, fp)
  float* stage = reinterpret_cast<float*>(p);  // (F, 128) or 2 x (64, F)
  float* red_m = stage + (size_t)F * kTileCols;  // (2 column halves, 64 rows)
  int* red_i = reinterpret_cast<int*>(red_m + 2 * kMmaRows);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4, wr = warp % 4, wc = warp / 4;
  const int n0 = blockIdx.x * kTileCols, nblk = gridDim.x;

  fetch_cols<kTileCols, kTileThreads>(stage, w, F, A, n0, vec_w);
  // this thread's columns: n0 + 64 wc + 16 i + 8 t + 2 q + e
  float bcol[4][2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 64 * wc + 16 * i + 8 * t + 2 * q + e;
        bcol[i][t][e] = col < valid ? bias[col] : 0.0f;
      }
  cp_async_wait<0>();
  __syncthreads();
  split_cols<P, kTileCols, kTileThreads>(ws, stage, F, fp, n0, valid);
  __syncthreads();  // the staging buffer is free for h

  // rows m0.. of h (a contiguous run of whole rows) into buffer `buf`; with
  // vec_h (F % 4 == 0, h 16-byte aligned) in 16-byte copies
  const int n_tiles = (B + kMmaRows - 1) / kMmaRows;
  auto fetch = [&](int tile) {
    const int m0 = tile * kMmaRows, n = (B - m0 < kMmaRows ? B - m0 : kMmaRows) * F;
    const float* src = h + (size_t)m0 * F;
    float* dst = stage + (tile % 2) * kMmaRows * F;
    if (vec_h) {
      for (int i = 4 * tid; i < n; i += 4 * kTileThreads) cp_async16(dst + i, src + i);
    } else {
      for (int i = tid; i < n; i += kTileThreads) cp_async4(dst + i, src + i);
    }
    cp_async_commit();
  };
  fetch(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int m0 = tile * kMmaRows;
    if (tile + 1 < n_tiles) {
      fetch(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile has landed; the previous tile's readers are done
    const float* cur = stage + (tile % 2) * kMmaRows * F;
    for (int e = tid; e < kMmaRows * fp / 2; e += kTileThreads) {
      const int r = e / (fp / 2), k = 2 * (e % (fp / 2));
      const bool live = m0 + r < B;
      store_split2<P>(hs, r * hs.ld + k, live && k < F ? cur[r * F + k] : 0.0f,
                      live && k + 1 < F ? cur[r * F + k + 1] : 0.0f);
    }
    __syncthreads();

    float acc[4][2][4] = {};
    for (int k0 = 0; k0 < fp; k0 += 16) {
      Frag a;
      load_a<P>(a, hs, 16 * wr, k0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Frag b;
        load_b<P>(b, ws, k0, 64 * wc + 16 * i);
        mma_pair<P>(acc[i], a, b);
      }
    }

    // per row (g, g + 8): (max, lowest column at the max) over the thread's
    // columns, then over the quad; columns >= A take no part
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float m = -CUDART_INF_F;
      int idx = INT_MAX;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + 64 * wc + 16 * i + 8 * t + 2 * q + e;
            if (col < A)
              take_better(m, idx, col < valid ? acc[i][t][2 * hr + e] + bcol[i][t][e] : kNeg, col);
          }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m, o);
        const int io = __shfl_xor_sync(0xffffffffu, idx, o);
        take_better(m, idx, mo, io);
      }
      if (q == 0) {
        const int r = 16 * wr + g + 8 * hr;
        red_m[wc * kMmaRows + r] = m;
        red_i[wc * kMmaRows + r] = idx;
      }
    }
    __syncthreads();
    if (tid < kMmaRows && m0 + tid < B) {
      float m = red_m[tid];
      int idx = red_i[tid];
      take_better(m, idx, red_m[kMmaRows + tid], red_i[kMmaRows + tid]);
      part_max[(size_t)(m0 + tid) * nblk + blockIdx.x] = m;
      part_idx[(size_t)(m0 + tid) * nblk + blockIdx.x] = idx;
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

cudaError_t launch_merge(const float* part_max, const int* part_idx, long long* idx, float* mx,
                         int B, int nblk, cudaStream_t st) {
  const int rows_per_block = kTileThreads / 32;
  argmax_merge_kernel<<<(B + rows_per_block - 1) / rows_per_block, kTileThreads, 0, st>>>(
      part_max, part_idx, idx, mx, B, nblk);
  return cudaGetLastError();
}

template <int P>
int launch_argmax_mma(const float* h, const float* w, const float* b, long long* idx, float* mx,
                      float* part_max, int* part_idx, int B, int F, int A, int valid,
                      cudaStream_t st) {
  static size_t allowed[mma_tile::kMaxDevices] = {};
  const size_t smem = argmax_mma_smem(F, P);
  cudaError_t err = mma_tile::allow_smem((const void*)argmax_mma_kernel<P>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (A + kTileCols - 1) / kTileCols;
  const int vec_w = A % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec_h = F % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  argmax_mma_kernel<P><<<nblk, kTileThreads, smem, st>>>(h, w, b, part_max, part_idx, B, F, A,
                                                         valid, vec_w, vec_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_max, part_idx, idx, mx, B, nblk, st);
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
  if (qw == nullptr && precision == 1)
    return launch_argmax_mma<1>(h, w, b, idx, mx, part_max, part_idx, B, F, A, valid, st);
  if (qw == nullptr && precision == 2)
    return launch_argmax_mma<2>(h, w, b, idx, mx, part_max, part_idx, B, F, A, valid, st);
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
  return (int)launch_merge(part_max, part_idx, idx, mx, B, (int)grid.x, st);
}
