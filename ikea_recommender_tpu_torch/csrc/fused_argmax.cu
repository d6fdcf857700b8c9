// B5 and B6 on Hopper: the argmax over the catalog of a linear head (B5) or
// of a weighted sum of K linear heads (B6), without writing the (B, A)
// logits.
//
// Replaces ikea_recommender_tpu/ops/fused_argmax.py::_argmax_kernel (B5,
// launched by fused_linear_argmax) and ::_wargmax_kernel (B6, launched by
// fused_weighted_multihead_argmax), in both layouts of W: canonical, (F, A)
// for B5 and (K, F, A) for B6, and action-major (the TPU kernels' am=True,
// the lazy optimizers' layout, train/lazy_adam.py), (A, F) for B5 and
// (A, K F) for B6, head k's column a at w_am[a K F + k F ..]. With
//   B5: v[i, col] = (h W + b)[i, col]
//   B6: v[i, col] = sum_k qw[k] * ((h W_k)[i, col] + b[k, col]), summed in
//       k order from 0 with separate roundings (no fused multiply-add), as
//       the TPU kernel and the plain twin sum it,
// and v masked to -1e30 at columns col >= valid_dim (a runtime argument) before
// any comparison, the outputs are idx[i] = the lowest col at which v[i, :]
// is largest (jnp.argmax's rule), and mx[i] = that largest value.
// Layouts, all contiguous: h (B, F), W as above, b (A) or (K, A), qw (K),
// all fp32; idx (B) int64, mx (B) fp32. Columns >= valid_dim of W (rows of
// an action-major W) and b may hold anything, NaN included: they never reach
// a comparison. Nothing past A is read.
//
// Precision of the products: "highest" fp32, "high" bf16x3, "default" one
// bf16 pass, as B1. In "high" and "default" both run on the bf16 tensor
// cores (mma_tile.cuh's head walk, shared with B1) and take F <= 128 and,
// for B6, K <= 5; "highest" runs on the CUDA cores (head_tile.cuh: fp32
// FMAs) and takes any F and K.
//
// What bounds it: at the sqn train point (B=256, F=64, A=70852) B5 reads W
// once (18.1 MB, 0.0054 ms at 3.35 TB/s) and does 2 B F A = 2.32 GFLOP per
// pass; in "high" (three passes on bf16 tensor cores, 989 TFLOP/s) that is
// 0.00704 ms, so operations bound it. B6 at smorl's K = 3 reads 54.4 MB and
// does three times the operations: 0.0211 ms. In "default" (the fast
// preset's, one bf16 pass: 0.0023 ms for B5) the bytes bound both: 0.0054 ms
// for B5 and 0.0162 ms for B6 at K = 3, in either layout. At B = 1 B5 is
// bound by W's bytes.
//
// Design: the TPU walks column blocks in order, carrying a running (max,
// argmax) from one grid step to the next with a strict > (earlier blocks win
// ties) and the lowest id inside a block. Here each block owns a range of
// columns and writes per row the (max, lowest column at the max) of its
// columns; a merge kernel, one warp a row, keeps the larger max and, on
// equal maxima, the lower column. That is the TPU kernel's rule in any
// order of blocks.
// - "high" and "default" (argmax_mma_kernel): the head walk splits the
//   block's columns of W (all K heads for B6, so W is read from device
//   memory once) into bf16 planes once and walks all of B in tiles of 64
//   rows of h (re-read from L2 by every block), each split as it is staged.
//   Per row tile the epilogue takes the C fragments: B5 adds the bias and
//   the mask; B6 keeps v = fadd(v, fmul(q_k, fadd(acc_k, b_k))) in
//   registers over the heads, with the block's biases in shared memory;
//   then (max, lowest column) over the thread's columns, the quad's shuffles
//   and the two column warps of a row. q is never folded into W: that would
//   round another function. B5's block owns 128 columns. B6's owns 128, 64
//   or 32: the widest at which two blocks share an SM, else the widest that
//   fits one (wargmax_cols). At smorl's K = 3, F = 64 that is 64 in "high"
//   (two blocks of 108 KB an SM; 128 columns would take 158 KB) and 128 in
//   "default"; scripts/torch_b6_columns.py times the three counts there,
//   and this choice was the fastest in both. K = 5 at F = 128 in "high"
//   takes 32 (204 KB).
// - "highest" (argmax_tile_kernel): the block owns 64 rows x 128 columns
//   and computes its tile of v in registers (head_tile.cuh's logits tile,
//   once per head for B6, summed into a second register tile).
// - Action-major: only the staging of W changes. The head walk copies the
//   block's COLS rows of W, F contiguous floats of each head (16-byte
//   cp.async where F % 4 == 0), into a staging buffer of row stride F + 4
//   and transposes them into the same (F, COLS) bf16 planes (mma_tile.cuh's
//   fetch_rows_am and split_rows_am, free of bank conflicts at F = 64); the
//   CUDA-core tile reads W's rows along F. The planes, the products, the
//   epilogues, the grid and the merge are the canonical form's, so both
//   forms give the same bits on the same values. W is never laid out again.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "head_tile.cuh"
#include "mma_tile.cuh"

namespace {

using namespace head_tile;
using mma_tile::kWalkRows;
using mma_tile::kWalkThreads;

// B6 on the tensor cores takes K heads up to this.
constexpr int kMmaMaxHeads = 5;

// (m, i) wins over (mo, io): the larger value, the lower column on a tie.
__device__ __forceinline__ void take_better(float& m, int& i, float mo, int io) {
  if (mo > m || (mo == m && io < i)) {
    m = mo;
    i = io;
  }
}

// "highest": per (row, column block), the block's (max, lowest column at
// the max) of v. qw == nullptr is B5 (K = 1, v = h W + b).
template <bool AM>
__global__ void __launch_bounds__(kTileThreads)
argmax_tile_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ qw,
                   float* __restrict__ part_max, int* __restrict__ part_idx, int B, int F, int A,
                   int K, int valid) {
  __shared__ TileSmemT<AM> smem;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kTileCols, m0 = blockIdx.y * kTileRows;

  float v[4][8];
  for (int k = 0; k < K; ++k) {
    float acc[4][8];
    logits_tile(h, w + (size_t)k * F * (AM ? 1 : A), B, F, A, m0, n0, smem, acc, K * F);
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

// The epilogue of the head walk (mma_tile.cuh) for B5 (WEIGHTED false, K =
// 1) and B6: per row tile, v at the thread's columns n0 + c0 + 16 i + 8 t + e
// of rows g and g + 8 of its warp's 16, then per row the (max, lowest
// column at the max) over the thread's columns, the quad and the two column
// warps, written to the row's partial of this block.
template <int COLS, bool WEIGHTED>
struct ArgmaxEpilogue {
  static constexpr int NI = COLS / 32;
  const float* qw;
  const float* b_s;  // B6: (K, COLS) biases of the block's columns, 0 at >= valid
  float* red_m;      // (2 column halves, kWalkRows rows)
  int* red_i;
  float* part_max;
  int* part_idx;
  int B, A, K, valid, n0, c0, nblk;
  float bcol[NI][2][2];  // B5: the bias at the thread's columns, 0 at >= valid
  float v[NI][2][4];     // B6: the weighted sum over the heads so far

  __device__ __forceinline__ ArgmaxEpilogue(const float* bias, const float* qw_, float* smem,
                                            float* part_max_, int* part_idx_, int B_, int A_,
                                            int K_, int valid_)
      : qw(qw_), part_max(part_max_), part_idx(part_idx_), B(B_), A(A_), K(K_), valid(valid_) {
    const int tid = threadIdx.x, lane = tid % 32, wc = tid / 32 / 4;
    n0 = blockIdx.x * COLS;
    c0 = COLS / 2 * wc + 2 * (lane % 4);
    nblk = gridDim.x;
    red_m = smem;
    red_i = reinterpret_cast<int*>(red_m + 2 * kWalkRows);
    float* b_w = reinterpret_cast<float*>(red_i + 2 * kWalkRows);
    b_s = b_w;
    if constexpr (WEIGHTED) {
      // read after the walk's first barrier
      for (int e = tid; e < K * COLS; e += kWalkThreads) {
        const int col = n0 + e % COLS;
        b_w[e] = col < valid ? bias[(size_t)(e / COLS) * A + col] : 0.0f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + c0 + 16 * i + 8 * t + e;
            bcol[i][t][e] = col < valid ? bias[col] : 0.0f;
          }
    }
  }

  __device__ __forceinline__ void operator()(int k, int m0, const float (&acc)[NI][2][4]) {
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, q = lane % 4, wr = warp % 4, wc = warp / 4;
    if constexpr (WEIGHTED) {
      const float qk = qw[k];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bk = b_s[k * COLS + c0 + 16 * i + 8 * t + e];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float& x = v[i][t][2 * hr + e];
              x = __fadd_rn(k == 0 ? 0.0f : x, __fmul_rn(qk, __fadd_rn(acc[i][t][2 * hr + e], bk)));
            }
          }
      if (k + 1 < K) return;  // K is the same for every thread
    }

    // per row (g, g + 8): (max, lowest column at the max) over the thread's
    // columns, then over the quad; columns >= A take no part
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float m = -CUDART_INF_F;
      int idx = INT_MAX;
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + c0 + 16 * i + 8 * t + e;
            if (col < A) {
              const float x = WEIGHTED ? v[i][t][2 * hr + e] : acc[i][t][2 * hr + e] + bcol[i][t][e];
              take_better(m, idx, col < valid ? x : kNeg, col);
            }
          }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m, o);
        const int io = __shfl_xor_sync(0xffffffffu, idx, o);
        take_better(m, idx, mo, io);
      }
      if (q == 0) {
        const int r = 16 * wr + g + 8 * hr;
        red_m[wc * kWalkRows + r] = m;
        red_i[wc * kWalkRows + r] = idx;
      }
    }
    __syncthreads();
    if (tid < kWalkRows && m0 + tid < B) {
      float m = red_m[tid];
      int idx = red_i[tid];
      take_better(m, idx, red_m[kWalkRows + tid], red_i[kWalkRows + tid]);
      part_max[(size_t)(m0 + tid) * nblk + blockIdx.x] = m;
      part_idx[(size_t)(m0 + tid) * nblk + blockIdx.x] = idx;
    }
  }
};

// Bytes of shared memory of argmax_mma_kernel: the walk's, the two column
// halves' (max, column) of a tile's rows and, for B6, the block's biases.
__host__ __device__ inline size_t argmax_mma_smem(int F, int P, int K, int cols, bool weighted,
                                                  bool am) {
  return mma_tile::walk_smem(F, P, K, cols, am) + 8 * 2 * kWalkRows +
         (weighted ? 4 * (size_t)K * cols : 0);
}

template <int P, int COLS, bool WEIGHTED, bool AM>
__global__ void __launch_bounds__(kWalkThreads, 2)
argmax_mma_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ qw,
                  float* __restrict__ part_max, int* __restrict__ part_idx, int B, int F, int A,
                  int K, int valid, int vec_w, int vec_h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int heads = WEIGHTED ? K : 1;  // B5's single head known to the compiler
  ArgmaxEpilogue<COLS, WEIGHTED> epi(
      bias, qw, reinterpret_cast<float*>(smem_raw + mma_tile::walk_smem(F, P, heads, COLS, AM)),
      part_max, part_idx, B, A, heads, valid);
  mma_tile::head_walk<P, COLS, ArgmaxEpilogue<COLS, WEIGHTED>, mma_tile::kWalkMaxF, AM>(
      h, w, B, F, A, heads, valid, vec_w, vec_h, smem_raw, epi);
}

// Columns per block of B6 in "high" and "default": the widest of 128, 64
// and 32 at which two blocks fit on an SM (233472 bytes of shared memory,
// 1 KB of it reserved per block), else the widest at which one block fits;
// 0 if none does. B5 always takes 128. Reckoned with the action-major
// staging buffer, the larger of the two layouts', so that the grid and the
// partials (fused_argmax_scratch) do not depend on the layout.
int wargmax_cols(int F, int K, int P) {
  constexpr size_t kSmemPerSm = 233472, kReserved = 1024;
  for (int cols = 128; cols >= 32; cols /= 2)
    if (2 * (argmax_mma_smem(F, P, K, cols, true, true) + kReserved) <= kSmemPerSm) return cols;
  for (int cols = 128; cols >= 32; cols /= 2)
    if (argmax_mma_smem(F, P, K, cols, true, true) <= mma_tile::kMaxSmem) return cols;
  return 0;
}

// Columns per block of a launch: kTileCols in "highest" and for B5.
int block_cols(int F, int K, bool weighted, int precision) {
  return precision == 0 || !weighted ? kTileCols : wargmax_cols(F, K, precision);
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

template <int P, int COLS, bool WEIGHTED, bool AM>
cudaError_t launch_argmax_mma(const float* h, const float* w, const float* b, const float* qw,
                              float* part_max, int* part_idx, int B, int F, int A, int K,
                              int valid, cudaStream_t st) {
  static size_t allowed[mma_tile::kMaxDevices] = {};
  const size_t smem = argmax_mma_smem(F, P, K, COLS, WEIGHTED, AM);
  const void* kernel = (const void*)argmax_mma_kernel<P, COLS, WEIGHTED, AM>;
  cudaError_t err = mma_tile::allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  // a 4-float segment of a row lies wholly inside W: A % 4 == 0
  // (canonical) or F % 4 == 0 (action-major)
  const int vec_w = (AM ? F : A) % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec_h = F % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  argmax_mma_kernel<P, COLS, WEIGHTED, AM><<<(A + COLS - 1) / COLS, kWalkThreads, smem, st>>>(
      h, w, b, qw, part_max, part_idx, B, F, A, K, valid, vec_w, vec_h);
  return cudaGetLastError();
}

template <int P, bool AM>
cudaError_t launch_mma(const float* h, const float* w, const float* b, const float* qw,
                       float* part_max, int* part_idx, int B, int F, int A, int K, int valid,
                       int cols, cudaStream_t st) {
  if (qw == nullptr)
    return launch_argmax_mma<P, 128, false, AM>(h, w, b, qw, part_max, part_idx, B, F, A, 1,
                                                valid, st);
  if (cols == 128)
    return launch_argmax_mma<P, 128, true, AM>(h, w, b, qw, part_max, part_idx, B, F, A, K,
                                               valid, st);
  if (cols == 64)
    return launch_argmax_mma<P, 64, true, AM>(h, w, b, qw, part_max, part_idx, B, F, A, K,
                                              valid, st);
  return launch_argmax_mma<P, 32, true, AM>(h, w, b, qw, part_max, part_idx, B, F, A, K, valid,
                                            st);
}

template <bool AM>
cudaError_t launch_layout(const float* h, const float* w, const float* b, const float* qw,
                          float* part_max, int* part_idx, int B, int F, int A, int K, int valid,
                          int precision, int cols, cudaStream_t st) {
  if (precision == 1)
    return launch_mma<1, AM>(h, w, b, qw, part_max, part_idx, B, F, A, K, valid, cols, st);
  if (precision == 2)
    return launch_mma<2, AM>(h, w, b, qw, part_max, part_idx, B, F, A, K, valid, cols, st);
  const dim3 grid((A + kTileCols - 1) / kTileCols, (B + kTileRows - 1) / kTileRows);
  argmax_tile_kernel<AM><<<grid, kTileThreads, 0, st>>>(h, w, b, qw, part_max, part_idx, B, F,
                                                        A, K, valid);
  return cudaGetLastError();
}

}  // namespace

// Entries of each of the two scratch arrays (float max, int32 column) that
// fused_argmax needs for these arguments: one per (row, column block).
extern "C" long long fused_argmax_scratch(int B, int F, int A, int K, int weighted,
                                          int precision) {
  const int cols = block_cols(F, K, weighted != 0, precision);
  return cols > 0 ? (long long)B * ((A + cols - 1) / cols) : 0;
}

// Launches B5 (qw == NULL, K == 1) or B6 on `stream`: idx (B) int64 and mx
// (B) fp32 of the argmax described above, on a canonical W (action_major 0)
// or an action-major one (1). In "high" and "default" F may be at most 128
// and K at most 5. Returns cudaGetLastError() (0 on success).
extern "C" int fused_argmax(const float* h, const float* w, const float* b, const float* qw,
                            long long* idx, float* mx, float* part_max, int* part_idx, int B,
                            int F, int A, int K, int valid, int precision, int action_major,
                            void* stream) {
  if (B < 1 || F < 1 || A < 1 || K < 1 || (qw == nullptr && K != 1) || valid < 0 ||
      valid > A || precision < 0 || precision > 2 || action_major < 0 || action_major > 1 ||
      (precision != 0 && (F > mma_tile::kWalkMaxF || K > kMmaMaxHeads)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = block_cols(F, K, qw != nullptr, precision);
  if (cols < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      action_major ? launch_layout<true>(h, w, b, qw, part_max, part_idx, B, F, A, K, valid,
                                         precision, cols, st)
                   : launch_layout<false>(h, w, b, qw, part_max, part_idx, B, F, A, K, valid,
                                          precision, cols, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_max, part_idx, idx, mx, B, (A + cols - 1) / cols, st);
}
