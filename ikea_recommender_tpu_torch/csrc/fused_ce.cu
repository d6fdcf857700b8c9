// B1 and B2 on Hopper: softmax cross-entropy over the full catalog of a
// linear head, forward and backward, without writing the (B, A) logits.
//
// Replaces ikea_recommender_tpu/ops/fused_ce.py::_fwd_kernel (B1, launched by
// _fwd) and ::_bwd_kernel (B2, launched by _bwd_call). With logits
// l = h W + b, masked at columns col >= valid_dim (valid_dim is a runtime
// argument: the sharded path passes each shard's own count):
//   B1: lse[i] = log sum_col exp(l[i, col]),  g[i] = l[i, label[i]] when
//       label[i] < valid_dim, else 0  (masked logits count as -1e30)
//   B2: dl = (exp(l - lse) - onehot(label)) * ct, zero at col >= valid_dim;
//       dW = h^T dl, db = column sums of dl, dh = dl W^T with W's columns
//       >= valid_dim read as zero (they may hold anything, NaN included).
// dW and db are exactly 0 at columns >= valid_dim.
// Layouts, all contiguous: h (B, F), W (F, A), b (A), labels (B) int64,
// lse, g, ct (B), dW (F, A), db (A), dh (B, F), all fp32.
//
// Precision of the three products, as _dot/_dot3 of the TPU kernels
// ("highest" fp32, "high" the bf16x3 split, "default" one bf16 pass). In
// "highest" both run them on the CUDA cores as fp32 FMAs (B1 on
// head_tile.cuh). In "high" and "default" both run them on the bf16 tensor
// cores (mma_tile.cuh: mma.sync.m16n8k16 from ldmatrix, each operand split
// once as it is staged) and take F <= 256; B2 takes F <= 256 in "highest"
// too, B1 any F there. 256 = 2 H at hidden 128, bidir_gru4rec's widest head
// in the repo's configs.
//
// What bounds it: at the train point (B=256, F=64, A=70852) B1 reads W once
// (18.1 MB) and does 2.32 GFLOP per pass, B2 reads W and writes dW (36 MB)
// and does three such products, plus 18.1 M expf each. On bf16 tensor cores
// (989 TFLOP/s) "high" is bound by operations: 0.0070 ms for B1, 0.0211 ms
// for B2. "highest" is bound at 0.035 ms (B1) and 0.104 ms (B2) on the
// 67 TFLOP/s fp32 CUDA cores.
//
// B1 design: the TPU walks column blocks in order and carries the running
// (max, sum-exp, label logit) from one grid step to the next. Here each
// block owns 128 columns and writes per-row partials (m, s, g) of its
// columns; a second kernel merges them per row: m = max m_i,
// s = sum s_i exp(m_i - m), g = sum g_i, lse = m + log s. The -1e30
// sentinel is finite, never -inf, so a block whose columns are all masked
// gives m_i = -1e30 and vanishes in the merge.
// - "high" and "default" (ce_fwd_mma_kernel): mma_tile.cuh's head walk, as
//   B5: W's 128 columns split into bf16 planes once, all of B walked in
//   64-row tiles of h that arrive by cp.async. Per tile the epilogue adds
//   the bias to the C fragment and masks columns >= valid_dim to -1e30;
//   per row each thread takes the max over its 16 columns and the quad's
//   shuffles, then sum exp(l - m) and the label's logit over the same, and
//   the two column warps of a row meet in shared memory, s rescaled to the
//   larger max. The exponentials are expf (full precision), 18.1 M a call
//   at the train point. Past F = 128 W's planes of 128 columns no longer
//   fit beside a tile of h's: the block owns 64 columns, 206 KB of shared
//   memory at F = 256 in "high", one block an SM (the walk stages h in
//   slices of 128 floats a row at any F).
// - "highest" (ce_fwd_kernel): the block owns 128 columns x 64 rows and
//   computes its logits tile in registers (head_tile.cuh: a 4 x 8 tile per
//   thread, K in chunks of 16 through shared memory).
//
// B2 design: one block per SM, each walking a strided set of 64-column
// chunks, so dW and db of a chunk's columns are summed by one block alone:
// no atomics. dh is a sum over all column chunks: each block accumulates
// its own (B, F) part in shared memory and writes it once; a second kernel
// sums the parts in block order, so dh, dW and db are the same from run to
// run. Where (B, F) does not fit next to the tiles, the rows go in groups,
// one launch each, adding into dW and db. W's columns >= valid_dim are
// zeroed as the chunk is staged, before any product, and nothing past A is
// read.
// - "highest" (ce_bwd_kernel): the chunk's W and the dW and db
//   accumulators in shared memory, rows in tiles of 32, the three products
//   as fp32 FMAs from padded shared-memory tiles.
// - "high" and "default" (ce_bwd_mma_kernel): h's rows are split into bf16
//   planes once per block. A chunk's W is fetched with cp.async into a
//   staging buffer while the block computes the chunk before it (16 bytes
//   a copy when A % 4 == 0, else 4), then split into planes. Per tile of 64
//   rows: the logits (mma), dl = (exp(l + b - lse) - onehot) ct in
//   registers, db by shuffles and a fixed-order sum over the warps, dl's
//   planes to shared memory; dW += h^T dl (accumulators in registers for
//   the whole chunk); dh += dl W^T into the fp32 accumulator, each entry
//   owned by one thread, its rows 8 mod 32 words apart so the float2
//   updates meet no bank conflict. "high"'s cross passes go to their own
//   fragments, added once per k loop. With 64-column chunks, 1108 of them
//   at the train point over 132 blocks: 8 or 9 chunks a block, one block
//   (eight warps) an SM. It sits ~9x above its bound: a tile costs each
//   warp ~100 ldmatrix.x4 for 240 mma and two barriers, so by count shared
//   memory's bandwidth and the barriers, not the tensor cores, set its pace
//   (no profiler of the SM's pipes here). A launch after the first reads
//   the thread's old dW entries of a chunk all at once, then adds.
// - F > 128 in "high" and "default" (ce_bwd_mma_sliced_kernel, the same
//   tile steps through helpers): a warp's dW registers cover 8 f blocks
//   (128 of F), and h's planes and the dh accumulator of one tile take
//   132 KB at F = 256. So a launch takes one tile of 64 rows: its logits
//   and dl once per chunk, then dW and dh over F in slices of 128, dW
//   written per slice. W's chunk comes through registers (64 a thread),
//   loaded while the chunk before it is computed, as the staging buffer
//   would not fit. B = 256 takes four launches, each reading W and adding
//   into dW and db.

#include <cuda_runtime.h>

#include "head_tile.cuh"
#include "mma_tile.cuh"

namespace {

using namespace head_tile;
using mma_tile::allow_smem;
using mma_tile::kMaxDevices;
using mma_tile::kMaxSmem;
using mma_tile::kWalkRows;
using mma_tile::kWalkThreads;

constexpr int kThreads = 256;
static_assert(kThreads == kTileThreads, "B1 runs the shared logits tile");

// ---------------------------------------------------------------------------
// B1: per-(column block, row) partials, then a per-row merge
// ---------------------------------------------------------------------------

// "highest": fp32 FMAs on the CUDA cores.
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ bias, const long long* __restrict__ labels,
              float* __restrict__ part, int B, int F, int A, int valid) {
  __shared__ TileSmem smem;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kTileCols, m0 = blockIdx.y * kTileRows;
  float acc[4][8];
  logits_tile(h, w, B, F, A, m0, n0, smem, acc);

  // Per row: max, sum of exp and label logit over this block's columns. The
  // 16 threads of a row (equal ty) are one half-warp.
  const int nblk = gridDim.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    const long long lbl = row < B ? labels[row] : -1;
    float l[8];
    float m = kNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      l[j] = col < valid ? acc[i][j] + bias[col] : kNeg;
      if (col < A) m = fmaxf(m, l[j]);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.0f, g = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < A) s += expf(l[j] - m);
      if (col < valid && col == lbl) g += l[j];
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      g += __shfl_xor_sync(0xffffffffu, g, o);
    }
    if (tx == 0 && row < B) {
      float* p = part + ((size_t)row * nblk + blockIdx.x) * 3;
      p[0] = m;
      p[1] = s;
      p[2] = g;
    }
  }
}

// The epilogue of the head walk (mma_tile.cuh) for B1: per row tile, the
// logits at the thread's columns n0 + c0 + 16 i + 8 t + e of rows g and
// g + 8 of its warp's 16, and per row the (m, s, g) of the block's COLS
// columns.
template <int COLS>
struct CeEpilogue {
  static constexpr int NI = COLS / 32;
  const long long* labels;
  float* red;  // (2 column halves, kWalkRows rows, 3)
  float* part;
  int B, A, valid, n0, c0, nblk;
  float bcol[NI][2][2];  // the bias at the thread's columns, 0 at >= valid

  __device__ __forceinline__ CeEpilogue(const float* bias, const long long* labels_, float* smem,
                                        float* part_, int B_, int A_, int valid_)
      : labels(labels_), red(smem), part(part_), B(B_), A(A_), valid(valid_) {
    const int lane = threadIdx.x % 32, wc = threadIdx.x / 32 / 4;
    n0 = blockIdx.x * COLS;
    c0 = COLS / 2 * wc + 2 * (lane % 4);
    nblk = gridDim.x;
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

  __device__ __forceinline__ void operator()(int, int m0, const float (&acc)[NI][2][4]) {
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, q = lane % 4, wr = warp % 4, wc = warp / 4;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * wr + g + 8 * hr, row = m0 + r;
      const long long lbl = row < B ? labels[row] : -1;
      float l[NI][2][2];
      float m = kNeg;  // over the columns < A, masked ones at -1e30
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + c0 + 16 * i + 8 * t + e;
            l[i][t][e] = col < valid ? acc[i][t][2 * hr + e] + bcol[i][t][e] : kNeg;
            if (col < A) m = fmaxf(m, l[i][t][e]);
          }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float s = 0.0f, gl = 0.0f;
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + c0 + 16 * i + 8 * t + e;
            if (col < A) s += expf(l[i][t][e] - m);
            if (col < valid && col == lbl) gl += l[i][t][e];
          }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        gl += __shfl_xor_sync(0xffffffffu, gl, o);
      }
      if (q == 0) {
        float* x = red + (wc * kWalkRows + r) * 3;
        x[0] = m;
        x[1] = s;
        x[2] = gl;
      }
    }
    __syncthreads();
    if (tid < kWalkRows && m0 + tid < B) {
      const float* x0 = red + tid * 3;
      const float* x1 = red + (kWalkRows + tid) * 3;
      const float mn = fmaxf(x0[0], x1[0]);
      float* p = part + ((size_t)(m0 + tid) * nblk + blockIdx.x) * 3;
      p[0] = mn;
      p[1] = x0[1] * expf(x0[0] - mn) + x1[1] * expf(x1[0] - mn);
      p[2] = x0[2] + x1[2];
    }
  }
};

// Columns a block of B1 owns: 128, and 64 past the walk's kWalkMaxF, where
// W's planes of 128 columns would not fit beside h's.
__host__ __device__ inline int fwd_cols(int F, int precision) {
  return precision != 0 && F > mma_tile::kWalkMaxF ? 64 : kTileCols;
}

// Bytes of shared memory of ce_fwd_mma_kernel: the walk's and the two
// column halves' (m, s, g) of a tile's rows.
__host__ __device__ inline size_t fwd_mma_smem(int F, int P, int cols) {
  return mma_tile::walk_smem(F, P, 1, cols) + 4 * 3 * 2 * kWalkRows;
}

template <int P, int COLS>
__global__ void __launch_bounds__(kWalkThreads, 2)
ce_fwd_mma_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const float* __restrict__ bias, const long long* __restrict__ labels,
                  float* __restrict__ part, int B, int F, int A, int valid, int vec_w,
                  int vec_h) {
  // 64 columns a block only past kWalkMaxF (fwd_cols)
  constexpr int MAXF = COLS == 64 ? mma_tile::kWalkNarrowMaxF : mma_tile::kWalkMaxF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CeEpilogue<COLS> epi(bias, labels,
                       reinterpret_cast<float*>(smem_raw + mma_tile::walk_smem(F, P, 1, COLS)),
                       part, B, A, valid);
  mma_tile::head_walk<P, COLS, CeEpilogue<COLS>, MAXF>(h, w, B, F, A, 1, valid, vec_w, vec_h,
                                                       smem_raw, epi);
}

template <int P, int COLS>
cudaError_t launch_fwd_mma(const float* h, const float* w, const float* b,
                           const long long* labels, float* part, int B, int F, int A, int valid,
                           cudaStream_t st) {
  static size_t allowed[kMaxDevices] = {};
  const size_t smem = fwd_mma_smem(F, P, COLS);
  cudaError_t err = allow_smem((const void*)ce_fwd_mma_kernel<P, COLS>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int vec_w = A % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec_h = F % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  ce_fwd_mma_kernel<P, COLS><<<(A + COLS - 1) / COLS, kWalkThreads, smem, st>>>(
      h, w, b, labels, part, B, F, A, valid, vec_w, vec_h);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_fwd_mma(const float* h, const float* w, const float* b,
                           const long long* labels, float* part, int B, int F, int A, int valid,
                           cudaStream_t st) {
  if (fwd_cols(F, P) == 64)
    return launch_fwd_mma<P, 64>(h, w, b, labels, part, B, F, A, valid, st);
  return launch_fwd_mma<P, kTileCols>(h, w, b, labels, part, B, F, A, valid, st);
}

// One warp per row merges the row's nblk partials.
__global__ void __launch_bounds__(kThreads)
ce_merge_kernel(const float* __restrict__ part, float* __restrict__ lse,
                float* __restrict__ g_out, int B, int nblk) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= B) return;
  float m = kNeg, s = 0.0f, g = 0.0f;
  for (int i = lane; i < nblk; i += 32) {
    const float* p = part + ((size_t)row * nblk + i) * 3;
    const float mi = p[0];
    const float mn = fmaxf(m, mi);
    s = s * expf(m - mn) + p[1] * expf(mi - mn);
    m = mn;
    g += p[2];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float so = __shfl_xor_sync(0xffffffffu, s, o);
    const float mn = fmaxf(m, mo);
    s = s * expf(m - mn) + so * expf(mo - mn);
    m = mn;
    g += __shfl_xor_sync(0xffffffffu, g, o);
  }
  if (lane == 0) {
    lse[row] = m + logf(s);
    g_out[row] = g;
  }
}

// ---------------------------------------------------------------------------
// B2: column chunks own dW and db; per-block dh parts, then their sum
// ---------------------------------------------------------------------------

constexpr int kBwdRows = 32, kBwdCols = 64;
// F B2 takes in every precision: "highest" keeps W's chunk and its dW at
// all of F in shared memory (170 KB at F = 256), the tensor cores a tile of
// h's planes and its dh accumulator (ce_bwd_mma_sliced_kernel, 223 KB).
constexpr int kBwdMaxF = 256;
// F up to which a warp's registers hold dW of the chunk for all of F
// (ce_bwd_mma_kernel); past it the sliced kernel.
constexpr int kBwdSliceF = 128;

struct BwdLayout {
  int wp, hp, dp;  // padded row lengths of the W, h and dl tiles
  size_t fixed;    // floats besides the dh accumulator
};

__host__ __device__ inline BwdLayout bwd_layout(int F) {
  BwdLayout L;
  L.wp = kBwdCols + 1;
  L.hp = F + 1;
  L.dp = kBwdCols + 1;
  L.fixed = (size_t)F * L.wp + (size_t)kBwdRows * L.hp + (size_t)kBwdRows * L.dp +
            (size_t)F * kBwdCols + kBwdCols;  // W, h, dl; the dW and db accumulators
  return L;
}

// "highest": every product an fp32 FMA on the CUDA cores.
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ bias, const long long* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ ct,
              float* __restrict__ dw, float* __restrict__ db, float* __restrict__ dh_part,
              int B, int F, int A, int valid, int g0, int g1, int accumulate) {
  extern __shared__ float smem[];
  const BwdLayout L = bwd_layout(F);
  float* p = smem;
  float* w_s = p;  // (F, wp) W's chunk, columns >= valid zeroed
  p += F * L.wp;
  float* h_s = p;  // (kBwdRows, hp)
  p += kBwdRows * L.hp;
  float* dl = p;  // (kBwdRows, dp) dlogits
  p += kBwdRows * L.dp;
  float* dw_s = p;  // (F, kBwdCols)
  p += F * kBwdCols;
  float* db_s = p;  // (kBwdCols)
  p += kBwdCols;
  float* dh_s = p;  // (g1 - g0, F)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_chunks = (A + kBwdCols - 1) / kBwdCols;
  for (int i = tid; i < (g1 - g0) * F; i += kThreads) dh_s[i] = 0.0f;

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int n0 = chunk * kBwdCols;
    for (int e = tid; e < F * kBwdCols; e += kThreads) {
      const int k = e / kBwdCols, c = e % kBwdCols;
      w_s[k * L.wp + c] = n0 + c < valid ? w[(size_t)k * A + n0 + c] : 0.0f;
      dw_s[e] = 0.0f;
    }
    for (int c = tid; c < kBwdCols; c += kThreads) db_s[c] = 0.0f;

    for (int r0 = g0; r0 < g1; r0 += kBwdRows) {
      __syncthreads();  // the previous tile's readers are done
      for (int e = tid; e < kBwdRows * F; e += kThreads) {
        const int r = e / F, k = e % F;
        h_s[r * L.hp + k] = r0 + r < g1 ? h[(size_t)(r0 + r) * F + k] : 0.0f;
      }
      __syncthreads();

      // logits of the tile: rows ty + 16 i, columns tx + 16 j
      float acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int k = 0; k < F; ++k) {
        float a[2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = h_s[(ty + 16 * i) * L.hp + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = w_s[k * L.wp + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty + 16 * i, row = r0 + r;
        const bool live = row < g1;
        const float row_lse = live ? lse[row] : 0.0f;
        const float row_ct = live ? ct[row] : 0.0f;
        const long long lbl = live ? labels[row] : -1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, col = n0 + c;
          float d = 0.0f;
          if (live && col < valid) {
            const float pr = expf(acc[i][j] + bias[col] - row_lse);
            d = (pr - (col == lbl ? 1.0f : 0.0f)) * row_ct;
          }
          dl[r * L.dp + c] = d;
        }
      }
      __syncthreads();

      // dW += h^T dl over the tile's rows: f = f0 + ty + 16 i, c = tx + 16 j
      for (int f0 = 0; f0 < F; f0 += 32) {
        float a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = 0.0f;
        const int fa = min(f0 + ty, F - 1), fb = min(f0 + ty + 16, F - 1);
        for (int r = 0; r < kBwdRows; ++r) {
          const float hv[2] = {h_s[r * L.hp + fa], h_s[r * L.hp + fb]};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float dv = dl[r * L.dp + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 2; ++i) a[i][j] = fmaf(hv[i], dv, a[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int f = f0 + ty + 16 * i;
          if (f < F) {
#pragma unroll
            for (int j = 0; j < 4; ++j) dw_s[f * kBwdCols + tx + 16 * j] += a[i][j];
          }
        }
      }
      for (int c = tid; c < kBwdCols; c += kThreads) {
        float a = 0.0f;
        for (int r = 0; r < kBwdRows; ++r) a += dl[r * L.dp + c];
        db_s[c] += a;
      }

      // dh += dl W^T over the chunk's columns: rows ty + 16 i, f = f0 + tx + 16 j
      for (int f0 = 0; f0 < F; f0 += 64) {
        float a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a[i][j] = 0.0f;
        int fj[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) fj[j] = min(f0 + tx + 16 * j, F - 1);
        for (int c = 0; c < kBwdCols; ++c) {
          float dv[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) dv[i] = dl[(ty + 16 * i) * L.dp + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float wv = w_s[fj[j] * L.wp + c];
#pragma unroll
            for (int i = 0; i < 2; ++i) a[i][j] = fmaf(dv[i], wv, a[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + ty + 16 * i;
          if (row < g1) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int f = f0 + tx + 16 * j;
              if (f < F) dh_s[(row - g0) * F + f] += a[i][j];
            }
          }
        }
      }
    }
    __syncthreads();

    for (int e = tid; e < F * kBwdCols; e += kThreads) {
      const int k = e / kBwdCols, c = e % kBwdCols, col = n0 + c;
      if (col < A) {
        const float v = col < valid ? dw_s[e] : 0.0f;
        float* out = dw + (size_t)k * A + col;
        *out = accumulate ? *out + v : v;
      }
    }
    for (int c = tid; c < kBwdCols; c += kThreads) {
      const int col = n0 + c;
      if (col < A) {
        const float v = col < valid ? db_s[c] : 0.0f;
        db[col] = accumulate ? db[col] + v : v;
      }
    }
  }
  __syncthreads();
  float* out = dh_part + (size_t)blockIdx.x * B * F;
  for (int i = tid; i < (g1 - g0) * F; i += kThreads) out[(size_t)g0 * F + i] = dh_s[i];
}

// dh[i] = sum over the nblk parts, in block order.
__global__ void __launch_bounds__(kThreads)
ce_dh_sum_kernel(const float* __restrict__ dh_part, float* __restrict__ dh, int n, int nblk) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float a = 0.0f;
  for (int b = 0; b < nblk; ++b) a += dh_part[(size_t)b * n + i];
  dh[i] = a;
}

// ---------------------------------------------------------------------------
// B2 in "high" and "default": the same chunk ownership, on the bf16 tensor
// cores (mma_tile.cuh)
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;          // rows of a tile
constexpr int kMmaLd = kBwdCols + 8;  // row stride of the W and dl planes

// Row stride of the dh accumulator: at least F padded to 16, and 8 mod 32
// words, so the float2 updates of a half-warp (rows g, columns 2 q) fall on
// 32 distinct banks.
__host__ __device__ inline int dh_ld(int F) {
  const int fp = (F + 15) / 16 * 16;
  return fp + (40 - fp % 32) % 32;
}

// Bytes of shared memory of ce_bwd_mma_kernel for `rows` rows of h and dh:
// W's chunk staged in fp32, W's and dl's bf16 planes, h's planes (rows
// padded to a tile), db per warp row and per chunk, the dh accumulator.
__host__ __device__ inline size_t bwd_mma_smem(int F, int P, int rows) {
  const size_t fp = (F + 15) / 16 * 16, planes = P == 1 ? 2 : 1;
  const size_t rows_pad = (rows + kMmaRows - 1) / kMmaRows * kMmaRows;
  return 4 * (size_t)F * kBwdCols + 2 * planes * (fp + kMmaRows) * kMmaLd +
         2 * planes * rows_pad * (fp + 8) + 4 * 5 * kBwdCols + 4 * (size_t)rows * dh_ld(F);
}

// The steps of a 64-row tile of ce_bwd_mma_sliced_kernel, in the arithmetic
// that ce_bwd_mma_kernel writes out: eight warps; warp (wr, wc) = (warp % 4,
// warp / 4) computes the logits of rows 16 wr.. at columns 32 wc.., then dW
// of the f blocks fb0 + wc + 2 j (j < 4) at columns 16 wr.., and dh of rows
// 16 wr.. at those f blocks (a block is 16 of F padded to a multiple of 16;
// fb0 each slice of 8 blocks in turn). Both kernels write dW through
// load_dw and store_dw.

// dl = (exp(l - lse) - onehot) ct at the valid columns of the tile's live
// rows (logits s at rows 16 wr.., columns 16 (2 wc + i).., the bias bcol
// added here), into dl's planes; the column sums over the warp's 16 rows, in
// a fixed shuffle order, into db_part[wr].
template <int P>
__device__ __forceinline__ void dl_tile(const float (&s)[2][2][4], const float (&bcol)[2][2][2],
                                        const mma_tile::Planes& ls, float* db_part,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ ct,
                                        const long long* __restrict__ labels, int g0, int r0,
                                        int rows, int n0, int valid) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4, wr = warp % 4, wc = warp / 4;
  float colsum[2][2][2];  // the sums over the thread's 2 rows
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8 of the warp's 16
    const int lr = 16 * wr + g + 8 * hr, row = g0 + r0 + lr;
    const bool live = r0 + lr < rows;
    const float row_lse = live ? lse[row] : 0.0f;
    const float row_ct = live ? ct[row] : 0.0f;
    const long long lbl = live ? labels[row] : -1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = 16 * (2 * wc + i) + 8 * t + 2 * q;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + c + e;
          d[e] = 0.0f;
          if (live && col < valid) {
            const float pr = expf(s[i][t][2 * hr + e] + bcol[i][t][e] - row_lse);
            d[e] = (pr - (col == lbl ? 1.0f : 0.0f)) * row_ct;
          }
          colsum[i][t][e] = hr == 0 ? d[e] : colsum[i][t][e] + d[e];
        }
        mma_tile::store_split2<P>(ls, lr * ls.ld + c, d[0], d[1]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = colsum[i][t][e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (g == 0) db_part[wr * kBwdCols + 16 * (2 * wc + i) + 8 * t + 2 * q + e] = v;
      }
}

// dwa[j] += h^T dl over the tile's rows r0.., at f block fb0 + wc + 2 j and
// columns 16 wr..; "high"'s cross passes apart, added once (mma_tile.cuh).
template <int P>
__device__ __forceinline__ void dw_tile(float (&dwa)[4][2][4], const mma_tile::Planes& ls,
                                        const mma_tile::Planes& hs, int r0, int fb0, int nfb) {
  using namespace mma_tile;
  const int warp = threadIdx.x / 32, wr = warp % 4, wc = warp / 4;
  float dwx[4][2][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kMmaRows; k0 += 16) {
    Frag b;
    load_b<P>(b, ls, k0, 16 * wr);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fb = fb0 + wc + 2 * j;
      if (fb < nfb) {
        Frag a;
        load_a_trans<P>(a, hs, r0 + k0, 16 * fb);
        mma_pair<P>(dwa[j], dwx[j], a, b);
      }
    }
  }
  fold<P>(dwa, dwx);
}

// dh += dl W^T over the chunk's columns at rows r0 + 16 wr.. and f blocks
// fb0 + wc + 2 j, into the accumulator (row stride ldd), each entry owned
// by one thread.
template <int P>
__device__ __forceinline__ void dh_tile(float* dh_s, int ldd, const mma_tile::Planes& ls,
                                        const mma_tile::Planes& ws, int r0, int rows, int fb0,
                                        int nfb, int fp) {
  using namespace mma_tile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4, wr = warp % 4, wc = warp / 4;
  float dha[4][2][4] = {}, dhx[4][2][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kBwdCols; k0 += 16) {
    Frag a;
    load_a<P>(a, ls, 16 * wr, k0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int fb = fb0 + wc + 2 * j;
      if (fb < nfb) {
        Frag b;
        load_b_trans<P>(b, ws, 16 * fb, k0);
        mma_pair<P>(dha[j], dhx[j], a, b);
      }
    }
  }
  fold<P>(dha, dhx);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + 16 * wr + g + 8 * hr;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int f = 16 * (fb0 + wc + 2 * j) + 8 * t + 2 * q;
        if (r < rows && f < fp) {  // columns F..fp of W's planes are 0
          float2* acc = reinterpret_cast<float2*>(dh_s + r * ldd + f);
          float2 v = *acc;
          v.x += dha[j][t][2 * hr];
          v.y += dha[j][t][2 * hr + 1];
          *acc = v;
        }
      }
    }
}

// The thread's entries of dW: rows f = 16 (fb0 + wc + 2 j) + g + 8 hr,
// columns n0 + 16 wr + 8 t + 2 q + e; `fn` (f, col, j, hr, t, e) is called
// for those with f < F and col < A.
template <class Fn>
__device__ __forceinline__ void for_dw_entries(int fb0, int F, int A, int n0, Fn&& fn) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4, wr = warp % 4, wc = warp / 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = 16 * (fb0 + wc + 2 * j) + g + 8 * hr;
          const int col = n0 + 16 * wr + 8 * t + 2 * q + e;
          if (f < F && col < A) fn(f, col, j, hr, t, e);
        }
}

// The earlier launches' dW at the thread's entries (for_dw_entries), all
// loads issued together: one wait on device memory, not one per entry.
__device__ __forceinline__ void load_dw(float (&prev)[4][2][2][2], const float* __restrict__ dw,
                                        int fb0, int F, int A, int n0) {
  for_dw_entries(fb0, F, A, n0, [&](int f, int col, int j, int hr, int t, int e) {
    prev[j][hr][t][e] = dw[(size_t)f * A + col];
  });
}

// dW at the thread's entries: the sums dwa, 0 at columns >= valid, added to
// prev (load_dw) when `accumulate`.
__device__ __forceinline__ void store_dw(float* __restrict__ dw, const float (&dwa)[4][2][4],
                                         const float (&prev)[4][2][2][2], int fb0, int F, int A,
                                         int n0, int valid, int accumulate) {
  for_dw_entries(fb0, F, A, n0, [&](int f, int col, int j, int hr, int t, int e) {
    const float v = col < valid ? dwa[j][t][2 * hr + e] : 0.0f;
    dw[(size_t)f * A + col] = accumulate ? prev[j][hr][t][e] + v : v;
  });
}

// db of the tile at column c: dl_tile's parts of the 4 warp rows, in order.
__device__ __forceinline__ float db_rows(const float* db_part, int c) {
  return ((db_part[c] + db_part[kBwdCols + c]) + db_part[2 * kBwdCols + c]) +
         db_part[3 * kBwdCols + c];
}

// The bias at this thread's logit columns n0 + 16 (2 wc + i) + 8 t + 2 q + e,
// 0 at >= valid.
__device__ __forceinline__ void bias_cols(float (&bcol)[2][2][2], const float* __restrict__ bias,
                                          int n0, int valid) {
  const int q = threadIdx.x % 4, wc = threadIdx.x / 32 / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 16 * (2 * wc + i) + 8 * t + 2 * q + e;
        bcol[i][t][e] = col < valid ? bias[col] : 0.0f;
      }
}

// The logits of the tile's rows r0 + 16 wr.. at the chunk's columns
// 16 (2 wc + i).., over all of F; "high"'s cross passes apart in sx.
template <int P>
__device__ __forceinline__ void logits_mma(float (&s)[2][2][4], const mma_tile::Planes& hs,
                                           const mma_tile::Planes& ws, int r0, int fp) {
  using namespace mma_tile;
  const int warp = threadIdx.x / 32, wr = warp % 4, wc = warp / 4;
  float sx[2][2][4] = {};
  for (int k0 = 0; k0 < fp; k0 += 16) {
    Frag a;
    load_a<P>(a, hs, r0 + 16 * wr, k0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      Frag b;
      load_b<P>(b, ws, k0, 16 * (2 * wc + i));
      mma_pair<P>(s[i], sx[i], a, b);
    }
  }
  fold<P>(s, sx);
}

// h's rows g0.. (rows of them, padded with zero rows to rows_pad) split into
// the planes hs once.
template <int P>
__device__ __forceinline__ void split_rows(const mma_tile::Planes& hs, const float* __restrict__ h,
                                           int g0, int rows, int rows_pad, int F, int fp) {
#pragma unroll 4
  for (int e = threadIdx.x; e < rows_pad * fp / 2; e += kThreads) {
    const int r = e / (fp / 2), k = 2 * (e % (fp / 2));
    float x0 = 0.0f, x1 = 0.0f;
    if (r < rows) {
      const float* src = h + (size_t)(g0 + r) * F;
      x0 = k < F ? src[k] : 0.0f;
      x1 = k + 1 < F ? src[k + 1] : 0.0f;
    }
    mma_tile::store_split2<P>(hs, r * hs.ld + k, x0, x1);
  }
}

// F <= kBwdSliceF: all rows of the launch's group at once; per chunk its
// tiles in turn, dW of the chunk in the warps' registers across them.
// Eight warps; warp (wr, wc) = (warp % 4, warp / 4). Per tile of 64 rows it
// computes the logits of rows 16 wr.. at columns 32 wc.., then dW of the
// f blocks wc + 2 j (j < 4) at columns 16 wr.., and dh of rows 16 wr.. at
// those f blocks (a block is 16 of F padded to a multiple of 16). The tile
// steps are the helpers' above, written out: through the helpers, with the
// same arithmetic and results, it ran 6.3% slower in "default" at the
// train point (1.5-5% for each of the logits, dl and dW steps alone).
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
ce_bwd_mma_kernel(const float* __restrict__ h, const float* __restrict__ w,
                  const float* __restrict__ bias, const long long* __restrict__ labels,
                  const float* __restrict__ lse, const float* __restrict__ ct,
                  float* __restrict__ dw, float* __restrict__ db, float* __restrict__ dh_part,
                  int B, int F, int A, int valid, int g0, int g1, int accumulate, int vec) {
  using namespace mma_tile;
  constexpr bool LO = P == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fp = (F + 15) / 16 * 16, nfb = fp / 16;
  const int rows = g1 - g0, rows_pad = (rows + kMmaRows - 1) / kMmaRows * kMmaRows;
  unsigned char* p = smem_raw;
  auto take = [&](size_t bytes) {
    unsigned char* q = p;
    p += bytes;
    return q;
  };
  auto planes = [&](int n_rows, int ld) {
    Planes s{reinterpret_cast<bf16*>(take(2 * (size_t)n_rows * ld)), nullptr, ld};
    if (LO) s.lo = reinterpret_cast<bf16*>(take(2 * (size_t)n_rows * ld));
    return s;
  };
  float* stage = reinterpret_cast<float*>(take(4 * (size_t)F * kBwdCols));  // (F, kBwdCols)
  const Planes ws = planes(fp, kMmaLd);       // W's chunk (fp, kBwdCols), columns >= valid 0
  const Planes ls = planes(kMmaRows, kMmaLd);  // dl of the tile (kMmaRows, kBwdCols)
  const Planes hs = planes(rows_pad, fp + 8);  // h's rows g0..g1 (rows_pad, fp)
  float* db_part = reinterpret_cast<float*>(take(4 * 4 * kBwdCols));  // (4, kBwdCols)
  float* db_s = reinterpret_cast<float*>(take(4 * kBwdCols));
  float* dh_s = reinterpret_cast<float*>(p);  // (rows, ldd)
  const int ldd = dh_ld(F);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4, wr = warp % 4, wc = warp / 4;
  const int n_chunks = (A + kBwdCols - 1) / kBwdCols;

  // W's columns of a chunk into the staging buffer, in flight while the
  // block computes the chunk before it
  auto fetch = [&](int chunk) {
    fetch_cols<kBwdCols, kThreads>(stage, w, F, A, chunk * kBwdCols, vec);
  };

  if ((int)blockIdx.x < n_chunks) fetch(blockIdx.x);
  // h's rows, split once for all chunks, while the first chunk is in flight
#pragma unroll 4
  for (int e = tid; e < rows_pad * fp / 2; e += kThreads) {
    const int r = e / (fp / 2), k = 2 * (e % (fp / 2));
    float x0 = 0.0f, x1 = 0.0f;
    if (r < rows) {
      const float* src = h + (size_t)(g0 + r) * F;
      x0 = k < F ? src[k] : 0.0f;
      x1 = k + 1 < F ? src[k + 1] : 0.0f;
    }
    store_split2<P>(hs, r * hs.ld + k, x0, x1);
  }
  for (int i = tid; i < rows * ldd; i += kThreads) dh_s[i] = 0.0f;

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int n0 = chunk * kBwdCols;
    cp_async_wait<0>();
    __syncthreads();  // the chunk has landed; the previous chunk's readers are done
    split_cols<P, kBwdCols, kThreads>(ws, stage, F, fp, n0, valid);
    if (tid < kBwdCols) db_s[tid] = 0.0f;
    __syncthreads();  // W's planes are ready and the staging buffer is free
    if (chunk + (int)gridDim.x < n_chunks) fetch(chunk + gridDim.x);

    // this thread's logit columns: 16 (2 wc + i) + 8 t + 2 q + e
    float bcol[2][2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 16 * (2 * wc + i) + 8 * t + 2 * q + e;
          bcol[i][t][e] = col < valid ? bias[col] : 0.0f;
        }
    float dwa[4][2][4] = {};  // dW at f block wc + 2 j, columns 16 wr..

    for (int r0 = 0; r0 < rows; r0 += kMmaRows) {
      // logits at rows 16 wr.., columns 16 (2 wc + i)..; the cross passes
      // of "high" apart in sx, added once (mma_tile.cuh)
      float s[2][2][4] = {}, sx[2][2][4] = {};
      for (int k0 = 0; k0 < fp; k0 += 16) {
        Frag a;
        load_a<P>(a, hs, r0 + 16 * wr, k0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          Frag b;
          load_b<P>(b, ws, k0, 16 * (2 * wc + i));
          mma_pair<P>(s[i], sx[i], a, b);
        }
      }
      fold<P>(s, sx);

      // dl = (exp(l - lse) - onehot) ct at the valid columns of live rows,
      // into dl's planes; colsum[i][t][e] = its sum over the thread's 2 rows
      float colsum[2][2][2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8 of the warp's 16
        const int lr = 16 * wr + g + 8 * hr, row = g0 + r0 + lr;
        const bool live = r0 + lr < rows;
        const float row_lse = live ? lse[row] : 0.0f;
        const float row_ct = live ? ct[row] : 0.0f;
        const long long lbl = live ? labels[row] : -1;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int c = 16 * (2 * wc + i) + 8 * t + 2 * q;
            float d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + c + e;
              d[e] = 0.0f;
              if (live && col < valid) {
                const float pr = expf(s[i][t][2 * hr + e] + bcol[i][t][e] - row_lse);
                d[e] = (pr - (col == lbl ? 1.0f : 0.0f)) * row_ct;
              }
              colsum[i][t][e] = hr == 0 ? d[e] : colsum[i][t][e] + d[e];
            }
            store_split2<P>(ls, lr * ls.ld + c, d[0], d[1]);
          }
      }
      // db: column sums over the warp's 16 rows in a fixed shuffle order,
      // then over the 4 warp rows in order
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = colsum[i][t][e];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
            if (g == 0) db_part[wr * kBwdCols + 16 * (2 * wc + i) + 8 * t + 2 * q + e] = v;
          }
      __syncthreads();  // dl's planes and the db parts are complete
      if (tid < kBwdCols)
        db_s[tid] += ((db_part[tid] + db_part[kBwdCols + tid]) + db_part[2 * kBwdCols + tid]) +
                     db_part[3 * kBwdCols + tid];

      // dW += h^T dl over the tile's rows
      float dwx[4][2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < kMmaRows; k0 += 16) {
        Frag b;
        load_b<P>(b, ls, k0, 16 * wr);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int fb = wc + 2 * j;
          if (fb < nfb) {
            Frag a;
            load_a_trans<P>(a, hs, r0 + k0, 16 * fb);
            mma_pair<P>(dwa[j], dwx[j], a, b);
          }
        }
      }
      fold<P>(dwa, dwx);

      // dh += dl W^T over the chunk's columns, into the accumulator
      float dha[4][2][4] = {}, dhx[4][2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < kBwdCols; k0 += 16) {
        Frag a;
        load_a<P>(a, ls, 16 * wr, k0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int fb = wc + 2 * j;
          if (fb < nfb) {
            Frag b;
            load_b_trans<P>(b, ws, 16 * fb, k0);
            mma_pair<P>(dha[j], dhx[j], a, b);
          }
        }
      }
      fold<P>(dha, dhx);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + 16 * wr + g + 8 * hr;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int f = 16 * (wc + 2 * j) + 8 * t + 2 * q;
            if (r < rows && f < fp) {  // columns F..fp of W's planes are 0
              float2* acc = reinterpret_cast<float2*>(dh_s + r * ldd + f);
              float2 v = *acc;
              v.x += dha[j][t][2 * hr];
              v.y += dha[j][t][2 * hr + 1];
              *acc = v;
            }
          }
        }
      __syncthreads();  // before the next tile overwrites dl and the db parts
    }

    float prev[4][2][2][2] = {};
    if (accumulate) load_dw(prev, dw, 0, F, A, n0);
    store_dw(dw, dwa, prev, 0, F, A, n0, valid, accumulate);
    if (tid < kBwdCols && n0 + tid < A) {
      const int col = n0 + tid;
      const float v = col < valid ? db_s[tid] : 0.0f;
      db[col] = accumulate ? db[col] + v : v;
    }
  }
  __syncthreads();
  float* out = dh_part + (size_t)blockIdx.x * B * F;
  for (int i = tid; i < rows * F; i += kThreads)
    out[(size_t)g0 * F + i] = dh_s[i / F * ldd + i % F];
}

// Bytes of shared memory of ce_bwd_mma_sliced_kernel: W's and dl's planes,
// the planes of one tile of h, db per warp row, the tile's dh accumulator.
__host__ __device__ inline size_t bwd_mma_sliced_smem(int F, int P) {
  const size_t fp = (F + 15) / 16 * 16, planes = P == 1 ? 2 : 1;
  return 2 * planes * (fp + kMmaRows) * kMmaLd + 2 * planes * kMmaRows * (fp + 8) +
         4 * 4 * kBwdCols + 4 * (size_t)kMmaRows * dh_ld(F);
}

// F > kBwdSliceF: one tile of at most 64 rows a launch, so the tile's dl is
// computed once per chunk and dW and dh go over F in slices of kBwdSliceF
// (8 f blocks, the dW accumulators a warp holds), written per slice. W's
// chunk goes through registers into its planes, its loads in flight while
// the block computes the chunk before it (a staging buffer, 64 KB at
// F = 256, does not fit beside h's planes and dh).
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
ce_bwd_mma_sliced_kernel(const float* __restrict__ h, const float* __restrict__ w,
                         const float* __restrict__ bias, const long long* __restrict__ labels,
                         const float* __restrict__ lse, const float* __restrict__ ct,
                         float* __restrict__ dw, float* __restrict__ db,
                         float* __restrict__ dh_part, int B, int F, int A, int valid, int g0,
                         int g1, int accumulate) {
  using namespace mma_tile;
  constexpr bool LO = P == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int fp = (F + 15) / 16 * 16, nfb = fp / 16, rows = g1 - g0;
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
  const Planes ws = planes(fp, kMmaLd);        // W's chunk (fp, kBwdCols), columns >= valid 0
  const Planes ls = planes(kMmaRows, kMmaLd);  // dl of the tile (kMmaRows, kBwdCols)
  const Planes hs = planes(kMmaRows, fp + 8);  // h's rows g0..g1 (kMmaRows, fp)
  float* db_part = reinterpret_cast<float*>(p);  // (4, kBwdCols)
  float* dh_s = db_part + 4 * kBwdCols;          // (rows, ldd)
  const int ldd = dh_ld(F);

  const int tid = threadIdx.x;
  const int n_chunks = (A + kBwdCols - 1) / kBwdCols;
  split_rows<P>(hs, h, g0, rows, kMmaRows, F, fp);
  for (int i = tid; i < rows * ldd; i += kThreads) dh_s[i] = 0.0f;

  // A chunk's W into registers, all of the thread's loads issued together
  // (rows k = tid / 32 + 8 i, columns c = 2 (tid % 32)), in flight while the
  // block computes the chunk before it; columns >= valid and rows >= F as 0.
  constexpr int kLoads = kBwdMaxF * kBwdCols / 2 / kThreads, kRowStep = kThreads / (kBwdCols / 2);
  const int kr = tid / (kBwdCols / 2), c = 2 * (tid % (kBwdCols / 2));
  float x[kLoads][2];
  auto fetch = [&](int chunk) {
    const int n0 = chunk * kBwdCols;
    const bool ok0 = n0 + c < valid, ok1 = n0 + c + 1 < valid;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int k = kr + i * kRowStep;
      const float* src = w + (size_t)(k < F ? k : 0) * A + n0 + c;
      x[i][0] = k < F && ok0 ? src[0] : 0.0f;
      x[i][1] = k < F && ok1 ? src[1] : 0.0f;
    }
  };
  if ((int)blockIdx.x < n_chunks) fetch(blockIdx.x);

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int n0 = chunk * kBwdCols;
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int k = kr + i * kRowStep;
      if (k < fp) store_split2<P>(ws, k * ws.ld + c, x[i][0], x[i][1]);
    }
    __syncthreads();  // W's planes are ready
    if (chunk + (int)gridDim.x < n_chunks) fetch(chunk + gridDim.x);

    float bcol[2][2][2];
    bias_cols(bcol, bias, n0, valid);
    float s[2][2][4] = {};
    logits_mma<P>(s, hs, ws, 0, fp);
    dl_tile<P>(s, bcol, ls, db_part, lse, ct, labels, g0, 0, rows, n0, valid);
    __syncthreads();  // dl's planes and the db parts are complete
    if (tid < kBwdCols && n0 + tid < A) {
      const int col = n0 + tid;
      const float v = col < valid ? db_rows(db_part, tid) : 0.0f;
      db[col] = accumulate ? db[col] + v : v;
    }
    for (int fb0 = 0; fb0 < nfb; fb0 += kBwdSliceF / 16) {
      // the earlier launches' dW of the slice, its loads in flight during
      // the products
      float prev[4][2][2][2] = {};
      if (accumulate) load_dw(prev, dw, fb0, F, A, n0);
      float dwa[4][2][4] = {};
      dw_tile<P>(dwa, ls, hs, 0, fb0, nfb);
      store_dw(dw, dwa, prev, fb0, F, A, n0, valid, accumulate);
      dh_tile<P>(dh_s, ldd, ls, ws, 0, rows, fb0, nfb, fp);
    }
  }
  __syncthreads();
  float* out = dh_part + (size_t)blockIdx.x * B * F;
  for (int i = tid; i < rows * F; i += kThreads)
    out[(size_t)g0 * F + i] = dh_s[i / F * ldd + i % F];
}

int bwd_blocks(int A) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int n_chunks = (A + kBwdCols - 1) / kBwdCols;
  return n_chunks < sms ? n_chunks : sms;
}

// Rows per launch of ce_bwd_mma_kernel: whole tiles, as many as fit; of
// ce_bwd_mma_sliced_kernel (F > kBwdSliceF): one tile.
int bwd_mma_group_rows(int B, int F, int P) {
  if (F > kBwdSliceF)
    return bwd_mma_sliced_smem(F, P) > kMaxSmem ? 0 : (kMmaRows < B ? kMmaRows : B);
  const size_t fixed = bwd_mma_smem(F, P, 0), tile = bwd_mma_smem(F, P, kMmaRows) - fixed;
  if (fixed + tile > kMaxSmem) return 0;
  const size_t rows = (kMaxSmem - fixed) / tile * kMmaRows;
  return (int)(rows < (size_t)B ? rows : B);
}

// Rows per launch of ce_bwd_kernel: as many as let the (rows, F) dh
// accumulator fit.
int bwd_group_rows(int B, int F) {
  const size_t fixed = bwd_layout(F).fixed * sizeof(float);
  if (fixed >= kMaxSmem) return 0;
  size_t rows = (kMaxSmem - fixed) / (sizeof(float) * F);
  rows = rows / kBwdRows * kBwdRows;
  return (int)(rows < (size_t)B ? rows : B);
}

// "highest" (P == 0) runs ce_bwd_kernel on the CUDA cores, "high" and
// "default" ce_bwd_mma_kernel (or past kBwdSliceF ce_bwd_mma_sliced_kernel)
// on the tensor cores.
template <int P>
cudaError_t launch_bwd(const float* h, const float* w, const float* b, const long long* labels,
                       const float* lse, const float* ct, float* dw, float* db, float* dh,
                       float* dh_part, int B, int F, int A, int valid, cudaStream_t st) {
  static size_t allowed[kMaxDevices] = {};  // per instantiation: one kernel
  static size_t allowed_sliced[kMaxDevices] = {};
  cudaError_t err = cudaSuccess;
  const int nblk = bwd_blocks(A);
  const int rows = P == 0 ? bwd_group_rows(B, F) : bwd_mma_group_rows(B, F, P);
  if (rows < 1) return cudaErrorInvalidValue;
  const int vec = A % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  for (int g0 = 0; g0 < B; g0 += rows) {
    const int g1 = g0 + rows < B ? g0 + rows : B;
    if constexpr (P == 0) {
      const size_t smem = (bwd_layout(F).fixed + (size_t)(g1 - g0) * F) * sizeof(float);
      err = allow_smem((const void*)ce_bwd_kernel, smem, allowed);
      if (err != cudaSuccess) return err;
      ce_bwd_kernel<<<nblk, kThreads, smem, st>>>(h, w, b, labels, lse, ct, dw, db, dh_part, B, F,
                                                  A, valid, g0, g1, g0 > 0);
    } else if (F > kBwdSliceF) {
      const size_t smem = bwd_mma_sliced_smem(F, P);
      err = allow_smem((const void*)ce_bwd_mma_sliced_kernel<P>, smem, allowed_sliced);
      if (err != cudaSuccess) return err;
      ce_bwd_mma_sliced_kernel<P><<<nblk, kThreads, smem, st>>>(
          h, w, b, labels, lse, ct, dw, db, dh_part, B, F, A, valid, g0, g1, g0 > 0);
    } else {
      const size_t smem = bwd_mma_smem(F, P, g1 - g0);
      err = allow_smem((const void*)ce_bwd_mma_kernel<P>, smem, allowed);
      if (err != cudaSuccess) return err;
      ce_bwd_mma_kernel<P><<<nblk, kThreads, smem, st>>>(
          h, w, b, labels, lse, ct, dw, db, dh_part, B, F, A, valid, g0, g1, g0 > 0, vec);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n = B * F;
  ce_dh_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(dh_part, dh, n, nblk);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that fused_ce_fwd needs for (B, F, A) at `precision`:
// per-row partials, one per column block.
extern "C" long long fused_ce_fwd_scratch(int B, int F, int A, int precision) {
  const int cols = fwd_cols(F, precision);
  return 3LL * B * ((A + cols - 1) / cols);
}

// Launches B1 on `stream`: lse and label logit (B) of h W + b masked at
// columns >= valid. In "high" and "default" F may be at most
// kWalkNarrowMaxF (256). Returns cudaGetLastError() (0 on success).
extern "C" int fused_ce_fwd(const float* h, const float* w, const float* b,
                            const long long* labels, float* lse, float* g, float* scratch, int B,
                            int F, int A, int valid, int precision, void* stream) {
  if (B < 1 || F < 1 || A < 1 || valid < 0 || valid > A || precision < 0 || precision > 2 ||
      (precision != 0 && F > mma_tile::kWalkNarrowMaxF))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = fwd_cols(F, precision);
  const dim3 grid((A + cols - 1) / cols, (B + kTileRows - 1) / kTileRows);
  cudaError_t err;
  if (precision == 1) {
    err = launch_fwd_mma<1>(h, w, b, labels, scratch, B, F, A, valid, st);
  } else if (precision == 2) {
    err = launch_fwd_mma<2>(h, w, b, labels, scratch, B, F, A, valid, st);
  } else {
    ce_fwd_kernel<<<grid, kThreads, 0, st>>>(h, w, b, labels, scratch, B, F, A, valid);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = kThreads / 32;
  ce_merge_kernel<<<(B + rows_per_block - 1) / rows_per_block, kThreads, 0, st>>>(
      scratch, lse, g, B, (int)grid.x);
  return (int)cudaGetLastError();
}

// Floats of scratch that fused_ce_bwd needs for (B, F, A): per-block dh parts.
extern "C" long long fused_ce_bwd_scratch(int B, int F, int A) {
  return (long long)bwd_blocks(A) * B * F;
}

// Launches B2 on `stream`: dW (F, A), db (A) and dh (B, F) of
// sum_i ct[i] * CE_i. F may be at most kBwdMaxF (256). Returns
// cudaGetLastError().
extern "C" int fused_ce_bwd(const float* h, const float* w, const float* b,
                            const long long* labels, const float* lse, const float* ct, float* dw,
                            float* db, float* dh, float* scratch, int B, int F, int A, int valid,
                            int precision, void* stream) {
  if (B < 1 || F < 1 || F > kBwdMaxF || A < 1 || valid < 0 || valid > A || precision < 0 ||
      precision > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (precision == 0)
    return (int)launch_bwd<0>(h, w, b, labels, lse, ct, dw, db, dh, scratch, B, F, A, valid, st);
  if (precision == 1)
    return (int)launch_bwd<1>(h, w, b, labels, lse, ct, dw, db, dh, scratch, B, F, A, valid, st);
  return (int)launch_bwd<2>(h, w, b, labels, lse, ct, dw, db, dh, scratch, B, F, A, valid, st);
}
