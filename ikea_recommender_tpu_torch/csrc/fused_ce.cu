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
// Precision of the three products, as _dot/_dot3 of the TPU kernels:
//   0 "highest": fp32 FMA.
//   1 "high": each operand x is split into hi = bf16(x), lo = bf16(x - hi),
//     and the kernel sums hi*hi + hi*lo + lo*hi in fp32. A product of two
//     bf16 values is exact in fp32, so this is the TPU's bf16x3 function up
//     to the order of the sums.
//   2 "default": bf16(a) * bf16(b) summed in fp32.
// Every product runs on the CUDA cores here; moving "high" and "default"
// onto bf16 tensor cores is later work, so until then "high" does three
// times the FMAs of "highest" and is slower.
//
// What bounds it: at the train point (B=256, F=64, A=70852) B1 reads W once
// (18.1 MB) and does 2.32 GFLOP per pass, B2 reads W and writes dW (36 MB)
// and does three such products. On the card's fp32 CUDA-core rate
// (67 TFLOP/s) both are bound by operations: ~0.035 ms and ~0.104 ms. With
// bf16 tensor cores (989 TFLOP/s) "high" would be ~0.007 and ~0.021 ms.
//
// B1 design: the TPU walks column blocks in order and carries the running
// (max, sum-exp, label logit) from one grid step to the next. Here each
// block owns 128 columns x 64 rows, computes its logits tile in registers
// (a 4 x 8 tile per thread, K in chunks of 16 through shared memory), and
// writes per-row partials (m, s, g) of its columns; a second kernel merges
// them per row: m = max m_i, s = sum s_i exp(m_i - m), g = sum g_i,
// lse = m + log s. The -1e30 sentinel is finite, never -inf, so a block
// whose columns are all masked gives m_i = -1e30 and vanishes in the merge.
//
// B2 design: one block per SM, each walking a strided set of 64-column
// chunks. For a chunk it keeps W's columns (tail zeroed) and the dW and db
// accumulators in shared memory and loops over all rows in tiles of 32,
// recomputing each logits tile, so dW and db of its columns are summed by
// this block alone: no atomics. dh is a sum over all column chunks: each
// block accumulates its own (B, F) part in shared memory and writes it once;
// a second kernel sums the parts in a fixed order, so dh is the same from
// run to run. Where (B, F) does not fit next to the tiles, the rows go in
// groups, one launch each, adding into dW and db.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;

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

// ---------------------------------------------------------------------------
// B1: per-(column block, row) partials, then a per-row merge
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 64, kFwdCols = 128, kFwdK = 16;

template <int P>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ bias, const long long* __restrict__ labels,
              float* __restrict__ part, int B, int F, int A, int valid) {
  constexpr bool LO = P == 1;
  __shared__ float h_hi[kFwdRows][kFwdK + 1], h_lo[LO ? kFwdRows : 1][kFwdK + 1];
  __shared__ float w_hi[kFwdK][kFwdCols], w_lo[LO ? kFwdK : 1][kFwdCols];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kFwdCols, m0 = blockIdx.y * kFwdRows;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < F; k0 += kFwdK) {
    for (int e = tid; e < kFwdRows * kFwdK; e += kThreads) {
      const int m = e / kFwdK, k = e % kFwdK;
      const float x = (m0 + m < B && k0 + k < F) ? h[(size_t)(m0 + m) * F + k0 + k] : 0.0f;
      float hi, lo;
      split<P>(x, hi, lo);
      h_hi[m][k] = hi;
      if constexpr (LO) h_lo[m][k] = lo;
    }
    for (int e = tid; e < kFwdK * kFwdCols; e += kThreads) {
      const int k = e / kFwdCols, n = e % kFwdCols;
      const float x = (k0 + k < F && n0 + n < A) ? w[(size_t)(k0 + k) * A + n0 + n] : 0.0f;
      float hi, lo;
      split<P>(x, hi, lo);
      w_hi[k][n] = hi;
      if constexpr (LO) w_lo[k][n] = lo;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kFwdK; ++k) {
      float ahi[4], alo[4], bhi[8], blo[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ahi[i] = h_hi[ty + 16 * i][k];
        alo[i] = LO ? h_lo[ty + 16 * i][k] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bhi[j] = w_hi[k][tx + 16 * j];
        blo[j] = LO ? w_lo[k][tx + 16 * j] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = mac<P>(ahi[i], alo[i], bhi[j], blo[j], acc[i][j]);
    }
    __syncthreads();
  }

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
constexpr int kBwdMaxF = 128;

struct BwdLayout {
  int wp, hp, dp;  // padded row lengths of the W, h and dl tiles
  size_t fixed;    // floats besides the dh accumulator
};

__host__ __device__ inline BwdLayout bwd_layout(int F, int P) {
  BwdLayout L;
  L.wp = kBwdCols + 1;
  L.hp = F + 1;
  L.dp = kBwdCols + 1;
  const int parts = P == 1 ? 2 : 1;  // hi (and lo) copies of W and h
  L.fixed = (size_t)parts * F * L.wp + (size_t)parts * kBwdRows * L.hp +
            (size_t)(1 + parts) * kBwdRows * L.dp  // dl, its hi (and lo)
            + (size_t)F * kBwdCols + kBwdCols;     // dW and db accumulators
  return L;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
              const float* __restrict__ bias, const long long* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ ct,
              float* __restrict__ dw, float* __restrict__ db, float* __restrict__ dh_part,
              int B, int F, int A, int valid, int g0, int g1, int accumulate) {
  constexpr bool LO = P == 1;
  extern __shared__ float smem[];
  const BwdLayout L = bwd_layout(F, P);
  float* p = smem;
  float* w_hi = p;  // (F, wp) W's chunk, columns >= valid zeroed
  p += F * L.wp;
  float* w_lo = p;
  if (LO) p += F * L.wp;
  float* h_hi = p;  // (kBwdRows, hp)
  p += kBwdRows * L.hp;
  float* h_lo = p;
  if (LO) p += kBwdRows * L.hp;
  float* dl = p;  // (kBwdRows, dp) dlogits, fp32
  p += kBwdRows * L.dp;
  float* dl_hi = P == 0 ? dl : p;
  if (P != 0) p += kBwdRows * L.dp;
  float* dl_lo = p;
  if (LO) p += kBwdRows * L.dp;
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
      const float x = n0 + c < valid ? w[(size_t)k * A + n0 + c] : 0.0f;
      float hi, lo;
      split<P>(x, hi, lo);
      w_hi[k * L.wp + c] = hi;
      if constexpr (LO) w_lo[k * L.wp + c] = lo;
      dw_s[e] = 0.0f;
    }
    for (int c = tid; c < kBwdCols; c += kThreads) db_s[c] = 0.0f;

    for (int r0 = g0; r0 < g1; r0 += kBwdRows) {
      __syncthreads();  // the previous tile's readers are done
      for (int e = tid; e < kBwdRows * F; e += kThreads) {
        const int r = e / F, k = e % F;
        const float x = r0 + r < g1 ? h[(size_t)(r0 + r) * F + k] : 0.0f;
        float hi, lo;
        split<P>(x, hi, lo);
        h_hi[r * L.hp + k] = hi;
        if constexpr (LO) h_lo[r * L.hp + k] = lo;
      }
      __syncthreads();

      // logits of the tile: rows ty + 16 i, columns tx + 16 j
      float acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int k = 0; k < F; ++k) {
        float ahi[2], alo[2], bhi[4], blo[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ahi[i] = h_hi[(ty + 16 * i) * L.hp + k];
          alo[i] = LO ? h_lo[(ty + 16 * i) * L.hp + k] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bhi[j] = w_hi[k * L.wp + tx + 16 * j];
          blo[j] = LO ? w_lo[k * L.wp + tx + 16 * j] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = mac<P>(ahi[i], alo[i], bhi[j], blo[j], acc[i][j]);
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
          if constexpr (P != 0) {
            float hi, lo;
            split<P>(d, hi, lo);
            dl_hi[r * L.dp + c] = hi;
            if constexpr (LO) dl_lo[r * L.dp + c] = lo;
          }
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
          const float ahi[2] = {h_hi[r * L.hp + fa], h_hi[r * L.hp + fb]};
          const float alo[2] = {LO ? h_lo[r * L.hp + fa] : 0.0f, LO ? h_lo[r * L.hp + fb] : 0.0f};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float bhi = dl_hi[r * L.dp + tx + 16 * j];
            const float blo = LO ? dl_lo[r * L.dp + tx + 16 * j] : 0.0f;
#pragma unroll
            for (int i = 0; i < 2; ++i) a[i][j] = mac<P>(ahi[i], alo[i], bhi, blo, a[i][j]);
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
          float ahi[2], alo[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ahi[i] = dl_hi[(ty + 16 * i) * L.dp + c];
            alo[i] = LO ? dl_lo[(ty + 16 * i) * L.dp + c] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float bhi = w_hi[fj[j] * L.wp + c];
            const float blo = LO ? w_lo[fj[j] * L.wp + c] : 0.0f;
#pragma unroll
            for (int i = 0; i < 2; ++i) a[i][j] = mac<P>(ahi[i], alo[i], bhi, blo, a[i][j]);
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

int bwd_blocks(int A) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int n_chunks = (A + kBwdCols - 1) / kBwdCols;
  return n_chunks < sms ? n_chunks : sms;
}

// Rows per launch: as many as let the (rows, F) dh accumulator fit.
int bwd_group_rows(int B, int F, int P) {
  const size_t fixed = bwd_layout(F, P).fixed * sizeof(float);
  if (fixed >= kMaxSmem) return 0;
  size_t rows = (kMaxSmem - fixed) / (sizeof(float) * F);
  rows = rows / kBwdRows * kBwdRows;
  return (int)(rows < (size_t)B ? rows : B);
}

cudaError_t allow_smem(const void* kernel, size_t smem, size_t* allowed) {
  if (smem <= 48 * 1024 || *allowed >= smem) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess) *allowed = smem;
  return err;
}

template <int P>
cudaError_t launch_bwd(const float* h, const float* w, const float* b, const long long* labels,
                       const float* lse, const float* ct, float* dw, float* db, float* dh,
                       float* dh_part, int B, int F, int A, int valid, cudaStream_t st) {
  // Raise the dynamic shared-memory limit once per device and instantiation.
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  size_t scratch = 0;
  size_t* allow = dev < kMaxDevices ? &allowed[dev] : &scratch;

  const int nblk = bwd_blocks(A);
  const int rows = bwd_group_rows(B, F, P);
  if (rows < 1) return cudaErrorInvalidValue;
  for (int g0 = 0; g0 < B; g0 += rows) {
    const int g1 = g0 + rows < B ? g0 + rows : B;
    const size_t smem = (bwd_layout(F, P).fixed + (size_t)(g1 - g0) * F) * sizeof(float);
    err = allow_smem((const void*)ce_bwd_kernel<P>, smem, allow);
    if (err != cudaSuccess) return err;
    ce_bwd_kernel<P><<<nblk, kThreads, smem, st>>>(h, w, b, labels, lse, ct, dw, db, dh_part, B,
                                                   F, A, valid, g0, g1, g0 > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n = B * F;
  ce_dh_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(dh_part, dh, n, nblk);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that fused_ce_fwd needs for (B, A): per-row partials.
extern "C" long long fused_ce_fwd_scratch(int B, int A) {
  return 3LL * B * ((A + kFwdCols - 1) / kFwdCols);
}

// Launches B1 on `stream`: lse and label logit (B) of h W + b masked at
// columns >= valid. Returns cudaGetLastError() (0 on success).
extern "C" int fused_ce_fwd(const float* h, const float* w, const float* b,
                            const long long* labels, float* lse, float* g, float* scratch, int B,
                            int F, int A, int valid, int precision, void* stream) {
  if (B < 1 || F < 1 || A < 1 || valid < 0 || valid > A || precision < 0 || precision > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((A + kFwdCols - 1) / kFwdCols, (B + kFwdRows - 1) / kFwdRows);
  if (precision == 0)
    ce_fwd_kernel<0><<<grid, kThreads, 0, st>>>(h, w, b, labels, scratch, B, F, A, valid);
  else if (precision == 1)
    ce_fwd_kernel<1><<<grid, kThreads, 0, st>>>(h, w, b, labels, scratch, B, F, A, valid);
  else
    ce_fwd_kernel<2><<<grid, kThreads, 0, st>>>(h, w, b, labels, scratch, B, F, A, valid);
  cudaError_t err = cudaGetLastError();
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
// sum_i ct[i] * CE_i. F may be at most 128. Returns cudaGetLastError().
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
