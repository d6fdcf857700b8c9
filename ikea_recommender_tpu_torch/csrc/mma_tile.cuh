// The tensor-core operand tile of B1, B2 (fused_ce.cu), B5 and B6
// (fused_argmax.cu) in "high" and "default": bf16 planes in shared memory,
// fed by ldmatrix to mma.sync.m16n8k16 with fp32 accumulators; and the head
// walk that B1, B5 and B6 share (below).
//
// Each fp32 operand x is split once, as it is staged into shared memory,
// into hi = bf16(x) and lo = bf16(x - hi) (P == 1, "high"; "default", P == 2,
// keeps hi only). A product is then hi*hi + hi*lo + lo*hi ("high") or hi*hi
// ("default") into fp32 accumulators: a product of two bf16 values is exact
// in fp32, so this is ikea_recommender_tpu/ops/fused_ce.py::_dot3 (and the
// twins' _dot) up to the order of the sums. The k dimension is padded with
// zeros to a multiple of 16.
//
// Plane layout: row-major bf16 with a row stride of (columns + 8) elements,
// columns a multiple of 16, so a row is 16 * odd bytes long and the eight
// 16-byte rows one ldmatrix phase reads fall on distinct banks.
//
// Fragments of mma.m16n8k16.row.col (g = lane / 4, q = lane % 4):
//   A (16 x 16): a0 (g, 2q..2q+1), a1 (g+8, 2q..), a2 (g, 2q+8..), a3 (g+8, 2q+8..)
//   B (16 x 8):  b0 (k = 2q..2q+1, n = g), b1 (k = 2q+8.., n = g)
//   C (16 x 8):  c0, c1 (g, 2q..2q+1), c2, c3 (g+8, 2q..2q+1)
// The loaders below give A of a 16 x 16 block and B of two adjacent n8 tiles
// (regs 0, 1: tile 0; regs 2, 3: tile 1) from a plane that stores the
// operand itself (row-major) or its transpose.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mma_tile {

using bf16 = __nv_bfloat16;

// hi and lo of x (lo is 0 unless P == 1).
template <int P>
__device__ __forceinline__ void split_bf16(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(P == 1 ? x - __bfloat162float(hi) : 0.0f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b on the bf16 tensor cores, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A pair of planes of one operand: hi and (P == 1) lo, same layout, row
// stride ld in elements.
struct Planes {
  bf16* hi;
  bf16* lo;
  int ld;
};

// Fragments of both planes (lo is loaded only when P == 1).
struct Frag {
  uint32_t hi[4], lo[4];
};

template <int P, bool TRANS>
__device__ __forceinline__ void load(Frag& f, const Planes& s, int offset) {
  if constexpr (TRANS) {
    ldsm_x4_trans(f.hi, s.hi + offset);
    if constexpr (P == 1) ldsm_x4_trans(f.lo, s.lo + offset);
  } else {
    ldsm_x4(f.hi, s.hi + offset);
    if constexpr (P == 1) ldsm_x4(f.lo, s.lo + offset);
  }
}

// The A fragment of the 16 x 16 block at (r0, c0) of planes that store A
// row-major: A = s[r0.., c0..].
template <int P>
__device__ __forceinline__ void load_a(Frag& f, const Planes& s, int r0, int c0) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  load<P, false>(f, s, (r0 + lane % 8 + (m & 1) * 8) * s.ld + c0 + (m >> 1) * 8);
}

// The A fragment from planes that store A's transpose (k rows, m columns):
// A = s[k0.., m0..]^T.
template <int P>
__device__ __forceinline__ void load_a_trans(Frag& f, const Planes& s, int k0, int m0) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  load<P, true>(f, s, (k0 + lane % 8 + (m >> 1) * 8) * s.ld + m0 + (m & 1) * 8);
}

// B fragments of two n8 tiles from planes that store B (k rows, n columns):
// B = s[k0..k0+15, n0..n0+15].
template <int P>
__device__ __forceinline__ void load_b(Frag& f, const Planes& s, int k0, int n0) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  load<P, true>(f, s, (k0 + lane % 8 + (m & 1) * 8) * s.ld + n0 + (m >> 1) * 8);
}

// B fragments of two n8 tiles from planes that store B's transpose (n rows,
// k columns): B = s[n0..n0+15, k0..k0+15]^T.
template <int P>
__device__ __forceinline__ void load_b_trans(Frag& f, const Planes& s, int n0, int k0) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  load<P, false>(f, s, (n0 + lane % 8 + (m >> 1) * 8) * s.ld + k0 + (m & 1) * 8);
}

// d[t] += A B_t for the two n8 tiles of b, at precision P: hi*hi, then (P
// == 1) hi*lo and lo*hi, all into d.
template <int P>
__device__ __forceinline__ void mma_pair(float (&d)[2][4], const Frag& a, const Frag& b) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    mma_bf16(d[t], a.hi, b.hi[2 * t], b.hi[2 * t + 1]);
    if constexpr (P == 1) {
      mma_bf16(d[t], a.hi, b.lo[2 * t], b.lo[2 * t + 1]);
      mma_bf16(d[t], a.lo, b.hi[2 * t], b.hi[2 * t + 1]);
    }
  }
}

// The same with the cross passes (P == 1) in their own fragment x, ~2^-8
// the size of hi*hi, so their sum rounds at its own scale; fold() adds x
// into d once per k loop.
template <int P>
__device__ __forceinline__ void mma_pair(float (&d)[2][4], float (&x)[2][4], const Frag& a,
                                         const Frag& b) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    mma_bf16(d[t], a.hi, b.hi[2 * t], b.hi[2 * t + 1]);
    if constexpr (P == 1) {
      mma_bf16(x[t], a.hi, b.lo[2 * t], b.lo[2 * t + 1]);
      mma_bf16(x[t], a.lo, b.hi[2 * t], b.hi[2 * t + 1]);
    }
  }
}

template <int P, int N>
__device__ __forceinline__ void fold(float (&d)[N][2][4], float (&x)[N][2][4]) {
  if constexpr (P == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[i][t][e] += x[i][t][e];
          x[i][t][e] = 0.0f;
        }
  }
}

// Stores the split of (x0, x1) at row-major position `offset` of the planes
// (4-byte aligned: offset even).
template <int P>
__device__ __forceinline__ void store_split2(const Planes& s, int offset, float x0, float x1) {
  bf16 h0, l0, h1, l1;
  split_bf16<P>(x0, h0, l0);
  split_bf16<P>(x1, h1, l1);
  *reinterpret_cast<__nv_bfloat162*>(s.hi + offset) = __halves2bfloat162(h0, h1);
  if constexpr (P == 1)
    *reinterpret_cast<__nv_bfloat162*>(s.lo + offset) = __halves2bfloat162(l0, l1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Columns n0..n0+COLS of the row-major (F, A) matrix w into the (F, COLS)
// fp32 buffer `stage` by cp.async, as one committed group; columns >= A
// read nothing and land as 0. With `vec` (A % 4 == 0 and w 16-byte
// aligned, so a 4-column segment lies wholly below or at/past A) a copy
// moves 16 bytes, else 4.
template <int COLS, int THREADS>
__device__ __forceinline__ void fetch_cols(float* stage, const float* w, int F, int A, int n0,
                                           int vec) {
  const int tid = threadIdx.x;
  if (vec) {
    for (int e = tid; e < F * COLS / 4; e += THREADS) {
      const int k = e / (COLS / 4), c = 4 * (e % (COLS / 4));
      float* dst = stage + k * COLS + c;
      if (n0 + c < A)
        cp_async16(dst, w + (size_t)k * A + n0 + c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = tid; e < F * COLS; e += THREADS) {
      const int k = e / COLS, c = e % COLS;
      if (n0 + c < A)
        cp_async4(stage + e, w + (size_t)k * A + n0 + c);
      else
        stage[e] = 0.0f;
    }
  }
  cp_async_commit();
}

// The staged (F, COLS) columns n0.. into the (fp, COLS) planes ws, rows F..fp
// and columns >= valid as 0, so nothing there (NaN included) reaches a
// product.
template <int P, int COLS, int THREADS>
__device__ __forceinline__ void split_cols(const Planes& ws, const float* stage, int F, int fp,
                                           int n0, int valid) {
  for (int e = threadIdx.x; e < fp * COLS / 2; e += THREADS) {
    const int k = e / (COLS / 2), c = 2 * (e % (COLS / 2));
    const float* src = stage + k * COLS + c;
    store_split2<P>(ws, k * ws.ld + c, k < F && n0 + c < valid ? src[0] : 0.0f,
                    k < F && n0 + c + 1 < valid ? src[1] : 0.0f);
  }
}

// The action-major forms of the two above, for B5 and B6 on the lazy
// optimizers' layout: w_am (A, ld) row-major, ld = K F, head k's F floats of
// action a at w_am[a ld + k F ..]; `w` points at head k's first float. Rows
// n0..n0+COLS go into the (COLS, F) fp32 buffer `stage` with a row stride of
// am_stride(F) = F + 4 floats (16-byte rows when F % 4 == 0); rows >= A read
// nothing and land as 0. With `vec` (F % 4 == 0 and w_am 16-byte aligned) a
// copy moves 16 bytes of a row, else 4.
__host__ __device__ inline int am_stride(int F) { return F + 4; }

template <int COLS, int THREADS>
__device__ __forceinline__ void fetch_rows_am(float* stage, const float* w, int F, int ld,
                                              int A, int n0, int vec) {
  const int tid = threadIdx.x, sf = am_stride(F);
  if (vec) {
    for (int e = tid; e < COLS * F / 4; e += THREADS) {
      const int c = e / (F / 4), k = 4 * (e % (F / 4));
      float* dst = stage + c * sf + k;
      if (n0 + c < A)
        cp_async16(dst, w + (size_t)(n0 + c) * ld + k);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = tid; e < COLS * F; e += THREADS) {
      const int c = e / F, k = e % F;
      if (n0 + c < A)
        cp_async4(stage + c * sf + k, w + (size_t)(n0 + c) * ld + k);
      else
        stage[c * sf + k] = 0.0f;
    }
  }
  cp_async_commit();
}

// The staged (COLS, F) rows into the (fp, COLS) planes ws, transposed, rows
// F..fp and columns >= valid as 0, as split_cols. A warp takes 8 rows k of
// the planes by 4 column pairs c: its reads stage[c (F + 4) + k] and its
// bf16x2 writes at k (COLS + 8) + c fall on 32 distinct banks at F = 64.
template <int P, int COLS, int THREADS>
__device__ __forceinline__ void split_rows_am(const Planes& ws, const float* stage, int F,
                                              int fp, int n0, int valid) {
  const int sf = am_stride(F), kb = fp / 8;
  for (int e = threadIdx.x; e < fp * COLS / 2; e += THREADS) {
    const int lane = e % 32, grp = e / 32;
    const int k = 8 * (grp % kb) + lane % 8, c = 8 * (grp / kb) + 2 * (lane / 8);
    const float* src = stage + c * sf + k;
    store_split2<P>(ws, k * ws.ld + c, k < F && n0 + c < valid ? src[0] : 0.0f,
                    k < F && n0 + c + 1 < valid ? src[sf] : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// The head walk of B1 (fused_ce.cu), B5 and B6 (fused_argmax.cu)
// ---------------------------------------------------------------------------
//
// A block of kWalkThreads threads owns COLS (128, 64 or 32) columns,
// n0 = COLS * blockIdx.x onwards, of K heads W_k (F, A), stored (K, F, A)
// contiguous, or with AM action-major (A, K F), as fetch_rows_am reads it.
// It splits them into planes once, columns >= valid and rows
// F..fp as 0, so nothing there (NaN included) reaches a product; each head
// comes through the fp32 staging buffer by cp.async. Then it walks all B
// rows of h (B, F) in tiles of kWalkRows. A tile arrives by cp.async in
// column slices of min(F, kWalkSlice) floats a row (one slice up to
// F = 128), each in flight while the block splits the slice before it into
// the tile's planes or computes the tile before it, so the staging buffer
// holds two slices (64 KB at most) at any F. Eight warps; warp (wr, wc) =
// (warp % 4, warp / 4) computes rows 16 wr.. of a tile at the block's
// columns COLS / 2 * wc + 16 i + 8 t + 2 q + e (i < COLS / 32; g = lane / 4,
// q = lane % 4): per tile and head k, acc[i][t][2 hr + e] holds (h W_k) at
// row g + 8 hr of those 16, summed over F padded to 16 by mma_pair (k
// chunks outer, column blocks inner). The walk hands them to the epilogue,
// epi(k, m0, acc) for k = 0..K-1, called by every thread of the block; the
// call may __syncthreads, and the walk's next write to shared memory comes
// after a __syncthreads of its own, so the epilogue may read its shared
// memory after its barrier. MAXF is the largest F the kernel is launched
// with: at MAXF <= kWalkSlice a tile is always one slice, and the compiler
// drops the slices' index arithmetic (at the 128 registers of two blocks
// an SM, B5 and B6 would otherwise spill).
constexpr int kWalkThreads = 256, kWalkRows = 64, kWalkSlice = 128;
// F the walk takes at 128 columns a block (B1, B5, B6): K = 1 head at
// F = 128 in "high" holds 172 KB.
constexpr int kWalkMaxF = 128;
// F it takes at 64 columns a block (B1 past kWalkMaxF): K = 1 head at
// F = 256 in "high" holds 202 KB, the planes of a tile of h 66 KB of them.
constexpr int kWalkNarrowMaxF = 256;

// Bytes of shared memory of the walk (the epilogue's come after them): the
// K heads' planes of W's columns, the planes of a tile of h, and the fp32
// staging buffer, which holds one head's (F, COLS) columns (action-major:
// (COLS, F + 4)) or two (kWalkRows, min(F, kWalkSlice)) slices of h. A
// multiple of 16.
__host__ __device__ inline size_t walk_smem(int F, int P, int K, int cols, bool am = false) {
  const size_t fp = (F + 15) / 16 * 16, planes = P == 1 ? 2 : 1;
  const size_t w_stage = 4 * (size_t)(am ? am_stride(F) : F) * cols;
  const size_t h_stage = 4 * (size_t)(F < kWalkSlice ? F : kWalkSlice) * 2 * kWalkRows;
  return 2 * planes * (K * fp * (cols + 8) + kWalkRows * (fp + 8)) +
         (w_stage > h_stage ? w_stage : h_stage);
}

template <int P, int COLS, class Epi, int MAXF = kWalkMaxF, bool AM = false>
__device__ __forceinline__ void head_walk(const float* __restrict__ h,
                                          const float* __restrict__ w, int B, int F, int A,
                                          int K, int valid, int vec_w, int vec_h,
                                          unsigned char* smem, Epi& epi) {
  static_assert(COLS == 128 || COLS == 64 || COLS == 32, "a warp takes 16, 32 or 64 columns");
  static_assert(MAXF <= kWalkNarrowMaxF, "W's and h's planes fit up to kWalkNarrowMaxF");
  constexpr bool LO = P == 1, ONE_SLICE = MAXF <= kWalkSlice;
  constexpr int NI = COLS / 32, LD = COLS + 8;
  const int fp = (F + 15) / 16 * 16;
  const size_t head = (size_t)fp * LD;  // elements of one head's plane
  unsigned char* p = smem;
  auto planes = [&](size_t n, int ld) {
    Planes s{reinterpret_cast<bf16*>(p), nullptr, ld};
    p += 2 * n;
    if (LO) {
      s.lo = reinterpret_cast<bf16*>(p);
      p += 2 * n;
    }
    return s;
  };
  const Planes ws = planes(K * head, LD);                   // K x (fp, COLS), >= valid 0
  const Planes hs = planes(kWalkRows * (size_t)(fp + 8), fp + 8);  // the tile (64, fp)
  float* stage = reinterpret_cast<float*>(p);  // (F, COLS) or 2 x (64, min(F, kWalkSlice))
  auto head_planes = [&](int k) {
    return Planes{ws.hi + k * head, LO ? ws.lo + k * head : nullptr, LD};
  };

  const int tid = threadIdx.x, warp = tid / 32, wr = warp % 4, wc = warp / 4;
  const int n0 = blockIdx.x * COLS;
  for (int k = 0; k < K; ++k) {
    if constexpr (AM)
      fetch_rows_am<COLS, kWalkThreads>(stage, w + (size_t)k * F, F, K * F, A, n0, vec_w);
    else
      fetch_cols<COLS, kWalkThreads>(stage, w + (size_t)k * F * A, F, A, n0, vec_w);
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (AM)
      split_rows_am<P, COLS, kWalkThreads>(head_planes(k), stage, F, fp, n0, valid);
    else
      split_cols<P, COLS, kWalkThreads>(head_planes(k), stage, F, fp, n0, valid);
    __syncthreads();  // the staging buffer is free
  }

  // unit u = (tile u / n_sl, slice u % n_sl): columns c0 = sl * (u % n_sl)..
  // of the tile's rows, sw of them, packed (rows, sw) into buffer u % 2;
  // with vec_h (F % 4 == 0, h 16-byte aligned; c0 and sw are then multiples
  // of 4) in 16-byte copies
  const int sl = ONE_SLICE || F < kWalkSlice ? F : kWalkSlice;
  const int n_sl = ONE_SLICE ? 1 : (F + sl - 1) / sl;
  const int n_units = (B + kWalkRows - 1) / kWalkRows * n_sl;
  auto fetch = [&](int u) {
    const int m0 = u / n_sl * kWalkRows, c0 = u % n_sl * sl;
    const int sw = F - c0 < sl ? F - c0 : sl;
    const int n = (B - m0 < kWalkRows ? B - m0 : kWalkRows) * sw;
    const float* src = h + (size_t)m0 * F + c0;
    float* dst = stage + (u % 2) * kWalkRows * sl;
    auto at = [&](int i) { return src + (ONE_SLICE ? (size_t)i : (size_t)(i / sw) * F + i % sw); };
    if (vec_h) {
      for (int i = 4 * tid; i < n; i += 4 * kWalkThreads) cp_async16(dst + i, at(i));
    } else {
      for (int i = tid; i < n; i += kWalkThreads) cp_async4(dst + i, at(i));
    }
    cp_async_commit();
  };
  fetch(0);
  for (int u = 0; u < n_units; ++u) {
    if (u + 1 < n_units) {
      fetch(u + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the slice has landed; the previous slice's readers are done
    const int m0 = u / n_sl * kWalkRows, c0 = u % n_sl * sl;
    const bool last = u % n_sl == n_sl - 1;
    const int sw = last ? F - c0 : sl, swp = last ? fp - c0 : sl;  // swp: sw padded to 16
    const float* cur = stage + (u % 2) * kWalkRows * sl;
    for (int e = tid; e < kWalkRows * swp / 2; e += kWalkThreads) {
      const int r = e / (swp / 2), c = 2 * (e % (swp / 2));
      const bool live = m0 + r < B;
      store_split2<P>(hs, r * hs.ld + c0 + c, live && c < sw ? cur[r * sw + c] : 0.0f,
                      live && c + 1 < sw ? cur[r * sw + c + 1] : 0.0f);
    }
    __syncthreads();
    if (!last) continue;
    // the tile's planes are complete: its products, head by head
    for (int k = 0; k < K; ++k) {
      const Planes wk = head_planes(k);
      float acc[NI][2][4] = {};
      for (int k0 = 0; k0 < fp; k0 += 16) {
        Frag a;
        load_a<P>(a, hs, 16 * wr, k0);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          Frag b;
          load_b<P>(b, wk, k0, COLS / 2 * wc + 16 * i);
          mma_pair<P>(acc[i], a, b);
        }
      }
      epi(k, m0, acc);
    }
  }
}

// Dynamic shared memory a block may hold on the H100.
constexpr size_t kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

// Lets `kernel` launch with `smem` bytes of dynamic shared memory on the
// current device. `allowed` (one array per kernel) remembers what each
// device was given, so the attribute is set once.
inline cudaError_t allow_smem(const void* kernel, size_t smem, size_t (&allowed)[kMaxDevices]) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

}  // namespace mma_tile
