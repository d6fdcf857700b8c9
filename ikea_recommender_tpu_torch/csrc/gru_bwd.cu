// B4 backward on Hopper: the adjoint of the length-masked GRU recurrence of
// gru_fwd.cu (B3).
//
// Replaces ikea_recommender_tpu/ops/gru_pallas.py::_bwd_kernel (launched there
// by _backward). The steps run in the opposite order of the forward: t = T-1
// down to 0, or 0 up to T-1 with `reverse` (whose forward walked downwards).
// At each step every batch row b recomputes the gates from xw[b, t] and
// h_prev = y[b, t_prev] (t_prev = t-1, or t+1 with `reverse`; zero at the
// forward's first step), gates ordered r|z|n along the 3H axis:
//   dh    += gy[b, t]                        (dh starts at g_hfin[b])
//   dh_t   = m dh,  dh_skip = (1 - m) dh     (m = mask[b, t]; 1 without mask)
//   da_n   = dh_t (1 - z)(1 - n^2),  da_z = dh_t (h_prev - n) z (1 - z)
//   dhn    = da_n r,  da_r = da_n hn r (1 - r)
//   dxw[b, t] = [da_r, da_z, da_n],  dhw = [da_r, da_z, dhn]
//   dW_h  += h_prev^T dhw,  db_h += dhw,  dh = dh_t z + dhw W_h^T + dh_skip
// All products are fp32 FMA (Precision.HIGHEST in the TPU kernel).
// Layouts are batch-major and contiguous: xw and dxw (B, T, 3H), W_h (H, 3H),
// b_h (3H), mask (B, T) or null, y and gy (B, T, H), g_hfin (B, H).
//
// Types: xw, W_h, b_h, y, gy, g_hfin, dxw and the returned [dW_h; db_h] are
// all fp32 (gru_bwd) or all bf16 (gru_bwd_bf16); the mask and the scratch dhw
// are fp32 in both. bf16 is only what memory holds, as in the TPU kernel
// (gru_pallas.py:175-212, 258-270): every value is widened to fp32 where it
// is read, so h_prev is the forward's stored bf16 y widened (the gates are
// recomputed from it, never from the forward's fp32 carry); every product,
// gate and the dh carry are fp32; dxw rounds to bf16 where it is stored; dhw
// stays fp32, so dW_h and db_h are fp32 sums over all (b, t), rounded to bf16
// once at their store. A staged step's xw, h_prev and gy rows stay bf16 in
// the ring and are widened where they are read; W_h (shared-memory layout),
// b_h and g_hfin are widened once while they are staged, so every other
// layout below is as in fp32.
//
// What bounds it: the T steps are serial, as in the forward, and each step
// does two dependent products of the forward's size (recompute h_prev W_h,
// then dhw W_h^T) with block barriers between them. At the train point
// (B=256, T=10, H=64) the call moves about 7 MB and does about 0.19 GFLOP, a
// few microseconds at the card's peak rates; what sets its time is the
// latency of a step's chain and the instructions each warp runs in it,
// T times over, and then the h_prev^T dhw product.
//
// Design, two launches and no atomics:
// 1. gru_bwd_kernel runs the adjoint with 512 threads a block. Batch rows
//    are independent, so each block owns R rows (R = 2 up to H = 128, 128
//    blocks at B = 256; R = 1 above) and runs the whole time loop (the TPU
//    kernel's sequential grid axis) by itself. W_h and b_h sit in shared
//    memory up to H = 128 (W_h's rows padded to an odd number of 16-byte
//    quads), and W_h is read through L2 above.
//    - Loads off the chain: a step's rows of xw, h_prev, gy and the mask
//      come into a ring of two staged steps by cp.async (16 bytes a copy
//      where the rows are 16-byte multiples and aligned: H % 4 == 0 in fp32,
//      H % 8 == 0 in bf16; else 4 bytes in fp32 and plain 2-byte loads in
//      bf16), step s + 2's
//      started as soon as step s frees its buffer; W_h, b_h and g_hfin
//      arrive with step 0.
//    - Shorter chains: each product is cut into about one piece a warp.
//      h_prev W_h: 128 columns (a lane 4 adjacent ones, W_h's rows read as
//      float4) over a slice of k; dhw W_h^T: 32 units (a lane one, its W_h
//      row read as float4) over a slice of the columns. Each slice's sums
//      go to shared memory, and all threads then add the slices in order.
//    - h_prev W_h needs no dh, so step s + 1's runs beside step s's
//      dhw W_h^T: a step is [both products] -> sums -> gates, three
//      barriers.
//    - Where every row of the block is masked at a step, the step only
//      carries dh and writes the zeros of dxw and dhw.
//    It writes dhw (B, T, 3H) for the second launch.
// 2. gru_dwh_kernel forms [dW_h; db_h] = sum over (b, t) of [h_prev; 1]^T dhw
//    as one product: a block owns a 32 x 32 tile of dW_h (the tiles of the
//    first 32 units add the db_h row: no tile holds only it) over one eighth
//    of the B T rows, staged 64 rows at a time by cp.async into a ring of
//    two; its warps' tiles are added in warp order. The eight blocks of a
//    tile form a thread block cluster: each sends row i of its tile to block
//    i % 8 through distributed shared memory, which adds the eight in rank
//    order. So the sum order is fixed and two launches on the same inputs
//    agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gru_io.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gru_io;

constexpr int kThreads = 512;        // an adjoint block
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kMaxSmemH = 128;       // W_h in shared memory up to this H
constexpr int kStages = 2;           // the ring of staged steps
constexpr int kDwThreads = 256;      // a dW_h block
constexpr int kDwStages = 2;         // the ring of staged row slabs of dW_h
constexpr int kTile = 32;            // dW_h tile: units x columns
constexpr int kSlab = 64;            // rows (b, t) of the dW_h product staged at once
constexpr int kCluster = 8;          // blocks splitting the rows of one dW_h tile

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---- Staging rows into shared memory by cp.async ----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 (or 4) bytes from src, or writes zeros where src is null (a
// source size of 0 reads nothing from `any`, a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, const void* any) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src ? src : any), "r"(src ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, const float* any) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src ? src : any), "r"(src ? 4 : 0)
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

// Starts the copies of `rows` rows of n floats into dst (row stride ld),
// spread over the block's threads: element e of row r from src_of(r, e), or
// zero where that is null. VEC: 16-byte copies (n, ld, e and the source
// rows multiples of 4 floats, 16-byte aligned); else 4-byte copies.
template <bool VEC, typename Src>
__device__ __forceinline__ void stage_rows(float* dst, int ld, int rows, int n, const float* any,
                                           Src src_of) {
  constexpr int kVec = VEC ? 4 : 1;
  const int per = n / kVec;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, e = (i - r * per) * kVec;
    if constexpr (VEC) {
      cp_async16(dst + r * ld + e, src_of(r, e), any);
    } else {
      cp_async4(dst + r * ld + e, src_of(r, e), any);
    }
  }
}

// ---- The adjoint ------------------------------------------------------------

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// W_h's row pitch in shared memory: 3H rounded up to 4 floats, and then to an
// odd number of 16-byte quads, so that 8 lanes reading quad q of 8
// consecutive rows (dhw W_h^T) hit 8 distinct groups of 4 banks.
__host__ __device__ constexpr int w_pitch(int H) {
  return round4(3 * H) + ((round4(3 * H) / 4) % 2 == 0 ? 4 : 0);
}

// How each product is cut: h_prev W_h into blocks of 128 columns times KS
// slices of the k quads, dhw W_h^T into blocks of 32 units times CS slices
// of the column quads; plan() picks KS and CS for about one piece a warp.
__host__ __device__ constexpr int col_blocks(int H) { return cdiv(3 * H, 128); }
__host__ __device__ constexpr int unit_blocks(int H) { return cdiv(H, 32); }

// Offsets (floats) into the adjoint's dynamic shared memory; esz: the bytes
// of a value in memory (4 or 2), which size the staged rows: XR and HR
// floats hold a 16-byte padded row of 3H and of H values (X4 and H4 in fp32).
struct Layout {
  int WP, X4, H4, XR, HR, stage, bh, st, hwp, dhw, carry, dhp, total;
  __host__ __device__ Layout(int H, int R, bool w_smem, int ks, int cs, int esz)
      : WP(w_pitch(H)), X4(round4(3 * H)), H4(round4(H)), XR(round4(cdiv(3 * H * esz, 4))),
        HR(round4(cdiv(H * esz, 4))), stage(R * (XR + 2 * HR) + 4),
        bh(w_smem ? H4 * WP : 0), st(bh + X4), hwp(st + kStages * stage),
        dhw(hwp + ks * R * X4), carry(dhw + R * X4), dhp(carry + R * H4),
        total(dhp + cs * R * H4) {}
};

template <int R, bool W_SMEM, bool VEC, typename Tm>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_kernel(const Tm* __restrict__ xw, const Tm* __restrict__ wh,
               const Tm* __restrict__ bh, const float* __restrict__ mask,
               const Tm* __restrict__ y, const Tm* __restrict__ gy,
               const Tm* __restrict__ ghfin, Tm* __restrict__ dxw,
               float* __restrict__ dhw, int B, int T, int H, int reverse, int KS, int CS) {
  static_assert(R == 1 || R == 2, "one or two rows a block");
  constexpr bool kF32 = std::is_same<Tm, float>::value;
  extern __shared__ __align__(16) float smem[];
  const Layout L(H, R, W_SMEM, KS, CS, sizeof(Tm));
  const int H3 = 3 * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  float* w_s = smem;              // (H4, WP) W_h, zero past H rows and 3H columns
  float* hwp_s = smem + L.hwp;    // (KS, R, X4) slices of h_prev W_h
  float* dhw_s = smem + L.dhw;    // (R, X4) [da_r, da_z, dhn], zero past 3H
  float* carry_s = smem + L.carry;  // (R, H4) dh_t z + dh_skip
  float* dhp_s = smem + L.dhp;    // (CS, R, H4) slices of dhw W_h^T
  // a staged step in memory's type: xw (R, XR), h_prev (R, HR), gy (R, HR);
  // then the mask (R)
  auto staged = [&](int s) { return smem + L.st + (s % kStages) * L.stage; };
  // value j of row r of a staged block at `base`, rows `pitch` floats apart
  auto at = [&](const float* base, int pitch, int r, int j) {
    return f32(reinterpret_cast<const Tm*>(base + r * pitch)[j]);
  };

  // A step's copies, one flat index each, so that a thread starts one or
  // two a step with no division: xw rows, h_prev rows, gy rows, the mask. A
  // copy moves kv values: 16 bytes (VEC), else one value (4-byte cp.async in
  // fp32, a plain load and store in bf16).
  constexpr int kv = VEC ? 16 / (int)sizeof(Tm) : 1;
  const int px = L.XR * 4 / ((int)sizeof(Tm) * kv), ph = L.HR * 4 / ((int)sizeof(Tm) * kv);
  const int n_copies = R * (px + 2 * ph) + (mask != nullptr ? R : 0);
  auto stage_step = [&](int s) {
    float* st = staged(s);
    const int t = reverse ? s : T - 1 - s;
    const int tp = reverse ? t + 1 : t - 1;
    const bool first = reverse ? t == T - 1 : t == 0;
    for (int i = tid; i < n_copies; i += kThreads) {
      int n = i;
      if (n < R * px) {
        const int r = R == 2 && n >= px, e = (n - r * px) * kv, b = row0 + r;
        const Tm* src = b < B && e < H3 ? xw + ((size_t)b * T + t) * H3 + e : nullptr;
        Tm* dst = reinterpret_cast<Tm*>(st + r * L.XR) + e;
        if constexpr (VEC) cp_async16(dst, src, xw);
        else if constexpr (kF32) cp_async4(dst, src, xw);
        else *dst = src != nullptr ? *src : to_mem<Tm>(0.0f);
        continue;
      }
      n -= R * px;
      if (n < 2 * R * ph) {  // h_prev, then gy
        const bool g = n >= R * ph;
        n -= g ? R * ph : 0;
        const int r = R == 2 && n >= ph, e = (n - r * ph) * kv, b = row0 + r;
        const Tm* src = nullptr;
        if (b < B && e < H && (g || !first))
          src = g ? gy + ((size_t)b * T + t) * H + e : y + ((size_t)b * T + tp) * H + e;
        Tm* dst = reinterpret_cast<Tm*>(st + R * L.XR + (g ? R * L.HR : 0) + r * L.HR) + e;
        if constexpr (VEC) cp_async16(dst, src, gy);
        else if constexpr (kF32) cp_async4(dst, src, gy);
        else *dst = src != nullptr ? *src : to_mem<Tm>(0.0f);
        continue;
      }
      const int r = n - 2 * R * ph, b = row0 + r;
      cp_async4(st + R * (L.XR + 2 * L.HR) + r, b < B ? mask + (size_t)b * T + t : nullptr, mask);
    }
  };

  // W_h, b_h, the dh carry and the first step arrive together; in bf16 the
  // first three are widened by plain loads, issued while step 0's copies fly
  if constexpr (kF32) {
    if constexpr (W_SMEM) {
      stage_rows<VEC>(w_s, L.WP, L.H4, L.WP, wh, [&](int k, int c) -> const float* {
        return k < H && c < H3 ? wh + (size_t)k * H3 + c : nullptr;
      });
    }
    stage_rows<false>(smem + L.bh, 0, 1, H3, bh, [&](int, int c) { return bh + c; });
    stage_rows<VEC>(carry_s, L.H4, R, L.H4, ghfin, [&](int r, int j) -> const float* {
      const int b = row0 + r;
      return b < B && j < H ? ghfin + (size_t)b * H + j : nullptr;
    });
  }
  stage_step(0);
  cp_async_commit();
  if constexpr (!kF32) {
    if constexpr (W_SMEM) {
      widen_rows<VEC, 8>(w_s, L.WP, L.H4, L.X4, [&](int k, int c) -> const bf16* {
        return k < H && c < H3 ? wh + (size_t)k * H3 + c : nullptr;
      });
      for (int i = tid; i < L.H4 * (L.WP - L.X4); i += kThreads)  // the pitch's padding
        w_s[(i / (L.WP - L.X4)) * L.WP + L.X4 + i % (L.WP - L.X4)] = 0.0f;
    }
    widen_rows<false, 1>(smem + L.bh, 0, 1, H3, [&](int, int c) { return bh + c; });
    widen_rows<VEC, 1>(carry_s, L.H4, R, L.H4, [&](int r, int j) -> const bf16* {
      const int b = row0 + r;
      return b < B && j < H ? ghfin + (size_t)b * H + j : nullptr;
    });
  }
  for (int i = tid; i < R * (L.X4 - H3); i += kThreads)
    dhw_s[(i / (L.X4 - H3)) * L.X4 + H3 + i % (L.X4 - H3)] = 0.0f;

  const int ncb = col_blocks(H), qk = L.H4 / 4, kq = cdiv(qk, KS);
  const int nub = unit_blocks(H), qc = L.X4 / 4, cq = cdiv(qc, CS);

  // Whether step s has a row the mask lets through (block-uniform).
  auto is_active = [&](int s) {
    const float* m_st = staged(s) + R * (L.XR + 2 * L.HR);
    bool active = false;
#pragma unroll
    for (int r = 0; r < R; ++r) active |= row0 + r < B && (mask == nullptr || m_st[r] != 0.0f);
    return active;
  };

  // h_prev W_h of step s into KS slices: a warp takes slice ks of the k
  // quads for 128 columns, a lane 4 adjacent ones (W_h's rows read as
  // float4). The sums below add the slices into slice 0.
  auto hw_slices = [&](int s) {
    const float* hp_st = staged(s) + R * L.XR;
    for (int item = warp; item < ncb * KS; item += kWarps) {
      const int ks = item % KS, c = (item / KS) * 128 + 4 * lane;
      const int q0 = ks * kq, q1 = min(qk, q0 + kq);
      float4 acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int q = q0; q < q1; ++q) {
        float4 h[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          h[r] = ld4(reinterpret_cast<const Tm*>(hp_st + r * L.HR) + 4 * q);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 4 * q + i;
          float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if constexpr (W_SMEM) {
            if (c < L.WP) w = *reinterpret_cast<const float4*>(w_s + k * L.WP + c);
          } else if constexpr (VEC) {
            if (k < H && c < H3) w = ldg4(wh + (size_t)k * H3 + c);
          } else if (k < H) {
            const Tm* row = wh + (size_t)k * H3;
            w = make_float4(c < H3 ? f32(__ldg(row + c)) : 0.0f,
                            c + 1 < H3 ? f32(__ldg(row + c + 1)) : 0.0f,
                            c + 2 < H3 ? f32(__ldg(row + c + 2)) : 0.0f,
                            c + 3 < H3 ? f32(__ldg(row + c + 3)) : 0.0f);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float hk = i == 0 ? h[r].x : i == 1 ? h[r].y : i == 2 ? h[r].z : h[r].w;
            acc[r].x = fmaf(hk, w.x, acc[r].x);
            acc[r].y = fmaf(hk, w.y, acc[r].y);
            acc[r].z = fmaf(hk, w.z, acc[r].z);
            acc[r].w = fmaf(hk, w.w, acc[r].w);
          }
        }
      }
      if (c < L.X4) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          *reinterpret_cast<float4*>(hwp_s + (ks * R + r) * L.X4 + c) = acc[r];
      }
    }
  };

  // dhw W_h^T into CS slices: a warp takes slice cs of the column quads for
  // units j = 32 jb + lane (W_h's row j read as float4).
  auto dh_slices = [&]() {
    for (int item = warp; item < nub * CS; item += kWarps) {
      const int cs = item % CS, j = (item / CS) * 32 + lane;
      const int q0 = cs * cq, q1 = min(qc, q0 + cq);
      float acc0[R], acc1[R];  // even and odd quads: two chains
#pragma unroll
      for (int r = 0; r < R; ++r) acc0[r] = acc1[r] = 0.0f;
      auto quad = [&](int q, float(&a)[R]) {
        float4 w;
        if constexpr (W_SMEM) {
          w = *reinterpret_cast<const float4*>(w_s + j * L.WP + 4 * q);
        } else if constexpr (VEC) {
          w = ldg4(wh + (size_t)j * H3 + 4 * q);
        } else {
          const Tm* row = wh + (size_t)j * H3;
          const int c = 4 * q;
          w = make_float4(c < H3 ? f32(__ldg(row + c)) : 0.0f,
                          c + 1 < H3 ? f32(__ldg(row + c + 1)) : 0.0f,
                          c + 2 < H3 ? f32(__ldg(row + c + 2)) : 0.0f,
                          c + 3 < H3 ? f32(__ldg(row + c + 3)) : 0.0f);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(dhw_s + r * L.X4 + 4 * q);
          a[r] = fmaf(d.x, w.x, a[r]);
          a[r] = fmaf(d.y, w.y, a[r]);
          a[r] = fmaf(d.z, w.z, a[r]);
          a[r] = fmaf(d.w, w.w, a[r]);
        }
      };
      if (j < H) {
        int q = q0;
        for (; q + 1 < q1; q += 2) {
          quad(q, acc0);
          quad(q + 1, acc1);
        }
        if (q < q1) quad(q, acc0);
#pragma unroll
        for (int r = 0; r < R; ++r) dhp_s[(cs * R + r) * L.H4 + j] = acc0[r] + acc1[r];
      }
    }
  };

  bool active = false;   // step s has a row the mask lets through
  bool pending = false;  // dhp_s holds the last step's dhw W_h^T

  // The chain of a step: [h_prev W_h of step s+1 beside dhw W_h^T of step
  // s] -> barrier -> sums -> barrier -> gates -> barrier. h_prev W_h needs no
  // dh, so it runs a step ahead, in the phase of the previous step's dhw
  // W_h^T; the pass at s = -1 only stages step 1 and forms step 0's.
  for (int s = -1; s < T; ++s) {
    if (s >= 0) {
      const int t = reverse ? s : T - 1 - s;
      const float* xw_st = staged(s);
      const float* hp_st = xw_st + R * L.XR;
      const float* gy_st = hp_st + R * L.HR;
      const float* m_st = gy_st + R * L.HR;
      __syncthreads();  // the slices of the phase before are written

      // dh entering the step: the carry, the last step's dhw W_h^T, and gy
      auto dh_in = [&](int r, int j) {
        float dh = carry_s[r * L.H4 + j];
        if (pending) {
          float a = 0.0f;
#pragma unroll 4
          for (int c = 0; c < CS; ++c) a += dhp_s[(c * R + r) * L.H4 + j];
          dh += a;
        }
        return dh + at(gy_st, L.HR, r, j);
      };

      if (active) {
        // the sums: h_prev W_h + b_h into slice 0, and dh entering the step
        for (int i = tid; i < R * (H3 + H); i += kThreads) {
          if (i < R * H3) {
            const int r = R == 2 && i >= H3, c = i - r * H3;
            float a = 0.0f;
#pragma unroll 4
            for (int ks = 0; ks < KS; ++ks) a += hwp_s[(ks * R + r) * L.X4 + c];
            hwp_s[r * L.X4 + c] = a + smem[L.bh + c];
          } else {
            const int n = i - R * H3, r = R == 2 && n >= H, j = n - r * H;
            carry_s[r * L.H4 + j] = dh_in(r, j);
          }
        }
        __syncthreads();

        // the gates and their adjoints, per (row, unit)
        for (int i = tid; i < R * H; i += kThreads) {
          const int r = i / H, j = i - r * H, b = row0 + r;
          const float* hw = hwp_s + r * L.X4;
          const float hr = hw[j], hz = hw[H + j], hn = hw[2 * H + j];
          const float rg = sigmoid(at(xw_st, L.XR, r, j) + hr);
          const float zg = sigmoid(at(xw_st, L.XR, r, H + j) + hz);
          const float ng = tanhf(at(xw_st, L.XR, r, 2 * H + j) + rg * hn);
          const float m = mask == nullptr ? 1.0f : m_st[r];
          const float dh = carry_s[r * L.H4 + j];
          const float dh_t = dh * m;
          const float dh_skip = dh * (1.0f - m);
          const float dn = dh_t * (1.0f - zg);
          const float dz = dh_t * (at(hp_st, L.HR, r, j) - ng);
          const float da_n = dn * (1.0f - ng * ng);
          const float dr = da_n * hn;
          const float dhn = da_n * rg;
          const float da_z = dz * zg * (1.0f - zg);
          const float da_r = dr * rg * (1.0f - rg);
          if (b < B) {
            const size_t o = ((size_t)b * T + t) * H3;
            dxw[o + j] = to_mem<Tm>(da_r);
            dxw[o + H + j] = to_mem<Tm>(da_z);
            dxw[o + 2 * H + j] = to_mem<Tm>(da_n);
            dhw[o + j] = da_r;
            dhw[o + H + j] = da_z;
            dhw[o + 2 * H + j] = dhn;
          }
          float* d = dhw_s + r * L.X4;
          d[j] = da_r;
          d[H + j] = da_z;
          d[2 * H + j] = dhn;
          carry_s[r * L.H4 + j] = dh_t * zg + dh_skip;
        }
      } else {
        // every row masked: dh_t = 0, so dxw = dhw = 0 and dh only moves on
        for (int i = tid; i < R * H; i += kThreads) {
          const int r = i / H, j = i - r * H, b = row0 + r;
          carry_s[r * L.H4 + j] = dh_in(r, j);
          if (b < B) {
            const size_t o = ((size_t)b * T + t) * H3;
            dxw[o + j] = dxw[o + H + j] = dxw[o + 2 * H + j] = to_mem<Tm>(0.0f);
            dhw[o + j] = dhw[o + H + j] = dhw[o + 2 * H + j] = 0.0f;
          }
        }
      }
      if (s + 1 == T) break;  // the last step's dh leaves the kernel unused
    }

    // Step s + 1's rows have landed and step s is done with its buffer,
    // which takes step s + 2.
    cp_async_wait<0>();
    __syncthreads();
    if (s + 2 < T) stage_step(s + 2);
    cp_async_commit();
    pending = active;
    if (active) dh_slices();
    active = is_active(s + 1);
    if (active) hw_slices(s + 1);
  }
}

// ---- [dW_h; db_h] -----------------------------------------------------------

// out (H + 1, 3H) = sum over rows q = b T + t of [h_prev(q); 1]^T dhw(q),
// h_prev(q) = y[b, t_prev] (zero at the forward's first step). Block
// (x, y, z) owns units 32x.. and columns 32y.. over the z-th eighth of the
// rows, staged 64 rows a slab; warp w takes rows 8w..8w+7 of each slab, and
// its lane (tk, tc) units 4tk..4tk+3 by columns 8tc..8tc+7. In the x = 0
// blocks the lanes also sum their columns of dhw (db_h, row 32 of the tile;
// those of tk = 0 keep it). The block adds its warps' tiles in warp order
// and sends row i of the result to the cluster's block i % 8, which adds
// the eight blocks' rows in rank order. In bf16, y's slab stays bf16 (a
// (64, 32) half of its slot) and is widened where it is read, and out is
// rounded to bf16 at its store; dhw and every sum are fp32.
template <bool VEC, typename Tm>
__global__ void __cluster_dims__(1, 1, kCluster) __launch_bounds__(kDwThreads)
gru_dwh_kernel(const Tm* __restrict__ y, const float* __restrict__ dhw,
               Tm* __restrict__ out, int B, int T, int H, int reverse) {
  constexpr bool kF32 = std::is_same<Tm, float>::value;
  constexpr int kDwWarps = kDwThreads / 32;
  constexpr int kOwned = cdiv(kTile + 1, kCluster);  // rows of the tile a block sums
  // the ring of slabs (h_prev rows, dhw rows); after the loop, the warps' tiles
  __shared__ __align__(16) float ring_s[kDwStages][2][kSlab][kTile];
  __shared__ float dbw_s[kDwWarps][kTile];            // the warps' db_h sums
  __shared__ float recv_s[kCluster][kOwned][kTile];   // the rows sent here, by rank
  static_assert(kDwStages * 2 * kSlab >= kDwWarps * kTile, "the warps' tiles fit the ring");
  static_assert(kSlab == 8 * kDwWarps, "eight rows of a slab a warp");
  static_assert(kSlab * kTile == 2 * 4 * kDwThreads, "two 16-byte copies a thread an operand");
  cg::cluster_group cluster = cg::this_cluster();
  const int H3 = 3 * H, Q = B * T;
  const int k0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int rank = (int)cluster.block_rank();
  const int chunk = cdiv(Q, kCluster);
  const int q0 = min(Q, rank * chunk), q1 = min(Q, q0 + chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tk = lane >> 2, tc = lane & 3;
  // Every block of the cluster must have started before another writes into
  // its shared memory: arrive now, wait before the first such write.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // VEC: thread tid copies rows tid / 8 and tid / 8 + 32 of each slab at
  // column 4 (tid % 8) (in bf16, of dhw only; y's row tid / 4 at column
  // 8 (tid % 4)); the steps t of those rows move on by kSlab % T a slab.
  const int vr = tid >> 3, ve = 4 * (tid & 7), dt = kSlab % T;
  int vt[2] = {(q0 + vr) % T, (q0 + vr + 32) % T};
  const int br = tid >> 2, be = 8 * (tid & 3);
  int bt = (q0 + br) % T;
  // the (h_prev, k) value of slab row r, or null: zero at the forward's first step
  auto h_prev = [&](int q, int t, int k) -> const Tm* {
    if (q >= q1 || k >= H || (reverse ? t == T - 1 : t == 0)) return nullptr;
    return y + (size_t)(q + (reverse ? 1 : -1)) * H + k;
  };
  auto stage_slab = [&](int n) {  // rows q0 + 64 n ..
    const int qs = q0 + n * kSlab;
    float(*slab)[kSlab][kTile] = ring_s[n % kDwStages];
    Tm(*yb)[kTile] = reinterpret_cast<Tm(*)[kTile]>(&slab[0][0][0]);  // y's rows
    if constexpr (VEC) {
      if constexpr (!kF32) {
        cp_async16(&yb[br][be], h_prev(qs + br, bt, k0 + be), y);
        bt = bt + dt >= T ? bt + dt - T : bt + dt;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = vr + 32 * m, q = qs + r, t = vt[m];
        if constexpr (kF32) cp_async16(&yb[r][ve], h_prev(q, t, k0 + ve), y);
        cp_async16(&slab[1][r][ve], q < q1 && c0 + ve < H3 ? dhw + (size_t)q * H3 + c0 + ve : nullptr,
                   dhw);
        vt[m] = t + dt >= T ? t + dt - T : t + dt;
      }
    } else {
      if constexpr (kF32) {
        stage_rows<false>(&slab[0][0][0], kTile, kSlab, kTile, y,
                          [&](int r, int e) { return h_prev(qs + r, (qs + r) % T, k0 + e); });
      } else {
        for (int i = tid; i < kSlab * kTile; i += kDwThreads) {
          const int r = i / kTile, e = i % kTile;
          const Tm* src = h_prev(qs + r, (qs + r) % T, k0 + e);
          yb[r][e] = src != nullptr ? *src : to_mem<Tm>(0.0f);
        }
      }
      stage_rows<false>(&slab[1][0][0], kTile, kSlab, kTile, dhw,
                        [&](int r, int e) -> const float* {
                          const int q = qs + r, c = c0 + e;
                          return q < q1 && c < H3 ? dhw + (size_t)q * H3 + c : nullptr;
                        });
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  float db[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) db[j] = 0.0f;

  auto rows = [&](auto with_db, const Tm(*a)[kTile], const float(*v)[kTile]) {
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = 8 * warp + rr;
      const float4 av = ld4(&a[r][4 * tk]);
      const float4 v0 = *reinterpret_cast<const float4*>(&v[r][8 * tc]);
      const float4 v1 = *reinterpret_cast<const float4*>(&v[r][8 * tc + 4]);
      const float as[4] = {av.x, av.y, av.z, av.w};
      const float vs[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(as[i], vs[j], acc[i][j]);
      if constexpr (decltype(with_db)::value) {
#pragma unroll
        for (int j = 0; j < 8; ++j) db[j] += vs[j];
      }
    }
  };

  const int slabs = cdiv(q1 - q0, kSlab);
  for (int n = 0; n < kDwStages - 1; ++n) {
    if (n < slabs) stage_slab(n);
    cp_async_commit();
  }
  for (int n = 0; n < slabs; ++n) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();  // slab n visible; every thread done with slab n - 1
    if (n + kDwStages - 1 < slabs) stage_slab(n + kDwStages - 1);
    cp_async_commit();
    const Tm(*a)[kTile] = reinterpret_cast<const Tm(*)[kTile]>(&ring_s[n % kDwStages][0][0][0]);
    const float(*v)[kTile] = ring_s[n % kDwStages][1];
    if (blockIdx.x == 0) {  // every lane sums its columns; those of tk = 0 keep them
      rows(std::true_type{}, a, v);
    } else {
      rows(std::false_type{}, a, v);
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' tiles
  float(*tiles)[kTile][kTile] = reinterpret_cast<float(*)[kTile][kTile]>(&ring_s[0][0][0][0]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) tiles[warp][4 * tk + i][8 * tc + j] = acc[i][j];
  if (tk == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dbw_s[warp][8 * tc + j] = db[j];
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // row i of the block's tile (row 32: db_h) goes to block i % 8, slot rank
  for (int e = tid; e < (kTile + 1) * kTile; e += kDwThreads) {
    const int i = e / kTile, c = e % kTile;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kDwWarps; ++w) sum += i < kTile ? tiles[w][i][c] : dbw_s[w][c];
    *cluster.map_shared_rank(&recv_s[rank][i / kCluster][c], i % kCluster) = sum;
  }
  cluster.sync();  // every block's rows have arrived; no block reads another after this
  for (int e = tid; e < kOwned * kTile; e += kDwThreads) {
    const int m = e / kTile, i = rank + kCluster * m, c = e % kTile;
    if (i > kTile || c0 + c >= H3 || (i < kTile ? k0 + i >= H : blockIdx.x != 0)) continue;
    float sum = 0.0f;
#pragma unroll
    for (int src = 0; src < kCluster; ++src) sum += recv_s[src][m][c];
    out[(size_t)(i < kTile ? k0 + i : H) * H3 + c0 + c] = to_mem<Tm>(sum);
  }
}

// ---- Launches ---------------------------------------------------------------

struct Plan {
  bool w_smem;
  int rows, ks, cs;
  size_t smem;
};

size_t smem_bytes(int H, int R, bool w_smem, int ks, int cs, int esz) {
  return sizeof(float) * (size_t)Layout(H, R, w_smem, ks, cs, esz).total;
}

// esz: the bytes of a value in memory.
Plan plan(int H, int esz) {
  int ks = max(1, min(kWarps / col_blocks(H), round4(H) / 4));
  int cs = max(1, min(kWarps / unit_blocks(H), round4(3 * H) / 4));
  if (H <= kMaxSmemH) {
    int k = ks, c = cs;
    while (smem_bytes(H, 2, true, k, c, esz) > kMaxSmem && (k > 1 || c > 1)) {
      if (k >= c) --k;
      else --c;
    }
    if (smem_bytes(H, 2, true, k, c, esz) <= kMaxSmem)
      return {true, 2, k, c, smem_bytes(H, 2, true, k, c, esz)};
  }
  return {false, 1, ks, cs, smem_bytes(H, 1, false, ks, cs, esz)};
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Raises the dynamic shared-memory limit of gru_bwd_kernel<R, W_SMEM, VEC, Tm>
// once per device (and not inside a CUDA graph capture, where the same
// launch recurs); each instantiation keeps its own record.
template <int R, bool W_SMEM, bool VEC, typename Tm>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(gru_bwd_kernel<R, W_SMEM, VEC, Tm>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

template <typename Tm>
struct Args {
  const Tm *xw, *wh, *bh;
  const float* mask;
  const Tm *y, *gy, *ghfin;
  Tm* dxw;
  float* dhw;
  Tm* out;
  int B, T, H, reverse;
};

template <int R, bool W_SMEM, bool VEC, typename Tm>
cudaError_t launch(const Args<Tm>& a, const Plan& pl, cudaStream_t stream) {
  cudaError_t err = allow_smem<R, W_SMEM, VEC, Tm>(pl.smem);
  if (err != cudaSuccess) return err;
  gru_bwd_kernel<R, W_SMEM, VEC, Tm><<<(a.B + R - 1) / R, kThreads, pl.smem, stream>>>(
      a.xw, a.wh, a.bh, a.mask, a.y, a.gy, a.ghfin, a.dxw, a.dhw, a.B, a.T, a.H, a.reverse,
      pl.ks, pl.cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.H, kTile), cdiv(3 * a.H, kTile), kCluster);
  gru_dwh_kernel<VEC, Tm><<<grid, kDwThreads, 0, stream>>>(a.y, a.dhw, a.out, a.B, a.T, a.H,
                                                          a.reverse);
  return cudaGetLastError();
}

// 16-byte copies where the rows of H and 3H values are 16-byte multiples
// and the bases aligned: H % 4 == 0 in fp32, H % 8 == 0 in bf16.
template <typename Tm>
int run(const Args<Tm>& a, void* stream) {
  if (a.B < 1 || a.T < 1 || a.H < 1 || a.H > 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl = plan(a.H, sizeof(Tm));
  const bool vec = a.H % (16 / (int)sizeof(Tm)) == 0 && aligned16(a.xw) && aligned16(a.wh) &&
                   aligned16(a.y) && aligned16(a.gy) && aligned16(a.ghfin) && aligned16(a.dhw);
  if (pl.w_smem) {
    return (int)(vec ? launch<2, true, true>(a, pl, st) : launch<2, true, false>(a, pl, st));
  }
  return (int)(vec ? launch<1, false, true>(a, pl, st) : launch<1, false, false>(a, pl, st));
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() after the two launches
// (0 on success). `mask` may be null (every step advances h). `dhw` is fp32
// scratch of (B, T, 3H); `out` (H + 1, 3H) receives [dW_h; db_h]. gru_bwd
// takes fp32 tensors, gru_bwd_bf16 bf16 ones (the mask and dhw fp32 in both).
extern "C" int gru_bwd(const float* xw, const float* wh, const float* bh, const float* mask,
                       const float* y, const float* gy, const float* ghfin, float* dxw,
                       float* dhw, float* out, int B, int T, int H, int reverse,
                       void* stream) {
  return run<float>({xw, wh, bh, mask, y, gy, ghfin, dxw, dhw, out, B, T, H, reverse}, stream);
}

extern "C" int gru_bwd_bf16(const void* xw, const void* wh, const void* bh, const float* mask,
                            const void* y, const void* gy, const void* ghfin, void* dxw,
                            float* dhw, void* out, int B, int T, int H, int reverse,
                            void* stream) {
  auto in = [](const void* p) { return static_cast<const bf16*>(p); };
  auto io = [](void* p) { return static_cast<bf16*>(p); };
  return run<bf16>({in(xw), in(wh), in(bh), mask, in(y), in(gy), in(ghfin), io(dxw), dhw,
                    io(out), B, T, H, reverse},
                   stream);
}
