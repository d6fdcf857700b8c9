// B3 forward on Hopper: the length-masked GRU recurrence over a precomputed
// input projection xw = x W_i + b_i.
//
// Replaces ikea_recommender_tpu/ops/gru_pallas.py::_fwd_kernel (launched there
// by _forward). For t = 0..T-1, or T-1..0 with `reverse`, every batch row b
// computes, gates ordered r|z|n along the 3H axis:
//   hw = h W_h + b_h                          (fp32 FMA, as Precision.HIGHEST)
//   r = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hn)
//   h = mask[b, t] > 0 ? (1 - z) * n + z * h : h       (h starts at zero)
//   y[b, t] = h, and h_fin[b] = h after the last step.
// Layouts are batch-major and contiguous: xw (B, T, 3H), W_h (H, 3H), b_h (3H),
// mask (B, T) or null for no masking, y (B, T, H), h_fin (B, H).
//
// Types: xw, W_h, b_h, y and h_fin are all fp32 (gru_fwd) or all bf16
// (gru_fwd_bf16, the compute_dtype="bfloat16" path); the mask is fp32 in both.
// bf16 is only what memory holds, as in the TPU kernel (gru_pallas.py:97-117):
// every value is widened to fp32 where it is read, every product and gate is
// fp32, the carried h stays fp32 in shared memory from step to step (never
// the rounded y), and only the stores of y and h_fin round to bf16 (to
// nearest even). A staged step's xw rows stay bf16 in the ring and are widened
// where the gates read them; W_h (shared-memory layout) and b_h are widened
// once while they are staged, so every other layout below is as in fp32.
//
// What bounds it: the T steps are serial. At the serving point (B=512, T=10,
// H=64) the call moves about 5.4 MB and does about 126 MFLOP, under 2 us at
// the card's peak rates; but each step's product needs the previous step's h,
// so the limit is T times the latency of one step: the product's FMAs, a
// barrier, the gate threads' chain (their slices' adds, tanhf three times),
// a barrier. The step is latency-bound, not FLOP-bound, so the tensor cores
// buy nothing; at H = 128 reading W_h from shared memory adds ~1500 cycles a
// step (192 KB at 128 bytes a cycle), which registers take in part.
//
// Design: batch rows are independent, so each block owns R rows and runs the
// whole time loop itself (the TPU kernel's sequential grid axis becomes this
// loop) and no block waits on another.
// - 512 threads a block (16 warps, four a scheduler) and R = 1, 2 or 4 rows:
//   plan() doubles R from 1 while the grid has more blocks than the card
//   has SMs and R < 4, so R = 2 at B = 256 (128 blocks), R = 4 at B = 512
//   (128 blocks; R = 2 there would be 256 blocks of 512 threads, which do
//   not fit two to an SM with W_h in registers or shared memory, so two
//   waves). Above 528 rows R stays 4 and the grid outgrows one wave: at the
//   eval batch B = 2000 it is 500 blocks, about 3.8 waves of 132.
// - The product h W_h is cut into pieces: a warp takes 32 CW columns of W_h
//   (a lane CW adjacent ones) over a slice of k quads, for all R rows, and
//   writes R x CW sums into that slice's buffer in shared memory. h comes
//   from shared memory as a float4 that every lane of the warp reads at once
//   (a broadcast). Where W_h lives depends on H:
//   * H <= 64: in registers for the whole time loop, CW = 2: 3 column blocks
//     x 4 slices of 4 k quads at H = 64 (12 warps, no idle lane, 32 floats a
//     lane at any R), loaded once by 8-byte loads while step 0 runs. A step's
//     product reads nothing but h from shared memory. (CW = 4 left a quarter
//     of the lanes idle in 8 warps, 16 at R = 4: the serving point took
//     0.0150 ms against 0.0134, PERF.md.)
//   * 64 < H <= 128: CW = 4, in shared memory, rows at a pitch of round4(3H)
//     floats (only rows are read, 32 lanes on 32 adjacent quads, so no padding
//     against bank conflicts is needed; 192 KB at H = 128), one piece a warp
//     (3 column blocks x 5 slices of 7 k quads at H = 128, R = 2; 3 slices
//     at R = 4, where more do not fit). A lane also holds its piece's first
//     4 k quads (2 at R = 4) in registers, which takes 4/7 of W_h's
//     shared-memory reads off the step at H = 128.
//   * H > 128: CW = 4, read from L2 (768 KB at H = 256 stays resident),
//     slices of 8 k quads, each warp taking several pieces.
// - A step is: [product into slices] -> barrier -> [the thread of each (row,
//   unit) adds its three gates' slices in slice order, + b_h, the gates, h
//   into shared memory, y to global] -> barrier. The order of every sum is
//   fixed, so two launches on the same inputs agree bit for bit. Step 0's
//   product is skipped: h starts at zero, so hw = b_h there. The (row, unit)
//   items are walked with no division in the loop, and sigmoid is taken as
//   (1 + tanhf(x / 2)) / 2: expf and an IEEE division made the gates' chain
//   three times as long (clock64 stamps, SASS).
// - Loads off the chain: step s + 1's xw rows and mask come by cp.async into
//   a ring of two, issued before step s's product (one flat index a copy, no
//   division; 16 bytes a copy where the rows are 16-byte multiples and
//   aligned: H % 4 == 0 in fp32, H % 8 == 0 in bf16; else 4 bytes in fp32,
//   and plain 2-byte loads in bf16, whose rows of odd 3H no 4-byte copy
//   fits). Issuing a copy holds its warp ~500 cycles, so the copies go to the
//   last warps, which the product at H <= 64 and the gates leave idle. b_h
//   and step 0 arrive first, then W_h (shared-memory layout), which only
//   step 1's product needs; the register layout's loads overlap step 0.
// - Steps where a block's rows are all masked still run the product: the
//   block holding a full-length row sets the grid's time anyway.
// Shared memory (floats): [W_h (H4, X4), shared-memory layout only] [b_h (X4)]
// [ring: 2 x (xw (R, XR), mask (R), pad)] [h (R, H4)] [slices (KS, R, X4)],
// X4 = round4(3H), H4 = round4(H), XR = the floats of a 16-byte padded row
// of 3H values in memory's type (X4 in fp32, about X4 / 2 in bf16); 6 KB of
// slices at H = 64, R = 2, 15 KB at H = 128, R = 2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gru_io.cuh"

namespace {

using namespace gru_io;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kRegH = 64;            // W_h in registers up to this H
constexpr int kMaxSmemH = 128;       // then in shared memory up to this H
constexpr int kL2Quads = 8;          // k quads a piece reads from L2
constexpr int kStages = 2;           // the ring of staged steps

enum WSource { kReg, kSmem, kL2 };

// The columns of W_h a lane takes in a piece (CW in the header).
__host__ __device__ constexpr int col_width(int w_src) { return w_src == kReg ? 2 : 4; }

// The k quads of its piece that a lane holds in registers: all 4 of them in
// the register layout, the first 4 (2 at R = 4, for the registers) in the
// shared-memory layout, which reads the rest from shared memory.
__host__ __device__ constexpr int reg_quads(int w_src, int R) {
  return w_src == kReg ? 4 : w_src == kSmem ? (R == 4 ? 2 : 4) : 0;
}

// sigmoid(x) = (1 + tanh(x / 2)) / 2: tanhf's chain is about a third of
// expf's followed by an IEEE division, and its 2-ulp error stays below
// 1.2e-7 here.
__device__ __forceinline__ float sigmoid(float x) { return fmaf(0.5f, tanhf(0.5f * x), 0.5f); }

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

// ---- The recurrence ---------------------------------------------------------

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Offsets (floats) into the dynamic shared memory; esz: the bytes of a value
// in memory (4 or 2), which size the staged xw rows.
struct Layout {
  int X4, H4, XR, stage, bh, st, h, hwp, total;
  __host__ __device__ Layout(int H, int R, bool w_smem, int ks, int esz)
      : X4(round4(3 * H)), H4(round4(H)), XR(round4(cdiv(3 * H * esz, 4))), stage(R * XR + 4),
        bh(w_smem ? H4 * X4 : 0), st(bh + X4), h(st + kStages * stage), hwp(h + R * H4),
        total(hwp + ks * R * X4) {}
};

template <int R, int W_SRC, bool VEC, typename Tm>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const Tm* __restrict__ xw, const Tm* __restrict__ wh,
               const Tm* __restrict__ bh, const float* __restrict__ mask,
               Tm* __restrict__ y, Tm* __restrict__ hfin, int B, int T, int H, int reverse,
               int KS) {
  static_assert(R == 1 || R == 2 || R == 4, "1, 2 or 4 rows a block");
  constexpr bool kF32 = std::is_same<Tm, float>::value;
  extern __shared__ __align__(16) float smem[];
  const Layout L(H, R, W_SRC == kSmem, KS, sizeof(Tm));
  const int H3 = 3 * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  float* w_s = smem;            // (H4, X4) W_h, zero past H rows and 3H columns
  float* bh_s = smem + L.bh;    // (X4) b_h
  float* h_s = smem + L.h;      // (R, H4) h of the step before, zero past H
  float* hwp_s = smem + L.hwp;  // (KS, R, X4) slices of h W_h
  // a staged step: xw (R, XR) in memory's type, mask (R)
  auto staged = [&](int s) { return smem + L.st + (s & 1) * L.stage; };

  // A step's copies, one flat index each: xw rows, then the mask. Copy i is
  // issued by thread 511 - i, so that the last warps, which the product (at
  // H <= 64) and the gates use least, carry them. A copy moves kv values:
  // 16 bytes (VEC), else one value (4-byte cp.async in fp32, a plain load
  // and store in bf16).
  constexpr int kv = VEC ? 16 / (int)sizeof(Tm) : 1;
  const int px = L.XR * 4 / ((int)sizeof(Tm) * kv);
  const int n_copies = R * px + (mask != nullptr ? R : 0);
  auto stage_step = [&](int s) {
    float* st = staged(s);
    const int t = reverse ? T - 1 - s : s;
    for (int i = kThreads - 1 - tid; i < n_copies; i += kThreads) {
      int n = i, r = 0;
      if (n < R * px) {
        while (n >= px) {  // r < R, no division
          n -= px;
          ++r;
        }
        const int e = n * kv, b = row0 + r;
        const Tm* src = b < B && e < H3 ? xw + ((size_t)b * T + t) * H3 + e : nullptr;
        Tm* dst = reinterpret_cast<Tm*>(st + r * L.XR) + e;
        if constexpr (VEC) cp_async16(dst, src, xw);
        else if constexpr (kF32) cp_async4(dst, src, xw);
        else *dst = src != nullptr ? *src : to_mem<Tm>(0.0f);
      } else {
        r = n - R * px;
        const int b = row0 + r;
        cp_async4(st + R * L.XR + r, b < B ? mask + (size_t)b * T + t : nullptr, mask);
      }
    }
  };

  // The pieces of the product: item = cb * KS + ks takes column block cb
  // (32 kCW columns, a lane kCW adjacent ones) over k quads [ks kq, ks kq +
  // kq). Lanes take 2 columns where W_h is in registers (3 blocks, no idle
  // lane, at H = 64), else 4 (a 16-byte read of W_h).
  constexpr int kCW = col_width(W_SRC);
  const int qk = L.H4 / 4, ncb = cdiv(L.X4, 32 * kCW), kq = cdiv(qk, KS), items = ncb * KS;
  const int ks0 = warp % KS, cb0 = warp / KS;  // this warp's first piece

  // W_h[k, c..c+kCW) as an array, zero past H rows and 3H columns.
  auto load_w = [&](int k, int c, float(&w)[kCW]) {
#pragma unroll
    for (int e = 0; e < kCW; ++e) w[e] = 0.0f;
    if (k >= H || c >= H3) return;
    const Tm* row = wh + (size_t)k * H3 + c;
    if constexpr (VEC && kCW == 4) {
      const float4 v = ldg4(row);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (VEC) {
      const float2 v = ldg2(row);
      w[0] = v.x, w[1] = v.y;
    } else {
#pragma unroll
      for (int e = 0; e < kCW; ++e) w[e] = c + e < H3 ? f32(__ldg(row + e)) : 0.0f;
    }
  };

  // b_h and step 0 first (group 1), then W_h in the shared-memory layout
  // (group 2); the register layout loads its piece meanwhile. In bf16, b_h
  // and W_h are widened by plain loads below, after the register pieces'
  // loads are issued, so that all of them fly beside step 0's copies.
  if constexpr (kF32) {
    stage_rows<false>(bh_s, 0, 1, L.X4, bh, [&](int, int c) -> const float* {
      return c < H3 ? bh + c : nullptr;
    });
  }
  stage_step(0);
  cp_async_commit();
  if constexpr (kF32 && W_SRC == kSmem) {
    stage_rows<VEC>(w_s, L.X4, L.H4, L.X4, wh, [&](int k, int c) -> const float* {
      return k < H && c < H3 ? wh + (size_t)k * H3 + c : nullptr;
    });
  }
  cp_async_commit();

  // This lane's kCW columns of W_h over the first kRegQ k quads of the
  // warp's piece.
  constexpr int kRegQ = reg_quads(W_SRC, R);
  float wreg[kRegQ > 0 ? kRegQ : 1][4][kCW];
  if constexpr (kRegQ > 0) {
    const int c = cb0 * 32 * kCW + kCW * lane;
#pragma unroll
    for (int qi = 0; qi < kRegQ; ++qi) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool mine = warp < items && qi < kq;
        load_w(mine ? 4 * (ks0 * kq + qi) + i : H, c, wreg[qi][i]);
      }
    }
  }
  for (int i = tid; i < R * L.H4; i += kThreads) h_s[i] = 0.0f;
  if constexpr (!kF32) {
    widen_rows<false, 1>(bh_s, 0, 1, L.X4, [&](int, int c) -> const bf16* {
      return c < H3 ? bh + c : nullptr;
    });
    if constexpr (W_SRC == kSmem) {
      widen_rows<VEC, 8>(w_s, L.X4, L.H4, L.X4, [&](int k, int c) -> const bf16* {
        return k < H && c < H3 ? wh + (size_t)k * H3 + c : nullptr;
      });
    }
  }

  // One piece: R x kCW sums of h[r, k] W_h[k, c + e] over its k, in k order.
  auto piece = [&](int cb, int ks) {
    const int c = cb * 32 * kCW + kCW * lane;
    const int q0 = ks * kq, q1 = min(qk, q0 + kq);
    float acc[R][kCW];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < kCW; ++e) acc[r][e] = 0.0f;
    auto quad = [&](int q, const float(&w)[4][kCW]) {
      float4 h[R];
#pragma unroll
      for (int r = 0; r < R; ++r) h[r] = *reinterpret_cast<const float4*>(h_s + r * L.H4 + 4 * q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hk = i == 0 ? h[r].x : i == 1 ? h[r].y : i == 2 ? h[r].z : h[r].w;
#pragma unroll
          for (int e = 0; e < kCW; ++e) acc[r][e] = fmaf(hk, w[i][e], acc[r][e]);
        }
      }
    };
#pragma unroll
    for (int qi = 0; qi < kRegQ; ++qi)
      if (q0 + qi < q1) quad(q0 + qi, wreg[qi]);
    if constexpr (W_SRC != kReg) {
#pragma unroll 2
      for (int q = q0 + kRegQ; q < q1; ++q) {
        float w[4][kCW];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (W_SRC == kSmem) {
            const float4 v = c < L.X4 ? *reinterpret_cast<const float4*>(w_s + (4 * q + i) * L.X4 + c)
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            w[i][0] = v.x, w[i][1] = v.y, w[i][2] = v.z, w[i][3] = v.w;
          } else {
            load_w(4 * q + i, c, w[i]);
          }
        }
        quad(q, w);
      }
    }
    if (c < L.X4) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float* out = hwp_s + (ks * R + r) * L.X4 + c;
        if constexpr (kCW == 4) {
          *reinterpret_cast<float4*>(out) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
          *reinterpret_cast<float2*>(out) = make_float2(acc[r][0], acc[r][1]);
        }
      }
    }
  };

  auto product = [&]() {
    if constexpr (kRegQ > 0) {
      if (warp < items) piece(cb0, ks0);  // the plan gives one piece a warp at most
    } else {
      for (int item = warp, cb = cb0, ks = ks0; item < items; item += kWarps) {
        piece(cb, ks);
        ks += kWarps;
        while (ks >= KS) {
          ks -= KS;
          ++cb;
        }
      }
    }
  };

  // The gates' items i = r H + j, i = tid, tid + 512, ...: (r, j) moves on
  // by (512 / H, 512 % H), so the time loop divides nothing.
  const int r_first = tid / H, j_first = tid - r_first * H;
  const int r_step = kThreads / H, j_step = kThreads - r_step * H;

  // The gates of (row r, unit j).
  auto gates = [&](int s) {
    const int t = reverse ? T - 1 - s : s;
    const float* st = staged(s);
    for (int i = tid, r = r_first, j = j_first; i < R * H; i += kThreads) {
      const int b = row0 + r;
      const Tm* x = reinterpret_cast<const Tm*>(st + r * L.XR);
      float hr = bh_s[j], hz = bh_s[H + j], hn = bh_s[2 * H + j];
      if (s > 0) {  // the slices in slice order, then b_h
        float ar = 0.0f, az = 0.0f, an = 0.0f;
#pragma unroll 4
        for (int ks = 0; ks < KS; ++ks) {
          const float* p = hwp_s + (ks * R + r) * L.X4;
          ar += p[j];
          az += p[H + j];
          an += p[2 * H + j];
        }
        hr = ar + hr;
        hz = az + hz;
        hn = an + hn;
      }
      const float rg = sigmoid(f32(x[j]) + hr);
      const float zg = sigmoid(f32(x[H + j]) + hz);
      const float ng = tanhf(f32(x[2 * H + j]) + rg * hn);
      const float hp = h_s[r * L.H4 + j];
      const float m = mask != nullptr ? st[R * L.XR + r] : (b < B ? 1.0f : 0.0f);
      const float h = m > 0.0f ? (1.0f - zg) * ng + zg * hp : hp;  // rows past B stay at 0
      h_s[r * L.H4 + j] = h;  // the fp32 carry; only y and h_fin are rounded
      if (b < B) {
        y[((size_t)b * T + t) * H + j] = to_mem<Tm>(h);
        if (s == T - 1) hfin[(size_t)b * H + j] = to_mem<Tm>(h);
      }
      r += r_step;
      j += j_step;
      if (j >= H) {
        j -= H;
        ++r;
      }
    }
  };

  for (int s = 0; s < T; ++s) {
    if (s + 1 < T) stage_step(s + 1);
    cp_async_commit();
    if (s > 0) product();
    // step s's rows have landed (at s = 0, W_h may still be in flight)
    if (s == 0) cp_async_wait<2>();
    else cp_async_wait<1>();
    __syncthreads();  // the slices, the staged step and h are visible
    gates(s);
    if (s == 0) cp_async_wait<1>();  // W_h has landed before step 1's product
    __syncthreads();  // h of this step is complete; the slices are free
  }
}

// ---- Launches ---------------------------------------------------------------

struct Plan {
  int rows, w_src, ks;
  size_t smem;
};

size_t smem_bytes(int H, int R, bool w_smem, int ks, int esz) {
  return sizeof(float) * (size_t)Layout(H, R, w_smem, ks, esz).total;
}

// R: 1, doubled while the grid has more than `sms` blocks, up to 4 (so a
// larger batch runs in several waves). KS: as many slices as there are
// warps for one piece each (up to H = 128; 4 k quads a slice in the
// register layout, whose lanes hold no more), or slices of 8 k quads
// (H > 128), fewer where shared memory runs out (the register layout needs
// under 24 KB, so its slices never shrink), then evened out so that no
// slice is empty. esz: the bytes of a value in memory.
Plan plan(int B, int H, int sms, int esz) {
  int R = 1;
  while (R < 4 && cdiv(B, R) > sms) R *= 2;
  const int src = H <= kRegH ? kReg : H <= kMaxSmemH ? kSmem : kL2;
  const int qk = round4(H) / 4, ncb = cdiv(round4(3 * H), 32 * col_width(src));
  int ks = src == kReg ? cdiv(qk, reg_quads(kReg, R))
           : src == kL2 ? cdiv(qk, kL2Quads) : max(1, kWarps / ncb);
  ks = min(ks, qk);
  while (smem_bytes(H, R, src == kSmem, ks, esz) > kMaxSmem) {
    if (ks > 1) --ks;
    else if (R > 1) R /= 2;
    else break;
  }
  ks = cdiv(qk, cdiv(qk, ks));
  return {R, src, ks, smem_bytes(H, R, src == kSmem, ks, esz)};
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The card's SM count, asked once per device.
cudaError_t sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static int count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && count[dev] > 0) {
    *sms = count[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) count[dev] = *sms;
  return err;
}

// Raises the dynamic shared-memory limit of gru_fwd_kernel<R, W_SRC, VEC, Tm>
// once per device (and not inside a CUDA graph capture, where the same
// launch recurs); each instantiation keeps its own record.
template <int R, int W_SRC, bool VEC, typename Tm>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  constexpr int kMaxDevices = 64;
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(gru_fwd_kernel<R, W_SRC, VEC, Tm>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

template <typename Tm>
struct Args {
  const Tm *xw, *wh, *bh;
  const float* mask;
  Tm *y, *hfin;
  int B, T, H, reverse;
};

template <int R, int W_SRC, bool VEC, typename Tm>
cudaError_t launch(const Args<Tm>& a, const Plan& pl, cudaStream_t stream) {
  const cudaError_t err = allow_smem<R, W_SRC, VEC, Tm>(pl.smem);
  if (err != cudaSuccess) return err;
  gru_fwd_kernel<R, W_SRC, VEC, Tm><<<cdiv(a.B, R), kThreads, pl.smem, stream>>>(
      a.xw, a.wh, a.bh, a.mask, a.y, a.hfin, a.B, a.T, a.H, a.reverse, pl.ks);
  return cudaGetLastError();
}

template <int W_SRC, bool VEC, typename Tm>
cudaError_t launch_rows(const Args<Tm>& a, const Plan& pl, cudaStream_t stream) {
  if (pl.rows == 1) return launch<1, W_SRC, VEC>(a, pl, stream);
  if (pl.rows == 2) return launch<2, W_SRC, VEC>(a, pl, stream);
  return launch<4, W_SRC, VEC>(a, pl, stream);
}

template <bool VEC, typename Tm>
cudaError_t launch_src(const Args<Tm>& a, const Plan& pl, cudaStream_t stream) {
  if (pl.w_src == kReg) return launch_rows<kReg, VEC>(a, pl, stream);
  if (pl.w_src == kSmem) return launch_rows<kSmem, VEC>(a, pl, stream);
  return launch_rows<kL2, VEC>(a, pl, stream);
}

// 16-byte copies where a row of 3H values and W_h's rows are 16-byte
// multiples and the bases aligned: H % 4 == 0 in fp32, H % 8 == 0 in bf16.
template <typename Tm>
int run(const Tm* xw, const Tm* wh, const Tm* bh, const float* mask, Tm* y, Tm* hfin, int B,
        int T, int H, int reverse, void* stream) {
  if (B < 1 || T < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Plan pl = plan(B, H, sms, sizeof(Tm));
  const Args<Tm> a{xw, wh, bh, mask, y, hfin, B, T, H, reverse};
  const bool vec = H % (16 / (int)sizeof(Tm)) == 0 && aligned16(xw) && aligned16(wh);
  return (int)(vec ? launch_src<true>(a, pl, st) : launch_src<false>(a, pl, st));
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() after the launch (0 on
// success). `mask` may be null (every step advances h). gru_fwd takes fp32
// tensors, gru_fwd_bf16 bf16 ones (the mask fp32 in both).
extern "C" int gru_fwd(const float* xw, const float* wh, const float* bh, const float* mask,
                       float* y, float* hfin, int B, int T, int H, int reverse, void* stream) {
  return run<float>(xw, wh, bh, mask, y, hfin, B, T, H, reverse, stream);
}

extern "C" int gru_fwd_bf16(const void* xw, const void* wh, const void* bh, const float* mask,
                            void* y, void* hfin, int B, int T, int H, int reverse,
                            void* stream) {
  return run<bf16>(static_cast<const bf16*>(xw), static_cast<const bf16*>(wh),
                   static_cast<const bf16*>(bh), mask, static_cast<bf16*>(y),
                   static_cast<bf16*>(hfin), B, T, H, reverse, stream);
}
