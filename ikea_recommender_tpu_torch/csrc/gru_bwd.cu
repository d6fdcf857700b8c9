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
// What bounds it: the T steps are serial, as in the forward, and each step
// does two dependent products of the forward's size (recompute h_prev W_h,
// then dhw W_h^T) with a block barrier between them. At the train point
// (B=256, T=10, H=64) the call moves about 7 MB and does about 0.19 GFLOP, a
// few microseconds at the card's peak rates; the chain of 10 x 2 dependent
// products and 3 barriers per step is what sets its time.
//
// Design: batch rows are independent, so each block of the first kernel owns
// a tile of R rows and runs the whole time loop (the TPU kernel's sequential
// grid axis) by itself; no block waits on another. All tiles of a step
// (h_prev, the dh carry, hw, dhw) sit in shared memory, and the block's 256
// threads sweep each product's outputs. W_h is copied into shared memory
// where it fits (H <= 128; 48 KB at H = 64), its rows padded to 3H + 1 floats
// so that the dhw W_h^T sweep (one W_h row per thread) is free of bank
// conflicts, and is otherwise read through the read-only cache from L2.
// The TPU kernel sums dW_h and db_h inside the loop; here the first kernel
// writes dhw (B, T, 3H) instead, and a second kernel forms
// [dW_h; db_h] = sum over (b, t) of [h_prev; 1]^T dhw as a tiled product:
// each block owns a 64 x 64 tile of the (H + 1, 3H) result over one chunk of
// the B*T rows and writes it to parts (n, H + 1, 3H), n = gru_bwd_parts(B, T,
// H); the caller sums the parts, as the reference sums its per-tile partials
// after the call. No atomics, and the sum order is fixed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kTile = 64, kTileK = 16;  // the dW_h product's tiles
constexpr int kTargetBlocks = 264;      // two per SM

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <bool W_SMEM>
__device__ __forceinline__ float load_w(const float* w_s, const float* wh, int k, int c,
                                        int WP, int H3) {
  if constexpr (W_SMEM) {
    return w_s[k * WP + c];
  } else {
    return __ldg(wh + k * H3 + c);
  }
}

template <bool W_SMEM>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
               const float* __restrict__ bh, const float* __restrict__ mask,
               const float* __restrict__ y, const float* __restrict__ gy,
               const float* __restrict__ ghfin, float* __restrict__ dxw,
               float* __restrict__ dhw, int B, int T, int H, int reverse, int R) {
  extern __shared__ float smem[];
  const int H3 = 3 * H;
  const int WP = H3 + 1;  // padded W_h row in shared memory
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;

  float* p = smem;
  float* w_s = nullptr;
  if constexpr (W_SMEM) {
    w_s = p;
    p += H * WP;
  }
  float* hp_s = p;  // (R, H) h_prev
  p += R * H;
  float* dh_s = p;  // (R, H) the dh carry
  p += R * H;
  float* hw_s = p;  // (R, 3H) h_prev W_h + b_h
  p += R * H3;
  float* dhw_s = p;  // (R, 3H) [da_r, da_z, dhn]
  p += R * H3;
  float* m_s = p;  // (R)

  if constexpr (W_SMEM) {
    for (int i = tid; i < H * H3; i += kThreads) w_s[(i / H3) * WP + i % H3] = wh[i];
  }
  for (int i = tid; i < R * H; i += kThreads) {
    const int b = row0 + i / H;
    dh_s[i] = b < B ? ghfin[(size_t)b * H + i % H] : 0.0f;
  }

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const bool first = reverse ? (t == T - 1) : (t == 0);
    const int tp = reverse ? t + 1 : t - 1;

    // h_prev, the step's cotangent of y, and the mask. Each (row, unit) of
    // hp_s and dh_s belongs to one thread in every loop below.
    for (int i = tid; i < R * H; i += kThreads) {
      const int b = row0 + i / H, j = i % H;
      float hp = 0.0f, g = 0.0f;
      if (b < B) {
        if (!first) hp = y[((size_t)b * T + tp) * H + j];
        g = gy[((size_t)b * T + t) * H + j];
      }
      hp_s[i] = hp;
      dh_s[i] += g;
    }
    for (int r = tid; r < R; r += kThreads) {
      const int b = row0 + r;
      m_s[r] = b >= B ? 0.0f : (mask == nullptr ? 1.0f : mask[(size_t)b * T + t]);
    }
    __syncthreads();

    // hw = h_prev W_h + b_h, recomputed
    for (int i = tid; i < R * H3; i += kThreads) {
      const int r = i / H3, c = i % H3;
      const float* h = hp_s + r * H;
      float a = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) a = fmaf(h[k], load_w<W_SMEM>(w_s, wh, k, c, WP, H3), a);
      hw_s[i] = a + bh[c];
    }
    __syncthreads();

    // the gates and their adjoints, per (row, unit)
    for (int i = tid; i < R * H; i += kThreads) {
      const int r = i / H, j = i % H, b = row0 + r;
      float xr = 0.0f, xz = 0.0f, xn = 0.0f;
      if (b < B) {
        const float* x = xw + ((size_t)b * T + t) * H3;
        xr = x[j];
        xz = x[H + j];
        xn = x[2 * H + j];
      }
      const float* hw = hw_s + r * H3;
      const float hn = hw[2 * H + j];
      const float rg = sigmoid(xr + hw[j]);
      const float zg = sigmoid(xz + hw[H + j]);
      const float ng = tanhf(xn + rg * hn);
      const float m = m_s[r];
      const float dh = dh_s[i];
      const float dh_t = dh * m;
      const float dh_skip = dh * (1.0f - m);
      const float dn = dh_t * (1.0f - zg);
      const float dz = dh_t * (hp_s[i] - ng);
      const float da_n = dn * (1.0f - ng * ng);
      const float dr = da_n * hn;
      const float dhn = da_n * rg;
      const float da_z = dz * zg * (1.0f - zg);
      const float da_r = dr * rg * (1.0f - rg);
      if (b < B) {
        const size_t o = ((size_t)b * T + t) * H3;
        dxw[o + j] = da_r;
        dxw[o + H + j] = da_z;
        dxw[o + 2 * H + j] = da_n;
        dhw[o + j] = da_r;
        dhw[o + H + j] = da_z;
        dhw[o + 2 * H + j] = dhn;
      }
      float* d = dhw_s + r * H3;
      d[j] = da_r;
      d[H + j] = da_z;
      d[2 * H + j] = dhn;
      dh_s[i] = dh_t * zg + dh_skip;
    }
    __syncthreads();

    // dh += dhw W_h^T: one W_h row per thread. The next step's first loop
    // touches only this thread's own dh_s and hp_s entries, and writes
    // nothing this loop reads, so no barrier follows.
    for (int i = tid; i < R * H; i += kThreads) {
      const int r = i / H, j = i % H;
      const float* d = dhw_s + r * H3;
      float a = 0.0f;
#pragma unroll 4
      for (int c = 0; c < H3; ++c) a = fmaf(d[c], load_w<W_SMEM>(w_s, wh, j, c, WP, H3), a);
      dh_s[i] += a;
    }
  }
}

// parts[z] (H + 1, 3H) = sum over rows q of chunk z of [h_prev(q); 1]^T dhw(q),
// q = b * T + t, h_prev(q) = y[b, t_prev] (zero at the forward's first step).
// Block (x, y, z) owns rows 64x..64x+63 of the result (row H is db_h) and
// columns 64y..64y+63; each thread a 4 x 4 tile.
__global__ void __launch_bounds__(kThreads)
gru_dwh_kernel(const float* __restrict__ y, const float* __restrict__ dhw,
               float* __restrict__ parts, int B, int T, int H, int reverse, int chunk) {
  __shared__ float a_s[kTileK][kTile];  // h_prev rows
  __shared__ float b_s[kTileK][kTile];  // dhw rows
  const int H3 = 3 * H, Q = B * T;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const int q0 = blockIdx.z * chunk, q1 = min(q0 + chunk, Q);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int qs = q0; qs < q1; qs += kTileK) {
    for (int e = tid; e < kTileK * kTile; e += kThreads) {
      const int r = e / kTile, col = e % kTile;
      const int q = qs + r, k = k0 + col, c = c0 + col;
      float a = 0.0f, v = 0.0f;
      if (q < q1) {
        const int t = q % T;
        const bool first = reverse ? (t == T - 1) : (t == 0);
        if (k == H) {
          a = 1.0f;
        } else if (k < H && !first) {
          a = y[(size_t)(q + (reverse ? 1 : -1)) * H + k];
        }
        if (c < H3) v = dhw[(size_t)q * H3 + c];
      }
      a_s[r][col] = a;
      b_s[r][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kTileK; ++r) {
      float a[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = b_s[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = parts + (size_t)blockIdx.z * (H + 1) * H3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k > H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < H3) out[(size_t)k * H3 + c] = acc[i][j];
    }
  }
}

struct Plan {
  bool w_smem;
  int rows;
  size_t smem;
};

Plan plan(int H) {
  const int R = H >= kThreads ? 1 : kThreads / H;
  const size_t tiles = sizeof(float) * (size_t)R * (8 * H + 1);
  const size_t w = sizeof(float) * (size_t)H * (3 * H + 1);
  if (w + tiles <= kMaxSmem) return {true, R, w + tiles};
  return {false, R, tiles};
}

dim3 dwh_grid(int B, int T, int H, int* chunk) {
  const int Q = B * T;
  const int tiles = ((H + 1 + kTile - 1) / kTile) * ((3 * H + kTile - 1) / kTile);
  int n = (kTargetBlocks + tiles - 1) / tiles;
  const int most = (Q + kThreads - 1) / kThreads;  // at least 256 rows a chunk
  if (n > most) n = most;
  if (n < 1) n = 1;
  *chunk = (Q + n - 1) / n;
  n = (Q + *chunk - 1) / *chunk;
  return dim3((H + 1 + kTile - 1) / kTile, (3 * H + kTile - 1) / kTile, n);
}

template <bool W_SMEM>
cudaError_t launch(const float* xw, const float* wh, const float* bh, const float* mask,
                   const float* y, const float* gy, const float* ghfin, float* dxw, float* dhw,
                   int B, int T, int H, int reverse, const Plan& pl, cudaStream_t stream) {
  auto kernel = gru_bwd_kernel<W_SMEM>;
  if (pl.smem > 48 * 1024) {
    // Raise the dynamic shared-memory limit once per device (and not
    // inside a CUDA graph capture, where the same launch recurs).
    constexpr int kMaxDevices = 64;
    static size_t allowed[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || allowed[dev] < pl.smem) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)pl.smem);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) allowed[dev] = pl.smem;
    }
  }
  const dim3 grid((B + pl.rows - 1) / pl.rows);
  kernel<<<grid, kThreads, pl.smem, stream>>>(xw, wh, bh, mask, y, gy, ghfin, dxw, dhw, B, T,
                                              H, reverse, pl.rows);
  return cudaGetLastError();
}

}  // namespace

// The number of (H + 1, 3H) parts gru_bwd writes for (B, T, H).
extern "C" int gru_bwd_parts(int B, int T, int H) {
  if (B < 1 || T < 1 || H < 1) return 0;
  int chunk = 0;
  return (int)dwh_grid(B, T, H, &chunk).z;
}

// Launches on `stream` and returns cudaGetLastError() after the launches (0
// on success). `mask` may be null (every step advances h). `dhw` is scratch
// of (B, T, 3H); `parts` holds gru_bwd_parts(B, T, H) slices of (H + 1, 3H)
// whose sum is [dW_h; db_h].
extern "C" int gru_bwd(const float* xw, const float* wh, const float* bh, const float* mask,
                       const float* y, const float* gy, const float* ghfin, float* dxw,
                       float* dhw, float* parts, int B, int T, int H, int reverse,
                       void* stream) {
  if (B < 1 || T < 1 || H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl = plan(H);
  cudaError_t err =
      pl.w_smem
          ? launch<true>(xw, wh, bh, mask, y, gy, ghfin, dxw, dhw, B, T, H, reverse, pl, st)
          : launch<false>(xw, wh, bh, mask, y, gy, ghfin, dxw, dhw, B, T, H, reverse, pl, st);
  if (err != cudaSuccess) return (int)err;
  int chunk = 0;
  const dim3 grid = dwh_grid(B, T, H, &chunk);
  gru_dwh_kernel<<<grid, kThreads, 0, st>>>(y, dhw, parts, B, T, H, reverse, chunk);
  return (int)cudaGetLastError();
}
