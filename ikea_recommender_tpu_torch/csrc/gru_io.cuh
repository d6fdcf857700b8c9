// Memory's type for the GRU kernels B3 (gru_fwd.cu) and B4 (gru_bwd.cu):
// fp32, or bf16 widened to fp32 where it is read and rounded to nearest even
// where it is stored (compute_dtype: bfloat16); every sum and product stays
// fp32. The kernels template on the type (Tm) and use these overloads, so an
// fp32 instantiation reads and writes as before.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gru_io {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

template <typename Tm>
__device__ __forceinline__ Tm to_mem(float v) {
  if constexpr (std::is_same<Tm, float>::value) return v;
  else return __float2bfloat16_rn(v);
}

// bf16 bits -> fp32: the low and high halves of a 32-bit word.
__device__ __forceinline__ float lo16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// 4 (or 2) adjacent values, 16-byte (8-byte) aligned in fp32, 8-byte (4-byte)
// aligned in bf16: from read-only global memory (ldg4, ldg2), or from any
// address (ld4).
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(lo16(u.x), hi16(u.x), lo16(u.y), hi16(u.y));
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const bf16* p) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(lo16(u), hi16(u));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(lo16(u.x), hi16(u.x), lo16(u.y), hi16(u.y));
}

// Widens rows x n bf16 values, element e of row r read from src_of(r, e),
// into dst (fp32, row stride ld), or zero where that is null. VEC: 8 values
// (16 bytes) a load, n and the source rows multiples of 8 values, 16-byte
// aligned, ld a multiple of 4; else one value a load. A thread issues U
// loads before it stores any, so that their latencies overlap.
template <bool VEC, int U, typename Src>
__device__ __forceinline__ void widen_rows(float* dst, int ld, int rows, int n, Src src_of) {
  using Pack = typename std::conditional<VEC, uint4, unsigned short>::type;
  constexpr int kE = sizeof(Pack) / sizeof(bf16);
  const int per = n / kE, total = rows * per;
  for (int i0 = threadIdx.x; i0 < total; i0 += U * blockDim.x) {
    Pack v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x, r = i / per, e = (i - r * per) * kE;
      const bf16* p = i < total ? src_of(r, e) : nullptr;
      v[u] = p != nullptr ? *reinterpret_cast<const Pack*>(p) : Pack{};
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x, r = i / per, e = (i - r * per) * kE;
      if (i >= total) continue;
      float* d = dst + r * ld + e;
      if constexpr (VEC) {
        reinterpret_cast<float4*>(d)[0] =
            make_float4(lo16(v[u].x), hi16(v[u].x), lo16(v[u].y), hi16(v[u].y));
        reinterpret_cast<float4*>(d)[1] =
            make_float4(lo16(v[u].z), hi16(v[u].z), lo16(v[u].w), hi16(v[u].w));
      } else {
        *d = lo16(v[u]);
      }
    }
  }
}

}  // namespace gru_io
