// Quantized weight payloads for the DYAD kernels (dyad_mm_q.cu, and the
// quantized instantiation of dyad_ff.cu): int8 and fp8 e4m3, one byte per
// weight, read from device memory as bytes and converted to fp32 in
// registers.  Both conversions are exact (|int8| <= 127 and every e4m3
// value are fp32 and bf16 values), so a product with a payload equals the
// product with the integer or e4m3 value the reference casts to x's dtype;
// the fp32 scale per (block, out_row) multiplies the fp32 sums.
#pragma once

#include <cuda_fp8.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {

enum Payload : int { kInt8 = 0, kE4M3 = 1 };

template <typename W>
struct is_payload
    : std::integral_constant<bool, std::is_same<W, int8_t>::value ||
                                       std::is_same<W, __nv_fp8_e4m3>::value> {
};

__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

// byte i (0..3) of a little-endian word of four payloads, in fp32
template <typename W>
__device__ __forceinline__ float byte_f32(uint32_t word, int i);
template <>
__device__ __forceinline__ float byte_f32<int8_t>(uint32_t word, int i) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * i)) & 0xffu));
}
template <>
__device__ __forceinline__ float byte_f32<__nv_fp8_e4m3>(uint32_t word,
                                                         int i) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>((word >> (8 * i)) & 0xffu);
  return static_cast<float>(v);
}

}  // namespace repro
