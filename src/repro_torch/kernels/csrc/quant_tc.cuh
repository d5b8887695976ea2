// The payload tile loader of the tensor-core quantized kernels (the bf16
// routes of dyad_mm_q.cu and of the quantized ff megakernel in
// dyad_ff_tc.cuh): int8 or fp8 e4m3 weights reach the 128-byte-swizzled
// bf16 tiles that wgmma reads from shared memory in two steps.
//
// 1. copy_raw: the payload bytes of a ROWS (mn) x 64 (k) tile, K-major as
//    the weights lie (mn rows of k), go to a raw tile in shared memory,
//    row r at r * 64 bytes, with 16-byte cp.async copies (16 weights a
//    copy, zero-filled past a ragged edge; half the bytes of a bf16
//    stage).  Payload rows off 16-byte alignment (d_in or d_ff off a
//    multiple of 16) are read byte by byte and stored at once.
// 2. convert: after a barrier, each thread reads 16 of those bytes and
//    writes the 16 bf16 values into the swizzled tile (dyad_gemm_tc.cuh's
//    tile_off<true>) with two 16-byte stores.  Both conversions are exact:
//    |int8| <= 128 and every e4m3 value are bf16 values.  int8 goes
//    through fp32 with the magic number 2^23 (one byte permute, one add);
//    e4m3 through cvt.rn.f16x2.e4m3x2, whose fp16 values widen exactly.
//    A bf16 value is the upper half of its fp32 bits, so two are packed
//    with one byte permute.
//
// The converted tile is written by generic-proxy stores and read by
// wgmma (the async proxy): the caller issues fence.proxy.async.shared::cta
// and a barrier between the two, as for any tile stored from registers.
// Without the fence wgmma can read stale shared memory with no error.
//
// Chosen over the weight as wgmma's register A operand (out^T = W x^T,
// converted in registers): the staged tile keeps the bf16 kernels'
// operand roles, accumulator layout and epilogues (per-column scales,
// strided stores, split partials) as they are, and each thread converts
// 16 contiguous bytes; register A would transpose all of that and gather
// each thread's fragment from scattered bytes.  Its gain is at the
// decode rows, where M 8 uses 8 of wgmma's 64 rows and the transposed
// product would put the rows in N (n 8 is a wgmma width): the candidate
// for a decode-row redesign (ROADMAP R.6).
#pragma once

#include <cuda_fp16.h>

#include "dyad_gemm_tc.cuh"
#include "quant.cuh"

namespace repro {
namespace qtc {

constexpr int kRawRow = tc::kBK;   // one stage's 64 k, one byte each
// per thread, for a raw tile of ROWS rows: its 16-byte chunks
template <int ROWS>
__host__ __device__ constexpr int chunks() {
  return ROWS * kRawRow / 16 / tc::kThreads;
}
template <int ROWS>
__host__ __device__ constexpr int raw_bytes() {
  return ROWS * kRawRow;
}

// a payload of one component and dyad block: element (mn, k) at
// p[mn * s_mn + k], mn < ext
struct Operand {
  const uint8_t* p;
  long long s_mn;
  int ext;
};

// 16-byte copies when the rows start on 16 bytes
inline bool vec_ok(const void* p, long long s_mn) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0 &&
         s_mn % 16 == 0;
}

// step 1: the raw bytes of rows mn0 .. mn0 + ROWS - 1, k0 .. k0 + 63 (k <
// k_end); chunk e of the tile: row e / 4, bytes 16 (e % 4) ..
template <int ROWS>
__device__ __forceinline__ void copy_raw(const Operand& o, bool vec, int mn0,
                                         int k0, int k_end, uint32_t raw) {
#pragma unroll
  for (int i = 0; i < chunks<ROWS>(); ++i) {
    const int e = threadIdx.x + i * tc::kThreads;
    const int r = e >> 2, c = (e & 3) * 16;
    const int gm = mn0 + r, gk = k0 + c;
    const int n = gm < o.ext ? min(max(k_end - gk, 0), 16) : 0;
    const uint8_t* src = o.p + (n ? gm * o.s_mn + gk : 0);
    const uint32_t dst = raw + r * kRawRow + c;
    if (vec) {
      tc::cp_async16(dst, src, n);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      for (int b = 0; b < n; ++b)
        w[b >> 2] |= (uint32_t)__ldg(src + b) << (8 * (b & 3));
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
    }
  }
}

// four payloads (a little-endian word) as two bf16x2 words, exactly
template <typename W>
__device__ __forceinline__ void to_bf16x4(uint32_t q, uint32_t& lo,
                                          uint32_t& hi);
template <>
__device__ __forceinline__ void to_bf16x4<int8_t>(uint32_t q, uint32_t& lo,
                                                  uint32_t& hi) {
  // byte b + 128 as the low byte of 2^23's mantissa, less 2^23 + 128
  const uint32_t u = q ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}
template <>
__device__ __forceinline__ void to_bf16x4<__nv_fp8_e4m3>(uint32_t q,
                                                         uint32_t& lo,
                                                         uint32_t& hi) {
  uint32_t h[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const unsigned short two = static_cast<unsigned short>(q >> (16 * p));
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h[p]) : "h"(two));
  }
  auto pack = [](uint32_t h2) {
    const float a = __half2float(__ushort_as_half((unsigned short)h2));
    const float b = __half2float(__ushort_as_half((unsigned short)(h2 >> 16)));
    return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
  };
  lo = pack(h[0]);
  hi = pack(h[1]);
}

// step 2: the raw tile into the swizzled K-major bf16 tile (after a
// barrier; the caller fences and waits before wgmma reads it)
template <typename W, int ROWS>
__device__ __forceinline__ void convert(uint32_t raw, uint32_t tile) {
#pragma unroll
  for (int i = 0; i < chunks<ROWS>(); ++i) {
    const int e = threadIdx.x + i * tc::kThreads;
    const int r = e >> 2, c = (e & 3) * 16;
    uint32_t q[4], v[8];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
                 : "r"(raw + r * kRawRow + c));
#pragma unroll
    for (int w = 0; w < 4; ++w) to_bf16x4<W>(q[w], v[2 * w], v[2 * w + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       tile + tc::tile_off<true>(r, c + 8 * h)),
                   "r"(v[4 * h]), "r"(v[4 * h + 1]), "r"(v[4 * h + 2]),
                   "r"(v[4 * h + 3]));
  }
}

}  // namespace qtc
}  // namespace repro
