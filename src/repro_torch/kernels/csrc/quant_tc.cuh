// The payload tile loader of the tensor-core quantized kernels (the bf16
// and fp32 routes of dyad_mm_q.cu and the bf16 route of the quantized ff
// megakernel in dyad_ff_tc.cuh): int8 or fp8 e4m3 weights reach the
// 128-byte-swizzled tiles that wgmma reads from shared memory, bf16 or
// fp32 (read as tf32), in two steps.
//
// 1. copy_raw: the payload bytes of a ROWS (mn) x RB (k) tile, K-major as
//    the weights lie (mn rows of k), go to a raw tile in shared memory,
//    row r at r * RB bytes, with 16-byte cp.async copies (16 weights a
//    copy, zero-filled past a ragged edge).  RB is one stage's k: 64 for a
//    bf16 stage (half its bytes), 32 for an fp32 one (an eighth).  Payload
//    rows off 16-byte alignment (d_in or d_ff off a multiple of 16) are
//    read byte by byte and stored at once.
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
// The fp32 route stages 32 payload bytes a row, not 64 converted into two
// fp32 tiles: a stage then is the 32-deep stage of its fp32 x tile (one
// 128-byte row), each thread copies one 16-byte chunk of the 128-row raw
// tile and converts that same chunk (convert32) once its own copy has
// landed, with no barrier between, into the fp32 tile that the next
// barrier hands to wgmma; a 64-deep raw stage would hold two x tiles a
// stage (32 KB more a stage of the ring) for no fewer barriers.  Both
// conversions are exact in tf32 too: an int8 value needs 8 bits of
// significand and an e4m3 value 4, and tf32 keeps 11, so wgmma reads
// them as they are and the weight side needs no low term.
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

constexpr int kRawRow = tc::kBK;   // a bf16 stage's 64 k, one byte each
constexpr int kRawRow32 = 32;      // an fp32 stage's 32 k
// per thread, for a raw tile of ROWS rows of RB bytes: its 16-byte chunks
template <int ROWS, int RB = kRawRow>
__host__ __device__ constexpr int chunks() {
  return ROWS * RB / 16 / tc::kThreads;
}
template <int ROWS, int RB = kRawRow>
__host__ __device__ constexpr int raw_bytes() {
  return ROWS * RB;
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

// step 1: the raw bytes of rows mn0 .. mn0 + ROWS - 1, k0 .. k0 + RB - 1
// (k < k_end); chunk e of the tile: row e / (RB / 16), bytes 16 (e % (RB /
// 16)) ..
template <int ROWS, int RB = kRawRow>
__device__ __forceinline__ void copy_raw(const Operand& o, bool vec, int mn0,
                                         int k0, int k_end, uint32_t raw) {
  constexpr int kPer = RB / 16;   // chunks a row
#pragma unroll
  for (int i = 0; i < chunks<ROWS, RB>(); ++i) {
    const int e = threadIdx.x + i * tc::kThreads;
    const int r = e / kPer, c = (e % kPer) * 16;
    const int gm = mn0 + r, gk = k0 + c;
    const int n = gm < o.ext ? min(max(k_end - gk, 0), 16) : 0;
    const uint8_t* src = o.p + (n ? gm * o.s_mn + gk : 0);
    const uint32_t dst = raw + r * RB + c;
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

// four payloads (a little-endian word) in fp32, exactly
template <typename W>
__device__ __forceinline__ void to_f32x4(uint32_t q, float (&f)[4]);
template <>
__device__ __forceinline__ void to_f32x4<int8_t>(uint32_t q, float (&f)[4]) {
  // byte b + 128 as the low byte of 2^23's mantissa, less 2^23 + 128
  const uint32_t u = q ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) -
           8388736.f;
}
template <>
__device__ __forceinline__ void to_f32x4<__nv_fp8_e4m3>(uint32_t q,
                                                        float (&f)[4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const unsigned short two = static_cast<unsigned short>(q >> (16 * p));
    uint32_t h;
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h) : "h"(two));
    f[2 * p] = __half2float(__ushort_as_half((unsigned short)h));
    f[2 * p + 1] = __half2float(__ushort_as_half((unsigned short)(h >> 16)));
  }
}

// four payloads as two bf16x2 words, exactly: a bf16 value is the upper
// half of its fp32 bits
template <typename W>
__device__ __forceinline__ void to_bf16x4(uint32_t q, uint32_t& lo,
                                          uint32_t& hi) {
  float f[4];
  to_f32x4<W>(q, f);
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
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

// step 2 of the fp32 route: the chunks that copy_raw<ROWS, kRawRow32> gave
// this thread, once its own copies have landed (no barrier: a thread's
// cp.async writes are visible to it after its wait), into the swizzled
// K-major fp32 tile (element (r, k) where bf16 element (r, 2k) would be):
// 16 payloads, four 16-byte stores.  The caller fences and waits before
// wgmma reads the tile.
template <typename W, int ROWS>
__device__ __forceinline__ void convert32(uint32_t raw, uint32_t tile) {
  constexpr int kPer = kRawRow32 / 16;
#pragma unroll
  for (int i = 0; i < chunks<ROWS, kRawRow32>(); ++i) {
    const int e = threadIdx.x + i * tc::kThreads;
    const int r = e / kPer, c = (e % kPer) * 16;
    uint32_t q[4];
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
                 : "r"(raw + r * kRawRow32 + c));
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float f[4];
      to_f32x4<W>(q[w], f);
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       tile + tc::tile_off<true>(r, 2 * (c + 4 * w))),
                   "f"(f[0]), "f"(f[1]), "f"(f[2]), "f"(f[3]));
    }
  }
}

}  // namespace qtc
}  // namespace repro
