// The pieces that the tensor-core flash kernels share: the forward
// (flash_fwd_tc.cuh) and the backward (flash_bwd_tc.cuh), both for bf16
// at any head dim h <= 128.
//
// Every tile is [64][HD] bf16 (HD 64 or 128, the lanes past h zero on load
// and never stored), kept as HD / 64 sub-tiles of [64][64] in the 128-byte
// swizzle of dyad_gemm_tc.cuh.  That one layout is K-major along h (the A
// or B of a product that sums over h) and MN-major along h (the B of one
// that sums over the tile's rows), so no tile is staged twice.  A tile is
// copied by one warpgroup with cp.async (16 bytes a copy), or element by
// element where its pointer or strides are off 16 bytes.  An m64
// accumulator's register layout is the A-fragment layout of the next
// product, so a probability tile goes from the accumulators to wgmma's A
// in registers, never through shared memory.
//
// Each helper takes the kernel's argument struct (BwdArgs, PrefillArgs):
// the folded rows r = s * G + g of a (B, S, K, G, h) tensor, the keys of
// a (B, T, K, h) one, and the causal/window mask read S, T, G, h, causal
// and window from it.
#pragma once

#include "dyad_gemm_tc.cuh"

namespace repro {
namespace ftc {

constexpr int kT = 64;          // rows or keys per tile
constexpr int kWG = 128;        // one warpgroup a block
constexpr float kLog2e = 1.4426950408889634f;

// bits of `flags`: the operands whose 16-byte chunks cp.async may copy;
// kFoldStep: G divides the rows a thread steps by in a tile (see load_fold)
enum : int { kVecQ = 1, kVecDo = 2, kVecK = 4, kVecV = 8, kFoldStep = 16 };

// a thread copies rows tid / (HD / 8) + i * kRpi<HD> of a tile
template <int HD>
constexpr int kRpi = kWG / (HD / 8);

// byte offset of element (row, col) of a [64][HD] tile
__device__ __forceinline__ uint32_t toff(int row, int col) {
  return (col >> 6) * 8192 + tc::tile_off<true>(row, col & 63);
}

// descriptors of k16 step s: K-major (the product sums over h: 16 columns
// of a sub-tile) and MN-major (it sums over the tile's rows: 16 rows, the
// HD / 64 sub-tiles 8192 bytes apart)
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int s) {
  return tc::desc(tile + (s >> 2) * 8192 + (s & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int s) {
  return tc::desc(tile + s * 2048, 8192, 1024);
}

// One [64][HD] tile: the thread copies chunk c = tid % (HD / 8) (elements
// 8c .. 8c + 7) of rows tid / (HD / 8) + i * kRpi, i < HD / 16.  `src(i)`
// is that row's first element, or null past the edge (zeros).  With `vec`
// the chunks go by cp.async (the lanes past h zero-filled), else element
// by element.  Only the cp.async route of cheap row addresses is unrolled
// (`Unrolled`, which needs `vec`): the others stay rolled, so that a
// kernel's loop body fits the instruction cache (the SASS of a fully
// unrolled loader made up most of both kernels' time on the card).
template <int HD, bool Unrolled, typename F>
__device__ __forceinline__ void load_tile(uint32_t tile, const void* any,
                                          int h, bool vec, F&& src) {
  constexpr int kCpr = HD / 8;
  const int c = threadIdx.x % kCpr, d0 = c * 8;
  const int n = max(0, min(8, h - d0));
  auto dst = [&](int i) {
    return tile + toff(threadIdx.x / kCpr + i * kRpi<HD>, d0);
  };
  auto copy = [&](int i, const unsigned short* p) {
    const int bytes = p ? 2 * n : 0;
    tc::cp_async16(dst(i), bytes ? p + d0 : any, bytes);
  };
  if constexpr (Unrolled) {
#pragma unroll
    for (int i = 0; i < HD / 16; ++i) copy(i, src(i));
    return;
  }
#pragma unroll 1
  for (int i = 0; i < HD / 16; ++i) {
    const unsigned short* p = src(i);
    if (vec) {
      copy(i, p);
      continue;
    }
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const uint32_t lo = p && e < n ? p[d0 + e] : 0u;
      const uint32_t hi = p && e + 1 < n ? p[d0 + e + 1] : 0u;
      w[e / 2] = lo | (hi << 16);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst(i)),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]));
  }
}

// an operand: its pointer, its (b, s or t, kv head, g) strides, and
// whether cp.async may copy it
struct Pair {
  const void* p;
  long long sb, ss, sk, sg;
  bool vec;
};

// The tile of folded rows r0 .. r0 + 63 (rg = s * G + g, zero past
// S * G) of a (B, S, K, G, h) tensor.  Where G divides kRpi (kFoldStep)
// every row of the thread is its first one's g, kRpi / G query positions
// on per pass: one division a tile, the rows by adds.
template <int HD, typename Args>
__device__ __forceinline__ void load_fold(uint32_t tile, const Pair& o,
                                          int flags, const Args& a, int b,
                                          int kh, int r0) {
  const int SG = a.S * a.G;
  const int rg0 = r0 + threadIdx.x / (HD / 8);
  const unsigned short* base =
      static_cast<const unsigned short*>(o.p) + b * o.sb + kh * o.sk;
  if ((flags & kFoldStep) && o.vec) {
    const int s0 = rg0 / a.G;
    const unsigned short* p0 = base + s0 * o.ss + (rg0 - s0 * a.G) * o.sg;
    const long long step = (long long)(kRpi<HD> / a.G) * o.ss;
    load_tile<HD, true>(tile, o.p, a.h, true, [&](int i) {
      return rg0 + i * kRpi<HD> < SG ? p0 + i * step : nullptr;
    });
  } else {
    load_tile<HD, false>(tile, o.p, a.h, o.vec, [&](int i) {
      const int rg = rg0 + i * kRpi<HD>;
      const int s = rg / a.G;
      return rg < SG ? base + s * o.ss + (rg - s * a.G) * o.sg : nullptr;
    });
  }
}

// the tile of keys t0 .. t0 + 63 (zero past T) of a (B, T, K, h) tensor
// (o.ss is its key stride)
template <int HD, typename Args>
__device__ __forceinline__ void load_keys(uint32_t tile, const Pair& o,
                                          const Args& a, int b, int kh,
                                          int t0) {
  const int tk0 = t0 + threadIdx.x / (HD / 8);
  const unsigned short* p0 = static_cast<const unsigned short*>(o.p) +
                             b * o.sb + tk0 * o.ss + kh * o.sk;
  const long long step = kRpi<HD> * o.ss;
  auto src = [&](int i) {
    return tk0 + i * kRpi<HD> < a.T ? p0 + i * step : nullptr;
  };
  if (o.vec)
    load_tile<HD, true>(tile, o.p, a.h, true, src);
  else
    load_tile<HD, false>(tile, o.p, a.h, false, src);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// every pair of the tile valid: no mask to apply
template <typename Args>
__device__ __forceinline__ bool tile_full(const Args& a, int r0, int t0,
                                          int qo, int ko) {
  if (r0 + kT > a.S * a.G || t0 + kT > a.T) return false;
  const int q_lo = qo + r0 / a.G, q_hi = qo + (r0 + kT - 1) / a.G;
  if (a.causal && ko + t0 + kT - 1 > q_lo) return false;
  if (a.window >= 0 && q_hi - (ko + t0) >= a.window) return false;
  return true;
}

template <typename Args>
__device__ __forceinline__ bool valid(const Args& a, bool row_ok,
                                      bool key_ok, int qpos, int kpos) {
  return row_ok && key_ok && !(a.causal && kpos > qpos) &&
         !(a.window >= 0 && qpos - kpos >= a.window);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the 16 bf16 pairs of a 64 x 64 accumulator as wgmma A fragments: pairs
// 4 s .. 4 s + 3 are the A of k16 step s
__device__ __forceinline__ void to_a(const float (&acc)[32],
                                     uint32_t (&frag)[16]) {
#pragma unroll
  for (int m = 0; m < 16; ++m) frag[m] = pack_bf16(acc[2 * m], acc[2 * m + 1]);
}

// S = A B^T over h, both [64][HD] tiles K-major
template <int HD>
__device__ __forceinline__ void mma_ss(float (&s)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int k = 0; k < HD / 16; ++k)
    tc::wgmma_m64n64k16<0, 0>(s, desc_k(a, k), desc_k(b, k), k > 0);
}

// D += A B over the tile's 64 rows: A bf16 fragments in registers, B the
// [64][HD] tile MN-major
template <int HD>
__device__ __forceinline__ void mma_rs(float (&d)[HD / 2],
                                       const uint32_t (&frag)[16],
                                       uint32_t tile) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t a4[4] = {frag[4 * s], frag[4 * s + 1], frag[4 * s + 2],
                            frag[4 * s + 3]};
    if constexpr (HD == 64)
      tc::wgmma_m64n64k16_rs<1>(d, a4, desc_mn(tile, s));
    else
      tc::wgmma_m64n128k16_rs<1>(d, a4, desc_mn(tile, s));
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  wg_commit();
  wg_wait();
}
// copies landed (this thread's, then everyone's) and visible to wgmma
__device__ __forceinline__ void landed() {
  tc::cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// an accumulator of HD / 2 fp32 per thread (64 rows x HD) into the
// (rows, h) output: register 4 j + 2 hh + e holds row 16 warp + lane / 4 +
// 8 hh, column 8 j + 2 (lane % 4) + e; `dst(hh)` the row's first element
// or null
template <int HD, typename F>
__device__ __forceinline__ void store_acc(const float (&acc)[HD / 2], int h,
                                          F&& dst) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    __nv_bfloat16* row = dst(hh);
    if (!row) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int d = 8 * j + 2 * (lane % 4);
      const float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
      if (d + 1 < h && (h & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(row + d) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < h) row[d] = __float2bfloat16(v0);
        if (d + 1 < h) row[d + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// a (B, S, K, G, h) or (B, T, K, h) operand cp.async can copy: 16-byte
// aligned, every stride a multiple of 8 elements
inline bool vec_ok(const void* p, long long s0, long long s1, long long s2,
                   long long s3) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0 &&
         s0 % 8 == 0 && s1 % 8 == 0 && s2 % 8 == 0 && s3 % 8 == 0;
}

}  // namespace ftc
}  // namespace repro
