// The pieces that the tensor-core flash kernels share: the forward
// (flash_fwd_tc.cuh; bf16, and fp32 on split TF32) and the backward
// (flash_bwd_tc.cuh; bf16, and fp32 on split TF32), at any head dim
// h <= 128.
//
// Every tile is [ROWS][HD] (ROWS 64, or 32 for the fp32 backward's walked
// tiles; HD 64 or 128, the lanes past h zero on load and never stored),
// kept as sub-tiles of ROWS rows of 128 bytes (64 bf16 or 32 fp32) in the
// 128-byte swizzle of dyad_gemm_tc.cuh.  In bf16 that one
// layout is K-major along h (the A or B of a product that sums over h) and
// MN-major along h (the B of one that sums over the tile's rows), so no
// tile is staged twice.  tf32 wgmma reads K-major only, so the fp32
// forward stages V transposed (kept here too).  A tile is copied by one
// warpgroup with cp.async (16 bytes a copy), or element by element where
// its pointer or strides are off 16 bytes.  An m64 accumulator's register
// layout is the A-fragment layout of the next product (in tf32 up to the
// order of each 8 keys, which the fp32 forward's V staging undoes), so a
// probability tile goes from the accumulators to wgmma's A in registers,
// never through shared memory.
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

// a thread copies rows tid / kCpr + i * kRpi<HD, T> of a tile of T (bf16
// or fp32 bits), kCpr its 16-byte chunks a row
template <int HD, typename T = unsigned short>
constexpr int kCpr = HD * (int)sizeof(T) / 16;
template <int HD, typename T = unsigned short>
constexpr int kRpi = kWG / kCpr<HD, T>;

// byte offset of element (row, col) of a [ROWS][HD] tile of T
template <typename T = unsigned short, int ROWS = kT>
__device__ __forceinline__ uint32_t toff(int row, int col) {
  if constexpr (sizeof(T) == 2)
    return (col >> 6) * (ROWS * 128) + tc::tile_off<true>(row, col & 63);
  else
    return (col >> 5) * (ROWS * 128) +
           tc::tile_off<true>(row, 2 * (col & 31));
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

// One [ROWS][HD] tile of T: the thread copies chunk c = tid % kCpr (its
// 16 bytes: elements 8c .. 8c + 7 of bf16, 4c .. 4c + 3 of fp32) of rows
// tid / kCpr + i * kRpi, i < kPasses.  `src(i)` is that row's first
// element, or null past the edge (zeros).  With `vec` the chunks go by
// cp.async (the lanes past h zero-filled), else element by element.  Only
// the cp.async route of cheap row addresses is unrolled (`Unrolled`, which
// needs `vec`): the others stay rolled, so that a kernel's loop body fits
// the instruction cache (the SASS of a fully unrolled loader made up most
// of both kernels' time on the card).
template <int HD, typename T = unsigned short, int ROWS = kT>
constexpr int kPasses = ROWS / kRpi<HD, T>;

template <int HD, bool Unrolled, typename T = unsigned short, int ROWS = kT,
          typename F>
__device__ __forceinline__ void load_tile(uint32_t tile, const void* any,
                                          int h, bool vec, F&& src) {
  constexpr int kCr = kCpr<HD, T>, kEpc = 16 / (int)sizeof(T);
  const int c = threadIdx.x % kCr, d0 = c * kEpc;
  const int n = max(0, min(kEpc, h - d0));
  auto dst = [&](int i) {
    return tile + toff<T, ROWS>(threadIdx.x / kCr + i * kRpi<HD, T>, d0);
  };
  auto copy = [&](int i, const T* p) {
    const int bytes = p ? (int)sizeof(T) * n : 0;
    tc::cp_async16(dst(i), bytes ? p + d0 : any, bytes);
  };
  if constexpr (Unrolled) {
#pragma unroll
    for (int i = 0; i < kPasses<HD, T, ROWS>; ++i) copy(i, src(i));
    return;
  }
#pragma unroll 1
  for (int i = 0; i < kPasses<HD, T, ROWS>; ++i) {
    const T* p = src(i);
    if (vec) {
      copy(i, p);
      continue;
    }
    uint32_t w[4];
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const uint32_t lo = p && e < n ? p[d0 + e] : 0u;
        const uint32_t hi = p && e + 1 < n ? p[d0 + e + 1] : 0u;
        w[e / 2] = lo | (hi << 16);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = p && e < n ? p[d0 + e] : 0u;
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

// The tile of folded rows r0 .. r0 + ROWS - 1 (rg = s * G + g, zero past
// S * G) of a (B, S, K, G, h) tensor of T.  Where G divides kRpi
// (kFoldStep) every row of the thread is its first one's g, kRpi / G query
// positions on per pass: one division a tile, the rows by adds.
template <int HD, typename T = unsigned short, int ROWS = kT,
          typename Args>
__device__ __forceinline__ void load_fold(uint32_t tile, const Pair& o,
                                          int flags, const Args& a, int b,
                                          int kh, int r0) {
  constexpr int kR = kRpi<HD, T>;
  const int SG = a.S * a.G;
  const int rg0 = r0 + threadIdx.x / kCpr<HD, T>;
  const T* base = static_cast<const T*>(o.p) + b * o.sb + kh * o.sk;
  if ((flags & kFoldStep) && o.vec) {
    const int s0 = rg0 / a.G;
    const T* p0 = base + s0 * o.ss + (rg0 - s0 * a.G) * o.sg;
    const long long step = (long long)(kR / a.G) * o.ss;
    load_tile<HD, true, T, ROWS>(tile, o.p, a.h, true, [&](int i) {
      return rg0 + i * kR < SG ? p0 + i * step : nullptr;
    });
  } else {
    load_tile<HD, false, T, ROWS>(tile, o.p, a.h, o.vec, [&](int i) {
      const int rg = rg0 + i * kR;
      const int s = rg / a.G;
      return rg < SG ? base + s * o.ss + (rg - s * a.G) * o.sg : nullptr;
    });
  }
}

// the tile of keys t0 .. t0 + ROWS - 1 (zero past T) of a (B, T, K, h)
// tensor of T (o.ss is its key stride)
template <int HD, typename T = unsigned short, int ROWS = kT,
          typename Args>
__device__ __forceinline__ void load_keys(uint32_t tile, const Pair& o,
                                          const Args& a, int b, int kh,
                                          int t0) {
  constexpr int kR = kRpi<HD, T>;
  const int tk0 = t0 + threadIdx.x / kCpr<HD, T>;
  const T* p0 =
      static_cast<const T*>(o.p) + b * o.sb + tk0 * o.ss + kh * o.sk;
  const long long step = kR * o.ss;
  auto src = [&](int i) {
    return tk0 + i * kR < a.T ? p0 + i * step : nullptr;
  };
  if (o.vec)
    load_tile<HD, true, T, ROWS>(tile, o.p, a.h, true, src);
  else
    load_tile<HD, false, T, ROWS>(tile, o.p, a.h, false, src);
}

// The chunks load_tile gave this thread in a [ROWS][HD] fp32 tile, once
// landed (its own copies or stores: no barrier), split into TF32: hi over
// the raw values, lo into the tile at lo
template <int HD, int ROWS = kT>
__device__ __forceinline__ void split_tile(uint32_t tile, uint32_t lo) {
  constexpr int kCr = kCpr<HD, uint32_t>;
#pragma unroll 4
  for (int i = 0; i < kPasses<HD, uint32_t, ROWS>; ++i) {
    const uint32_t off = toff<uint32_t, ROWS>(
        threadIdx.x / kCr + i * kRpi<HD, uint32_t>, 4 * (threadIdx.x % kCr));
    tc::split_chunk(tile + off, lo + off);
  }
}

// A [64 keys][HD] fp32 tile (as load_keys stages it) into V^T, [HD][64
// keys] K-major for the P V product (HD rows of 128-byte sub-tiles of 32
// keys, the second sub-tile HD * 128 bytes on), split into TF32 hi and
// lo.  Each 8 keys are reordered so that key 2c sits at k c and key
// 2c + 1 at k c + 4: the order of a tf32 A fragment built from an m64
// accumulator (see to_a32).  A warp moves 32 keys of one 4-column chunk a
// pass: its loads hit 8 rows' distinct chunks, its stores one 128-byte row.
template <int HD>
__device__ __forceinline__ void transpose_v(uint32_t raw, uint32_t hi,
                                            uint32_t lo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kPer = HD / 8, kBatch = 4;
#pragma unroll 1
  for (int j0 = 0; j0 < kPer; j0 += kBatch) {
    float v[kBatch][4];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int key = lane + 32 * ((j0 + j) & 1), c = warp + 4 * ((j0 + j) >> 1);
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[j][0]), "=f"(v[j][1]), "=f"(v[j][2]),
                     "=f"(v[j][3])
                   : "r"(raw + toff<uint32_t>(key, 4 * c)));
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int key = lane + 32 * ((j0 + j) & 1), c = warp + 4 * ((j0 + j) >> 1);
      const int kp = (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off = (kp >> 5) * (HD * 128) +
                             tc::tile_off<true>(4 * c + e, 2 * (kp & 31));
        uint32_t h, l;
        tc::split_tf32(v[j][e], h, l);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(hi + off), "r"(h));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(lo + off), "r"(l));
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// every pair of the tile of nr rows at r0 and nk keys at t0 valid: no
// mask to apply
template <typename Args>
__device__ __forceinline__ bool tile_full(const Args& a, int r0, int t0,
                                          int qo, int ko, int nr = kT,
                                          int nk = kT) {
  if (r0 + nr > a.S * a.G || t0 + nk > a.T) return false;
  const int q_lo = qo + r0 / a.G, q_hi = qo + (r0 + nr - 1) / a.G;
  if (a.causal && ko + t0 + nk - 1 > q_lo) return false;
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

// the same over fp32 tiles in split TF32, hi and lo of each, per k8 step
// (32 bytes, as bf16's k16), A [64][HD] and B [N][HD] (N 64 or 32 rows):
// the small terms a_lo b_hi and a_hi b_lo into `small`, then a_hi b_hi
// into s; the caller adds the two.  (Their sum, some 2^-11 of s, takes the
// rounding of its own adds at its own scale; s takes a third of the
// additions it would take with all three, which kept the error against
// float64 within the plain fp32 version's on the card.)
template <int HD, int N = kT>
__device__ __forceinline__ void mma_ss32(float (&s)[N / 2],
                                         float (&small)[N / 2],
                                         uint32_t a_hi, uint32_t a_lo,
                                         uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int k = 0; k < HD / 8; ++k) {
    const uint32_t bo = (k >> 2) * (N * 128) + (k & 3) * 32;
    const uint64_t bh = tc::desc(b_hi + bo, 16, 1024),
                   bl = tc::desc(b_lo + bo, 16, 1024);
    if constexpr (N == 64) {
      tc::wgmma_m64n64k8_tf32(small, desc_k(a_lo, k), bh, k > 0);
      tc::wgmma_m64n64k8_tf32(small, desc_k(a_hi, k), bl);
      tc::wgmma_m64n64k8_tf32(s, desc_k(a_hi, k), bh, k > 0);
    } else {
      tc::wgmma_m64n32k8_tf32(small, desc_k(a_lo, k), bh, k > 0);
      tc::wgmma_m64n32k8_tf32(small, desc_k(a_hi, k), bl);
      tc::wgmma_m64n32k8_tf32(s, desc_k(a_hi, k), bh, k > 0);
    }
  }
}

// A 64 x 64 accumulator as the tf32 A fragments of 8 k8 steps, split:
// step s takes {row r, key 8s + 2t}, {r + 8, 8s + 2t}, {r, 8s + 2t + 1},
// {r + 8, 8s + 2t + 1} (r = lane / 4, t = lane % 4) as its fragment's
// columns t, t, t + 4, t + 4: keys 2t and 2t + 1 sit at k t and t + 4,
// where transpose_v put V's rows
__device__ __forceinline__ void to_a32(const float (&acc)[32],
                                       uint32_t (&hi)[32],
                                       uint32_t (&lo)[32]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int src[4] = {4 * s, 4 * s + 2, 4 * s + 1, 4 * s + 3};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tc::split_tf32(acc[src[e]], hi[4 * s + e], lo[4 * s + e]);
  }
}

// D = P V over the tile's 64 keys for 64 columns of h, in split TF32:
// P's hi and lo fragments in registers (to_a32), V^T's hi and lo tiles
// (transpose_v; v_hi, v_lo at the columns' first row) K-major; per k8
// step p_lo v_hi, p_hi v_lo, then p_hi v_hi into a fresh D, which the
// caller adds into O
template <int HD>
__device__ __forceinline__ void mma_rs32(float (&d)[32],
                                         const uint32_t (&ph)[32],
                                         const uint32_t (&pl)[32],
                                         uint32_t v_hi, uint32_t v_lo) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint32_t off = (s >> 2) * (HD * 128) + (s & 3) * 32;
    const uint64_t vh = tc::desc(v_hi + off, 16, 1024),
                   vl = tc::desc(v_lo + off, 16, 1024);
    const uint32_t ah[4] = {ph[4 * s], ph[4 * s + 1], ph[4 * s + 2],
                            ph[4 * s + 3]};
    const uint32_t al[4] = {pl[4 * s], pl[4 * s + 1], pl[4 * s + 2],
                            pl[4 * s + 3]};
    tc::wgmma_m64n64k8_tf32_rs(d, al, vh, s > 0);
    tc::wgmma_m64n64k8_tf32_rs(d, ah, vl);
    tc::wgmma_m64n64k8_tf32_rs(d, ah, vh);
  }
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
// (rows, h) output of O (bf16 or fp32): register 4 j + 2 hh + e holds row
// 16 warp + lane / 4 + 8 hh, column 8 j + 2 (lane % 4) + e; `dst(hh)` the
// row's first element or null
template <int HD, typename O = __nv_bfloat16, typename F>
__device__ __forceinline__ void store_acc(const float (&acc)[HD / 2], int h,
                                          F&& dst) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    O* row = dst(hh);
    if (!row) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int d = 8 * j + 2 * (lane % 4);
      const float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
      if (d + 1 < h && (h & 1) == 0) {
        tc::store2(row + d, true, v0, v1);
      } else {
        if (d < h) row[d] = from_f32<O>(v0);
        if (d + 1 < h) row[d + 1] = from_f32<O>(v1);
      }
    }
  }
}

// a (B, S, K, G, h) or (B, T, K, h) operand cp.async can copy: 16-byte
// aligned, every stride a multiple of the epc elements of 16 bytes
inline bool vec_ok(const void* p, long long s0, long long s1, long long s2,
                   long long s3, int epc = 8) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0 &&
         s0 % epc == 0 && s1 % epc == 0 && s2 % epc == 0 && s3 % epc == 0;
}

}  // namespace ftc
}  // namespace repro
