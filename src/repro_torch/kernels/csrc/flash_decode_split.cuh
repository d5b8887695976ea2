// The split-key (flash-decoding) one-token decode shared by the ring-cache
// decode (flash_decode.cu) and the paged decode (flash_decode_paged.cu).
//
// One block a (split, KV head, slot); a split is a fixed span of keys, a
// whole number (1-8) of 32-key tiles, one tile a warp.  The two callers
// differ only in where a key's row lives and which keys are live:
//
//   paged (RING false): slot b's key j at pool row bt[b, j / P] * P + j % P;
//     live when j <= idx[b], j < l_real and, with a window,
//     idx[b] - j < window: one run of keys, so one run of splits.
//   ring (RING true): ring slot j of the (B, L, K, h) cache, through its
//     strides, holds position idx - ((idx - j) mod L); live when that is
//     >= 0 and, with a window, within it: the n = min(idx + 1, L, window)
//     newest positions, a circular run of ring slots ending at idx mod L.
//     Past the wrap point it covers the ring's last slots and its first
//     ones, so the live splits are at most two runs, the low one first.
//
// A block loads its threads' block-table entries (paged) beside idx, then
// q into shared memory while those land.  Each warp then copies its tile's
// live rows as raw bytes (fp32, bf16 or int8) into padded shared rows with
// the copy engine, one bulk copy a row issued by the row's lane and
// completing on the tile's mbarrier, K then V, so every block has its bytes
// in flight before it waits on any.  Over fp32 rows a warp holds one buffer
// and copies V into it once K is scored, so that a 128-key block takes 67
// KB and three fit an SM; bf16 and int8 rows keep K and V apart.  Lane c
// scores key c for the G query heads (16-byte vectors along its row,
// converted at use; the 16-byte pad puts neighbouring rows 4 banks apart, so
// the vectors do not conflict), then P.V over the live rows with p broadcast
// by shuffles, each lane holding h / 32 contiguous dims.  The warps' states
// merge in shared memory.  A slot whose live keys lie in one split writes o
// from that block; else each block writes its partial (m, l, acc[G][h]) to a
// workspace, fences, and counts itself on the (slot, KV head) counter; the
// last to arrive merges every partial of the slot in split order, writes o
// and resets the counter to 0.  Rows that are not live are never read (a
// poisoned row cannot reach the output; a ring tile whose live rows have a
// gap skips the gap in P.V), and a block whose span holds no live key exits
// before it reads a row.
//
// A slot's splits are functions of its own idx, the window and the key
// count only, and every merge runs in a fixed order, so a row's bits do not
// depend on the other slots, on the batch size or on which block finishes
// last.  The counters make concurrent launches on one device unsafe; the
// port launches on one stream.
//
// Any head dim h <= 128 runs: the kernel is instantiated at HD 32, 64 and
// 128 and takes the smallest HD >= h; q, K and V hold zeros in the lanes
// past h (so they add nothing to a score or to P.V) and only the h real
// lanes are stored.  h = 64 and 128 over 16-byte aligned rows take the
// unpadded instantiations, whose rows are bulk copies; the padded ones
// (PAD) copy a tile element by element through registers, zeros past h.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace split_decode {

constexpr int kKeys = 32;       // keys of a tile, one tile a warp
constexpr int kMaxWarps = 8;    // a split: 1 to 8 tiles
constexpr int kI8 = 2;          // cache dtype code of an int8 pool

template <int BYTES>
struct Vec;
template <>
struct Vec<16> {
  using type = uint4;
};
template <>
struct Vec<8> {
  using type = uint2;
};
template <>
struct Vec<4> {
  using type = unsigned int;
};
template <>
struct Vec<2> {
  using type = unsigned short;
};
template <>
struct Vec<1> {
  using type = unsigned char;
};

// N consecutive elements of type T as one raw vector, converted to fp32
// at use.  int8 payloads convert without the int-to-float unit (a quarter
// of the FMA rate): each byte, biased to x + 128, becomes the low byte of
// the float 2^23 + x + 128, from which one subtraction leaves x exactly.
template <typename T, int N>
using RawVec = typename Vec<N * sizeof(T)>::type;

template <typename T, int N>
__device__ __forceinline__ void convert(const RawVec<T, N>& raw,
                                        float (&out)[N]) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const unsigned int u = static_cast<unsigned int>(raw) ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
               8388736.f;
  } else {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  }
}

// the 16 bytes of a row as 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void convert16(const uint4& raw,
                                          float (&out)[16 / sizeof(T)]) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float f[4];
      convert<int8_t, 4>(w[k], f);
#pragma unroll
      for (int i = 0; i < 4; ++i) out[4 * k + i] = f[i];
    }
  } else {
    convert<T, 16 / sizeof(T)>(raw, out);
  }
}

__device__ __forceinline__ unsigned int smem_u32(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// the mbarrier of a tile: one arrival (the warp's lane 0, with the bytes
// the tile's copies bring), then each bulk copy completes its bytes
__device__ __forceinline__ void bar_init(unsigned int bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(1));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_expect(unsigned int bar,
                                           unsigned int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned int bar) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n}\n" ::"r"(bar),
      "r"(0)
      : "memory");
}
// one contiguous run of bytes (a multiple of 16, both ends 16-byte
// aligned) from device memory to shared memory by the copy engine
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned int bytes,
                                          unsigned int bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a warp's K or V tile in shared memory: 32 rows of HD raw elements, each
// row padded by 16 bytes
template <typename T, int HD>
struct Tile {
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(T));
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kBytes = kKeys * kStride;
  // buffers a warp holds: K and V apart, or over fp32 rows one, V loaded
  // into it once K is scored, so that 128-key blocks fit 3 an SM
  static constexpr int kBufs = sizeof(T) == 4 ? 1 : 2;
};

// stage one tile: tile row r holds the h elements at base + row * stride
// of lane r's `row` (-1: nothing read; such a row is masked, and P.V skips
// it).  Unpadded: lane r's row as one bulk copy on the tile's mbarrier
// `bar`.  PAD: element by element through registers, zeros past h and in
// the rows not read.
template <typename T, int HD, bool PAD>
__device__ __forceinline__ void stage(const T* base, long long stride,
                                      int row, unsigned char* tile,
                                      unsigned int bar, int lane, int h,
                                      unsigned int live_rows) {
  using L = Tile<T, HD>;
  if constexpr (PAD) {
    using U = RawVec<T, 1>;
    const U* src = reinterpret_cast<const U*>(base);
    // element e of the tile: row e / HD, the same for the whole warp
    for (int e = lane; e < kKeys * HD; e += 32) {
      const int r = e / HD, d = e % HD;
      const int rr = __shfl_sync(0xffffffffu, row, r);
      U v = 0;
      if (rr >= 0 && d < h) v = src[rr * stride + d];
      reinterpret_cast<U*>(tile + r * L::kStride)[d] = v;
    }
  } else {
    if (lane == 0) bar_expect(bar, live_rows * L::kRowBytes);
    if (row >= 0)
      bulk_copy(tile + lane * L::kStride, base + row * stride, L::kRowBytes,
                bar);
  }
}

// fold a partial softmax state (ms, ls, os) into the running (m, l, o);
// an empty partial (ms = kNegInf, ls = 0, os = 0) adds nothing, and one
// partial into the empty state leaves its l and o bits
__device__ __forceinline__ void fold(float& m, float& l, float& o, float ms,
                                     float ls, float os) {
  const float mn = fmaxf(m, ms);
  const float a = expf(m - mn), c = expf(ms - mn);
  l = l * a + ls * c;
  o = o * a + os * c;
  m = mn;
}

struct Args {
  const void* q;
  const void* k;     // paged: the (NP, P, K, h) pool; ring: the cache
  const void* v;
  const float* sk;   // int8 pools: (NP, P, K) scales
  const float* sv;
  const int* bt;     // paged: (B, NB) block table
  const int* idx;    // (B,) write indices (ring: null takes idx_s)
  void* o;
  float* ws;       // partials [B][K][splits][G][h + 2]: acc, then m, l
  int* counters;   // [B * K], zero between launches
  int B, K, G, h;
  int P, NB, l_real;   // ring: P = l_real = L, NB = 1
  int span;
  long long q_sb, q_sk, q_sg;
  long long k_sb, k_st, k_sk;   // ring: the caches' strides, in elements
  long long v_sb, v_st, v_sk;
  int idx_s;
  int window;
  float scale;
  int rows16;   // every row 16-byte aligned: bulk copies at h 64 and 128
};

// splits of the grid: the span's tiles over min(NB * P, l_real) keys
__host__ __device__ __forceinline__ int n_splits(const Args& a) {
  const int cap = a.NB * a.P < a.l_real ? a.NB * a.P : a.l_real;
  const int n = (cap + a.span - 1) / a.span;
  return n > 1 ? n : 1;
}

template <bool RING, typename TQ, typename TKV, bool QUANT, int HD, int GM,
          bool PAD>
__device__ __forceinline__ void decode(const Args& a) {
  using L = Tile<TKV, HD>;
  constexpr int DPL = HD / 32;   // head-dim elements per lane in P.V
  constexpr int E = 16 / static_cast<int>(sizeof(TKV));   // per 16 bytes
  constexpr int kBufs = L::kBufs;
  static_assert(kBufs * L::kBytes >= sizeof(float) * GM * (HD + 2),
                "a warp's merge state fits its tiles");
  static_assert(!(RING && QUANT), "the ring holds fp32 or bf16 rows");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  __shared__ __align__(8) unsigned long long bars[2 * kMaxWarps];  // K, V
  float* qs = reinterpret_cast<float*>(smem);          // [GM][HD]
  unsigned char* tiles = smem + sizeof(float) * GM * HD;   // per warp: K, V

  const TQ* q = static_cast<const TQ*>(a.q);
  TQ* o = static_cast<TQ*>(a.o);
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nw = blockDim.x / 32;
  const int j = s * a.span + tid;   // this thread's key
  const int cap = min(a.NB * a.P, a.l_real);
  // the warp's K and V tile mbarriers, ready before its copies are issued
  if (!PAD && lane == 0) {
    bar_init(smem_u32(bars + 2 * warp));
    bar_init(smem_u32(bars + 2 * warp + 1));
  }
  __syncwarp();
  // the block-table entry of this thread's key and idx, then q into shared
  // memory, four loads a thread in flight, while those land
  int page = 0;
  if constexpr (!RING)
    page = j < cap ? __ldg(a.bt + (long long)b * a.NB + j / a.P) : 0;
  const int idx = RING && a.idx == nullptr ? a.idx_s : __ldg(a.idx + b);
  for (int e0 = tid; e0 < GM * HD; e0 += 4 * blockDim.x) {
    float qv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * blockDim.x, g = e / HD, d = e % HD;
      qv[k] = e < GM * HD && g < a.G && d < a.h
                  ? to_f32(q[b * a.q_sb + kh * a.q_sk + g * a.q_sg + d])
                  : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e0 + k * blockDim.x < GM * HD) qs[e0 + k * blockDim.x] = qv[k];
  }
  // the live keys and the runs of splits [s_lo, s_hi], [s_lo2, s_hi2] that
  // hold them, in split order; a row with no live key takes split 0 alone,
  // which writes its zeros
  int s_lo, s_hi, s_lo2 = 1, s_hi2 = 0;
  bool live;
  if constexpr (RING) {
    int n = idx < 0 ? 0 : min(idx, cap - 1) + 1;
    if (a.window >= 0) n = min(n, a.window);
    const int r = idx < 0 ? 0 : idx % cap;   // the newest position's slot
    const int first = r - n + 1;            // < 0: the run wraps
    int dist = r - j;                       // (idx - j) mod L
    if (dist < 0) dist += cap;
    live = j < cap && dist < n;
    if (n <= 0) {
      s_lo = s_hi = 0;
    } else if (first >= 0) {
      s_lo = first / a.span;
      s_hi = r / a.span;
    } else {
      s_lo = 0;
      s_hi = r / a.span;
      s_lo2 = (first + cap) / a.span;
      s_hi2 = gridDim.x - 1;
      if (s_lo2 <= s_hi + 1) {   // the two runs meet: every split
        s_hi = s_hi2;
        s_lo2 = 1;
        s_hi2 = 0;
      }
    }
  } else {
    const int jmax = min(idx, cap - 1);
    const int jlo = a.window >= 0 ? max(idx - a.window + 1, 0) : 0;
    s_lo = jlo / a.span;
    s_hi = jmax / a.span;
    if (jmax < jlo) s_lo = s_hi = 0;
    live = j >= jlo && j <= jmax;
  }
  if ((s < s_lo || s > s_hi) && (s < s_lo2 || s > s_hi2)) return;
  const int n_live = s_hi - s_lo + 1 + max(s_hi2 - s_lo2 + 1, 0);
  // this thread's row (-1: not live, never read) and the block's K or V
  // rows, base + row * stride, computed where each stage is issued (paged:
  // the pool row, which also indexes the scales; ring: the ring slot)
  const int row = !live ? -1
                  : RING ? j
                         : (page * a.P + j % a.P) * a.K + kh;
  const auto base = [&](const void* p, long long sb, long long sk) {
    return static_cast<const TKV*>(p) + (RING ? b * sb + kh * sk : 0);
  };
  const long long pst = PAD ? a.h : HD;   // a pool row's stride

  unsigned char* kt = tiles + warp * kBufs * L::kBytes;
  unsigned char* vt = kt + (kBufs - 1) * L::kBytes;
  const unsigned int kbar = smem_u32(bars + 2 * warp), vbar = kbar + 8;
  // the tile's live keys: lanes [c_lo, c_hi], a run but in a ring tile that
  // holds both ends of a wrapped window
  const unsigned int mask = __ballot_sync(0xffffffffu, live);
  const int c_lo = __ffs(mask) - 1, c_hi = 31 - __clz(mask);
  if (mask) {
    // K, then V (two buffers), both in flight before any wait
    stage<TKV, HD, PAD>(base(a.k, a.k_sb, a.k_sk), RING ? a.k_st : pst, row,
                        kt, kbar, lane, a.h, __popc(mask));
    if (kBufs == 2)
      stage<TKV, HD, PAD>(base(a.v, a.v_sb, a.v_sk), RING ? a.v_st : pst,
                          row, vt, vbar, lane, a.h, __popc(mask));
  }
  // int8 pools: this lane's key scales, issued behind the copies
  float s_k = 1.f, s_v = 1.f;
  if (QUANT && live) {
    s_k = __ldg(a.sk + row);
    s_v = __ldg(a.sv + row);
  }
  __syncthreads();

  float m[GM], l[GM], acc[GM][DPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }
  if (mask) {
    if (!PAD) bar_wait(kbar);
    // lane c scores key c while V is in flight
    float dot[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) dot[g] = 0.f;
    const unsigned char* kr = kt + lane * L::kStride;
#pragma unroll 4
    for (int c = 0; c < L::kRowBytes / 16; ++c) {
      float kf[E];
      convert16<TKV>(*reinterpret_cast<const uint4*>(kr + 16 * c), kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int e4 = 0; e4 < E; e4 += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + g * HD + c * E + e4);
          dot[g] = fmaf(qv.x, kf[e4], dot[g]);
          dot[g] = fmaf(qv.y, kf[e4 + 1], dot[g]);
          dot[g] = fmaf(qv.z, kf[e4 + 2], dot[g]);
          dot[g] = fmaf(qv.w, kf[e4 + 3], dot[g]);
        }
      }
    }
    float p[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float d = QUANT ? dot[g] * s_k : dot[g];
      const float sc = live ? d * a.scale : kNegInf;
      m[g] = warp_max(sc);
      p[g] = live ? expf(sc - m[g]) : 0.f;
      l[g] = warp_sum(p[g]);
      if (QUANT) p[g] *= s_v;
    }
    if (kBufs == 1) {
      // V into K's buffer, once every lane has read its K row
      __syncwarp();
      if (!PAD) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage<TKV, HD, PAD>(base(a.v, a.v_sb, a.v_sk), RING ? a.v_st : pst,
                          row, vt, vbar, lane, a.h, __popc(mask));
      __syncwarp();
    }
    if (!PAD) bar_wait(vbar);
#pragma unroll 8
    for (int c = c_lo; c <= c_hi; ++c) {
      // a gap in a wrapped ring tile holds rows never read
      if (RING && !((mask >> c) & 1u)) continue;
      float vf[DPL];
      convert<TKV, DPL>(*reinterpret_cast<const RawVec<TKV, DPL>*>(
                            vt + c * L::kStride + lane * DPL * sizeof(TKV)),
                        vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float pc = __shfl_sync(0xffffffffu, p[g], c);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pc, vf[i], acc[g][i]);
      }
    }
  }

  // merge the warps' states in warp order; the tiles are done, so their
  // shared memory holds the states: m [nw][GM], l [nw][GM], acc
  // [nw][GM][HD]
  __syncthreads();
  float* pm = reinterpret_cast<float*>(tiles);
  float* pl = pm + nw * GM;
  float* pacc = pl + nw * GM;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      pacc[(warp * GM + g) * HD + lane * DPL + i] = acc[g][i];
    if (lane == 0) {
      pm[warp * GM + g] = m[g];
      pl[warp * GM + g] = l[g];
    }
  }
  __syncthreads();
  const int h = PAD ? a.h : HD;
  const long long bk = (long long)b * a.K + kh;
  const long long part0 = bk * gridDim.x * a.G;   // this slot's partials
  for (int e = tid; e < a.G * h; e += blockDim.x) {
    const int g = e / h, d = e % h;
    float mx = kNegInf, ls = 0.f, os = 0.f;
    for (int w = 0; w < nw; ++w)
      fold(mx, ls, os, pm[w * GM + g], pl[w * GM + g],
           pacc[(w * GM + g) * HD + d]);
    if (n_live == 1) {
      o[(bk * a.G + g) * h + d] = from_f32<TQ>(os / fmaxf(ls, kTiny));
    } else {
      float* part = a.ws + (part0 + (long long)s * a.G + g) * (h + 2);
      part[d] = os;
      if (d == 0) {
        part[h] = mx;
        part[h + 1] = ls;
      }
    }
  }
  if (n_live == 1) return;

  // the last block of the slot's splits to arrive merges them in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.counters + bk, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kR = 8;   // partials loaded before the first fold waits
  constexpr int kRuns = RING ? 2 : 1;
  for (int e = tid; e < a.G * h; e += blockDim.x) {
    const int g = e / h, d = e % h;
    float mx = kNegInf, ls = 0.f, os = 0.f;
#pragma unroll
    for (int run = 0; run < kRuns; ++run) {
      const int lo = run == 0 ? s_lo : s_lo2, hi = run == 0 ? s_hi : s_hi2;
      for (int t0 = lo; t0 <= hi; t0 += kR) {
        float pm_[kR], pl_[kR], po_[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          // past the run: the empty partial, which folds in as nothing
          pm_[r] = kNegInf;
          pl_[r] = po_[r] = 0.f;
          if (t0 + r <= hi) {
            const float* part =
                a.ws + (part0 + (long long)(t0 + r) * a.G + g) * (h + 2);
            pm_[r] = __ldcg(part + h);
            pl_[r] = __ldcg(part + h + 1);
            po_[r] = __ldcg(part + d);
          }
        }
#pragma unroll
        for (int r = 0; r < kR; ++r)
          fold(mx, ls, os, pm_[r], pl_[r], po_[r]);
      }
    }
    o[(bk * a.G + g) * h + d] = from_f32<TQ>(os / fmaxf(ls, kTiny));
  }
  if (tid == 0) a.counters[bk] = 0;
}

// Launch (occ null), or report the dynamic shared memory of a block and
// the blocks an SM holds (occ[0], occ[1]), of the instantiation a launch
// with these arguments takes.  Kernels::get<TQ, TKV, QUANT, HD, GM, PAD>()
// names a caller's __global__ instantiation; Kernels::kInt8 says whether it
// takes int8 rows.
template <typename Kernels, typename TQ, typename TKV, bool QUANT, int HD,
          int GM, bool PAD>
cudaError_t launch(const Args& a, cudaStream_t stream, int* occ) {
  auto kernel = Kernels::template get<TQ, TKV, QUANT, HD, GM, PAD>();
  const int nw = a.span / kKeys;
  using L = Tile<TKV, HD>;
  const int bytes =
      static_cast<int>(sizeof(float) * GM * HD + L::kBufs * nw * L::kBytes);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  if (occ != nullptr) {
    occ[0] = bytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ + 1, kernel,
                                                         nw * 32, bytes);
  }
  dim3 grid(n_splits(a), a.K, a.B);
  kernel<<<grid, nw * 32, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename Kernels, typename TQ, typename TKV, bool QUANT, int HD,
          bool PAD>
cudaError_t launch_g(const Args& a, cudaStream_t s, int* occ) {
  if (a.G <= 1) return launch<Kernels, TQ, TKV, QUANT, HD, 1, PAD>(a, s, occ);
  if (a.G <= 2) return launch<Kernels, TQ, TKV, QUANT, HD, 2, PAD>(a, s, occ);
  if (a.G <= 4) return launch<Kernels, TQ, TKV, QUANT, HD, 4, PAD>(a, s, occ);
  if (a.G <= 8) return launch<Kernels, TQ, TKV, QUANT, HD, 8, PAD>(a, s, occ);
  return cudaErrorInvalidValue;
}

// the smallest instantiated head dim that holds h, unpadded at 64 and 128
// over 16-byte aligned rows
template <typename Kernels, typename TQ, typename TKV, bool QUANT>
cudaError_t launch_hd(const Args& a, cudaStream_t s, int* occ) {
  if (a.rows16 && a.h == 64)
    return launch_g<Kernels, TQ, TKV, QUANT, 64, false>(a, s, occ);
  if (a.rows16 && a.h == 128)
    return launch_g<Kernels, TQ, TKV, QUANT, 128, false>(a, s, occ);
  if (a.h < 1) return cudaErrorInvalidValue;
  if (a.h <= 32) return launch_g<Kernels, TQ, TKV, QUANT, 32, true>(a, s, occ);
  if (a.h <= 64) return launch_g<Kernels, TQ, TKV, QUANT, 64, true>(a, s, occ);
  if (a.h <= 128)
    return launch_g<Kernels, TQ, TKV, QUANT, 128, true>(a, s, occ);
  return cudaErrorInvalidValue;
}

template <typename Kernels, typename TQ>
cudaError_t launch_kv(const Args& a, int kv_dtype, cudaStream_t s, int* occ) {
  switch (kv_dtype) {
    case kF32:
      return launch_hd<Kernels, TQ, float, false>(a, s, occ);
    case kBF16:
      return launch_hd<Kernels, TQ, __nv_bfloat16, false>(a, s, occ);
    case kI8:
      if constexpr (Kernels::kInt8)
        return launch_hd<Kernels, TQ, int8_t, true>(a, s, occ);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Kernels>
cudaError_t dispatch(const Args& a, int q_dtype, int kv_dtype,
                     cudaStream_t s, int* occ) {
  if (a.span < kKeys || a.span > kMaxWarps * kKeys || a.span % kKeys)
    return cudaErrorInvalidValue;
  switch (q_dtype) {
    case kF32:
      return launch_kv<Kernels, float>(a, kv_dtype, s, occ);
    case kBF16:
      return launch_kv<Kernels, __nv_bfloat16>(a, kv_dtype, s, occ);
    default:
      return cudaErrorInvalidValue;
  }
}

// the C entries' common checks: the grid's splits must fit the caller's
// workspace of ws_len floats
inline bool workspace_fits(const Args& a, long long ws_len) {
  if (a.span < 1 || n_splits(a) == 1) return true;
  return a.ws != nullptr && a.counters != nullptr &&
         ws_len >= (long long)a.B * a.K * n_splits(a) * a.G * (a.h + 2);
}

}  // namespace split_decode
}  // namespace repro
