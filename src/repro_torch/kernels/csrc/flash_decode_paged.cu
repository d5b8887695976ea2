// flash_decode_paged: one-token attention over a paged KV cache
//
//   q (B, K, G, h); pools pages_k, pages_v (NP, P, K, h); block table
//   bt (B, NB) int32; idx (B,) int32 write index of the current token
//   [int8 pools: scale pools sk, sv (NP, P, K) fp32]
//   ->  o (B, K, G, h) in q's dtype
//
// Replaces the TPU kernels of src/repro/kernels/flash_attn.py:
// flash_decode_paged: _decode_paged_kernel (pallas_call in
// _decode_paged_impl, K/V tiles routed by _paged_kv_index_map) and its
// int8-pool twin _decode_paged_kernel_q (pallas_call in
// _decode_paged_q_impl, scales routed by _paged_scale_index_map).  Slot b's
// key at logical position j lives at pages[bt[b, j / P], j % P, kh, :];
// positions never wrap.  A key is valid when j <= idx[b], j < l_real and,
// with a window, idx[b] - j < window.  Masked probabilities are exact
// zeros and the output divides by max(l, 1e-30), so a fully masked row
// gives 0.  int8 pools: each score column is scaled by sk[j] after the
// dot, and p by sv[j] before P.V, as the TPU kernel does; the payload is
// converted to fp32 in registers and never expanded in device memory.
//
// Scores take the promoted type of q and the pool: both are converted to
// fp32 as they are loaded, which is the promoted product for fp32/bf16
// (int8 -> fp32 is exact too), so neither operand is cast in memory.
//
// Bound on the H100: the bytes of the live K/V rows (and their scales),
// read once; the arithmetic is 4*h FLOPs per key and query head.  Design,
// from the ring decode kernel (flash_decode.cu): one block per (b, kv
// head) with the G query heads of the GQA group in it, 4 warps that take
// every fourth 32-key tile, so four tiles are in flight per block.  The
// block reads idx once and its block-table row once into shared memory; each
// key row is addressed on its own through the table, so a tile may span
// pages and any page size works.  Rows past idx (or l_real) are never
// read, so a poisoned scratch page cannot reach the output, and tiles
// past idx are skipped.  A warp loads 8 rows at a time into registers as
// vectors (a whole 128-element int8 row is one 4-byte load per lane) and
// converts and stores them to shared memory only once all 8 are issued (a
// conversion placed after each load made bf16 and int8 pools wait on
// memory once per row: 1.8x the fp32 pools' time); lane c scores key c
// for the G query heads, the warp keeps its online softmax (m, l, acc)
// in registers and broadcasts p with shuffles for P.V; the four warps'
// states merge at the end.  With B * K blocks (64 at 8 slots of Qwen3)
// the card's 132 SMs are not filled: splitting the key axis over blocks
// is later work.
//
// Any head dim h <= 128 runs, as in the ring decode kernel: the kernel is
// instantiated at HD 32, 64 and 128 and takes the smallest HD >= h; q, K
// and V hold zeros in the lanes past h (masked on load, so they add
// nothing to a score or to P.V) and only the h real lanes are stored.
// h = 64 and 128 take the unpadded instantiations, whose loads are those
// of the kernel before padding (the masked load, in the same code, made
// h 128 measurably slower).  The padded ones (PAD) load a lane's DPL = HD / 32 elements
// as one vector where all lie below h and h is a multiple of DPL, and
// otherwise (the lane that holds the edge, or an h off a multiple of DPL,
// whose rows are not vector aligned) element by element, still before the
// chunk's first conversion.
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kKeys = 32;
constexpr int kWarps = 4;
constexpr int kChunk = 8;   // cache rows loaded per round trip
constexpr int kI8 = 2;      // pool dtype code of an int8 pool

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

// N consecutive elements of type T as one vector, loaded raw and converted
// to fp32 apart, so that a chunk's loads are all issued before the first
// conversion waits on one.  int8 payloads convert without the int-to-float
// unit (a quarter of the FMA rate): each byte, biased to x + 128, becomes
// the low byte of the float 2^23 + x + 128, from which one subtraction
// leaves x exactly.
template <typename T, int N>
using RawVec = typename Vec<N * sizeof(T)>::type;

template <typename T, int N>
__device__ __forceinline__ RawVec<T, N> load_raw(const T* p) {
  return __ldg(reinterpret_cast<const RawVec<T, N>*>(p));
}

// elements d0 .. d0 + N - 1 of a cache row of h elements: one vector load
// where all N exist and the row is vector aligned (vec), else one load per
// element below h; the lanes past h stay zero bits, which convert to 0
template <typename T, int N>
__device__ __forceinline__ RawVec<T, N> load_row(const T* row, int d0, int h,
                                                 bool vec) {
  if (vec && d0 + N <= h) return load_raw<T, N>(row + d0);
  RawVec<T, N> raw{};
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (d0 + i < h) e[i] = row[d0 + i];
  return raw;
}

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

struct PagedArgs {
  const void* q;
  const void* pk;
  const void* pv;
  const float* sk;
  const float* sv;
  const int* bt;
  const int* idx;
  void* o;
  int B, K, G, h, P, NB, l_real;
  long long q_sb, q_sk, q_sg;
  int window;
  float scale;
};

template <typename TQ, typename TKV, bool QUANT, int HD, int GM, bool PAD>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_paged_kernel(PagedArgs a) {
  constexpr int DPL = HD / 32;   // head-dim elements per lane
  extern __shared__ float smem[];
  float* qs = smem;                                  // [GM][HD]
  int* bts = reinterpret_cast<int*>(qs + GM * HD);   // [NB]
  float* ws = qs + GM * HD + a.NB;                   // per warp: K
  // [kKeys][HD + 1], then V [kKeys][HD]
  constexpr int kWarpFloats = kKeys * (2 * HD + 1);

  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* pk = static_cast<const TKV*>(a.pk);
  const TKV* pv = static_cast<const TKV*>(a.pv);
  TQ* o = static_cast<TQ*>(a.o);

  const int b = blockIdx.y, kh = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int idx = a.idx[b];
  const int P = a.P, K = a.K;
  // the last logical position this slot may attend
  int jmax = idx;
  if (a.l_real - 1 < jmax) jmax = a.l_real - 1;
  if (a.NB * P - 1 < jmax) jmax = a.NB * P - 1;

  for (int e = tid; e < GM * HD; e += kWarps * 32) {
    const int g = e / HD, d = e % HD;
    float val = 0.f;
    if (g < a.G && d < a.h)
      val = to_f32(q[b * a.q_sb + kh * a.q_sk + g * a.q_sg + d]);
    qs[e] = val;
  }
  for (int e = tid; e < a.NB; e += kWarps * 32) bts[e] = a.bt[b * a.NB + e];
  __syncthreads();

  float* kw = ws + warp * kWarpFloats;
  float* vw = kw + kKeys * (HD + 1);
  const bool vec = a.h % DPL == 0;   // every row's vectors aligned (PAD)

  float m[GM], l[GM], acc[GM][DPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  for (int t = warp; t * kKeys <= jmax; t += kWarps) {
    const int j0 = t * kKeys;
    const int j = j0 + lane;
    // int8 pools: lane c's key scales from the same (page, row, kh),
    // issued before the tile's rows so that the loads overlap
    float s_k = 1.f, s_v = 1.f;
    if (QUANT && j <= jmax) {
      const long long srow = ((long long)bts[j / P] * P + j % P) * K + kh;
      s_k = __ldg(a.sk + srow);
      s_v = __ldg(a.sv + srow);
    }
    __syncwarp();
    // stage in chunks of kChunk rows: every load of a chunk is issued
    // before the first conversion or shared-memory store (rows past jmax
    // stay zero bits, which convert to 0)
#pragma unroll
    for (int c0 = 0; c0 < kKeys; c0 += kChunk) {
      RawVec<TKV, DPL> kraw[kChunk], vraw[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c0 + c;
        kraw[c] = vraw[c] = RawVec<TKV, DPL>{};
        if (j <= jmax) {
          const long long row =
              ((long long)bts[j / P] * P + j % P) * K + kh;
          if constexpr (PAD) {
            kraw[c] =
                load_row<TKV, DPL>(pk + row * a.h, lane * DPL, a.h, vec);
            vraw[c] =
                load_row<TKV, DPL>(pv + row * a.h, lane * DPL, a.h, vec);
          } else {
            kraw[c] = load_raw<TKV, DPL>(pk + row * HD + lane * DPL);
            vraw[c] = load_raw<TKV, DPL>(pv + row * HD + lane * DPL);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float kr[DPL], vr[DPL];
        convert<TKV, DPL>(kraw[c], kr);
        convert<TKV, DPL>(vraw[c], vr);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kw[(c0 + c) * (HD + 1) + lane * DPL + i] = kr[i];
          vw[(c0 + c) * HD + lane * DPL + i] = vr[i];
        }
      }
    }
    bool valid = j <= jmax;
    if (a.window >= 0) valid = valid && idx - j < a.window;
    __syncwarp();

    float p[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d)
        dot = fmaf(qs[g * HD + d], kw[lane * (HD + 1) + d], dot);
      if (QUANT) dot *= s_k;
      const float sc = valid ? dot * a.scale : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(sc));
      const float alpha = expf(m[g] - m_new);
      p[g] = valid ? expf(sc - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int jj = 0; jj < DPL; ++jj) acc[g][jj] *= alpha;
      if (QUANT) p[g] *= s_v;
    }
#pragma unroll 8
    for (int c = 0; c < kKeys; ++c) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float pc = __shfl_sync(0xffffffffu, p[g], c);
#pragma unroll
        for (int jj = 0; jj < DPL; ++jj)
          acc[g][jj] = fmaf(pc, vw[c * HD + lane + 32 * jj], acc[g][jj]);
      }
    }
  }

  // merge the four warps' partial softmax states; the tiles are done, so
  // their shared memory holds the partials: [warp][GM][HD] acc, then m, l
  __syncthreads();
  float* pacc = ws;
  float* pm = pacc + kWarps * GM * HD;
  float* pl = pm + kWarps * GM;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int jj = 0; jj < DPL; ++jj)
      pacc[(warp * GM + g) * HD + lane + 32 * jj] = acc[g][jj];
    if (lane == 0) {
      pm[warp * GM + g] = m[g];
      pl[warp * GM + g] = l[g];
    }
  }
  __syncthreads();
  const int h = PAD ? a.h : HD;
  for (int e = tid; e < a.G * h; e += kWarps * 32) {
    const int g = e / h, d = e % h;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, pm[w * GM + g]);
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(pm[w * GM + g] - mx);
      lsum += pl[w * GM + g] * f;
      osum += pacc[(w * GM + g) * HD + d] * f;
    }
    o[(((long long)b * K + kh) * a.G + g) * h + d] =
        from_f32<TQ>(osum / fmaxf(lsum, kTiny));
  }
}

template <typename TQ, typename TKV, bool QUANT, int HD, int GM, bool PAD>
cudaError_t launch(const PagedArgs& a, cudaStream_t stream) {
  const size_t tiles = kWarps * kKeys * (2 * HD + 1);
  const size_t merge = kWarps * GM * (HD + 2);
  const size_t bytes =
      sizeof(float) * (GM * HD + a.NB + (tiles > merge ? tiles : merge));
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_paged_kernel<TQ, TKV, QUANT, HD, GM, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(a.K, a.B);
  flash_decode_paged_kernel<TQ, TKV, QUANT, HD, GM, PAD>
      <<<grid, kWarps * 32, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool QUANT, int HD, bool PAD>
cudaError_t launch_g(const PagedArgs& a, cudaStream_t stream) {
  if (a.G <= 1) return launch<TQ, TKV, QUANT, HD, 1, PAD>(a, stream);
  if (a.G <= 2) return launch<TQ, TKV, QUANT, HD, 2, PAD>(a, stream);
  if (a.G <= 4) return launch<TQ, TKV, QUANT, HD, 4, PAD>(a, stream);
  if (a.G <= 8) return launch<TQ, TKV, QUANT, HD, 8, PAD>(a, stream);
  return cudaErrorInvalidValue;
}

// the smallest instantiated head dim that holds h, unpadded at 64 and 128
template <typename TQ, typename TKV, bool QUANT>
cudaError_t launch_hd(const PagedArgs& a, cudaStream_t stream) {
  if (a.h == 64) return launch_g<TQ, TKV, QUANT, 64, false>(a, stream);
  if (a.h == 128) return launch_g<TQ, TKV, QUANT, 128, false>(a, stream);
  if (a.h < 1) return cudaErrorInvalidValue;
  if (a.h <= 32) return launch_g<TQ, TKV, QUANT, 32, true>(a, stream);
  if (a.h <= 64) return launch_g<TQ, TKV, QUANT, 64, true>(a, stream);
  if (a.h <= 128) return launch_g<TQ, TKV, QUANT, 128, true>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_kv(const PagedArgs& a, int kv_dtype, cudaStream_t s) {
  switch (kv_dtype) {
    case kF32:
      return launch_hd<TQ, float, false>(a, s);
    case kBF16:
      return launch_hd<TQ, __nv_bfloat16, false>(a, s);
    case kI8:
      return launch_hd<TQ, int8_t, true>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_decode_paged(
    const void* q, const void* pk, const void* pv, const float* sk,
    const float* sv, const int* bt, const int* idx, void* o, int B, int K,
    int G, int h, int P, int NB, int l_real, long long q_sb, long long q_sk,
    long long q_sg, int window, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (B == 0 || K == 0) return cudaSuccess;
  if ((kv_dtype == repro::kI8) != (sk != nullptr && sv != nullptr))
    return cudaErrorInvalidValue;
  repro::PagedArgs a{q,  pk, pv, sk,     sv,   bt,   idx,  o,      B,
                     K,  G,  h,  P,      NB,   l_real, q_sb, q_sk, q_sg,
                     window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case repro::kF32:
      return repro::launch_kv<float>(a, kv_dtype, s);
    case repro::kBF16:
      return repro::launch_kv<__nv_bfloat16>(a, kv_dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}
