// flash_decode: one-token attention over a ring-buffer KV cache
//
//   q (B, K, G, h), cache k and v (B, L, K, h), idx scalar or (B,)
//   ->  o (B, K, G, h)
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py: flash_decode
// (_decode_kernel, pallas_call in _decode_impl).  Slot j of the ring holds
// absolute position pos = idx - ((idx - j) mod L) (non-negative remainder);
// it is valid when pos >= 0 and, with a window, idx - pos < window.  Key
// tiles that start past idx are skipped (they hold nothing in an unwrapped
// cache).  Masked probabilities are zeroed and the output divides by
// max(l, 1e-30), as in the TPU kernel.
//
// The cache is read in place through its strides (head dim contiguous):
// the TPU path transposes every layer's whole cache on every step, which
// this kernel does not.
//
// Bound on the H100: the bytes of the K and V cache rows up to idx; the
// arithmetic is 4*h FLOPs per key and query head.  Design: one block per
// (b, kv head) with 4 warps that each take every fourth 32-key tile, so
// four tiles are in flight per block.  A warp stages its K and V tiles in
// shared memory with loads along h, eight rows at a time into registers
// before any store (interleaved loads and stores serialise on memory
// latency, since the compiler cannot move a load past a store that might
// alias it), lane c scores key c for the G query heads, the warp keeps its
// own online-softmax state (m, l, acc) in registers and broadcasts p with
// shuffles for P.V.  The four partial states merge at the end.  Splitting
// a long cache over more blocks is later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kKeys = 32;
constexpr int kWarps = 4;
constexpr int kChunk = 8;   // cache rows loaded per round trip

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* idx_vec;
  int idx;
  int B, L, K, G, h;
  long long q_sb, q_sk, q_sg;
  long long k_sb, k_st, k_sk;
  long long v_sb, v_st, v_sk;
  int window;
  float scale;
};

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(DecodeArgs a) {
  constexpr int DPL = HD / 32;
  extern __shared__ float smem[];
  float* qs = smem;                        // [GM][HD]
  float* ks = qs + GM * HD;                // per warp: K [kKeys][HD + 1],
                                           // then V [kKeys][HD]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  const int b = blockIdx.y, kh = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int idx = a.idx_vec ? a.idx_vec[b] : a.idx;
  const int L = a.L;
  float* kw = ks + warp * kKeys * (2 * HD + 1);
  float* vw = kw + kKeys * (HD + 1);

  for (int e = tid; e < GM * HD; e += kWarps * 32) {
    const int g = e / HD, d = e % HD;
    float val = 0.f;
    if (g < a.G && d < a.h)
      val = to_f32(q[b * a.q_sb + kh * a.q_sk + g * a.q_sg + d]);
    qs[e] = val;
  }
  __syncthreads();

  float m[GM], l[GM], acc[GM][DPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  const int n_tiles = (L + kKeys - 1) / kKeys;
  const T* kb = k + b * a.k_sb + kh * a.k_sk;
  const T* vb = v + b * a.v_sb + kh * a.v_sk;
  for (int t = warp; t < n_tiles && t * kKeys <= idx; t += kWarps) {
    const int j0 = t * kKeys;
    __syncwarp();
    // stage in chunks of kChunk rows: every load of a chunk is issued
    // before its shared-memory stores, so the warp waits on memory once
    // per chunk instead of once per element
#pragma unroll
    for (int c0 = 0; c0 < kKeys; c0 += kChunk) {
      float kr[kChunk][DPL], vr[kChunk][DPL];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c0 + c;
#pragma unroll
        for (int jj = 0; jj < DPL; ++jj) {
          const int d = lane + 32 * jj;
          const bool in = j < L && d < a.h;
          kr[c][jj] = in ? to_f32(kb[j * a.k_st + d]) : 0.f;
          vr[c][jj] = in ? to_f32(vb[j * a.v_st + d]) : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
#pragma unroll
        for (int jj = 0; jj < DPL; ++jj) {
          kw[(c0 + c) * (HD + 1) + lane + 32 * jj] = kr[c][jj];
          vw[(c0 + c) * HD + lane + 32 * jj] = vr[c][jj];
        }
    }
    __syncwarp();

    const int j = j0 + lane;
    int rem = (idx - j) % L;
    if (rem < 0) rem += L;
    const int pos = idx - rem;
    bool valid = j < L && pos >= 0;
    if (a.window >= 0) valid = valid && idx - pos < a.window;

    float p[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d)
        dot = fmaf(qs[g * HD + d], kw[lane * (HD + 1) + d], dot);
      const float sc = valid ? dot * a.scale : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(sc));
      const float alpha = expf(m[g] - m_new);
      p[g] = valid ? expf(sc - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int jj = 0; jj < DPL; ++jj) acc[g][jj] *= alpha;
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

  // merge the four warps' partial softmax states; the K tiles are done, so
  // their shared memory holds the partials: [warp][GM][HD] acc, then m, l
  __syncthreads();
  float* pacc = ks;
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
  for (int e = tid; e < a.G * a.h; e += kWarps * 32) {
    const int g = e / a.h, d = e % a.h;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, pm[w * GM + g]);
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(pm[w * GM + g] - mx);
      lsum += pl[w * GM + g] * f;
      osum += pacc[(w * GM + g) * HD + d] * f;
    }
    o[(((long long)b * a.K + kh) * a.G + g) * a.h + d] =
        from_f32<T>(osum / fmaxf(lsum, kTiny));
  }
}

template <typename T, int HD, int GM>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t tiles = kWarps * kKeys * (2 * HD + 1);
  const size_t merge = kWarps * GM * (HD + 2);
  const size_t bytes =
      sizeof(float) * (GM * HD + (tiles > merge ? tiles : merge));
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T, HD, GM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(a.K, a.B);
  flash_decode_kernel<T, HD, GM><<<grid, kWarps * 32, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_g(const DecodeArgs& a, cudaStream_t stream) {
  if (a.G <= 1) return launch<T, HD, 1>(a, stream);
  if (a.G <= 2) return launch<T, HD, 2>(a, stream);
  if (a.G <= 4) return launch<T, HD, 4>(a, stream);
  if (a.G <= 8) return launch<T, HD, 8>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_hd(const DecodeArgs& a, cudaStream_t stream) {
  if (a.h <= 32) return launch_g<T, 32>(a, stream);
  if (a.h <= 64) return launch_g<T, 64>(a, stream);
  if (a.h <= 128) return launch_g<T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, void* o, const int* idx_vec,
    int idx, int B, int L, int K, int G, int h, long long q_sb,
    long long q_sk, long long q_sg, long long k_sb, long long k_st,
    long long k_sk, long long v_sb, long long v_st, long long v_sk,
    int window, float scale, int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  repro::DecodeArgs a{q,    k,    v,    o,    idx_vec, idx,  B,    L,
                      K,    G,    h,    q_sb, q_sk,    q_sg, k_sb, k_st,
                      k_sk, v_sb, v_st, v_sk, window,  scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::launch_hd<float>(a, s);
    case repro::kBF16:
      return repro::launch_hd<__nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
