// flash_prefill: online-softmax attention forward over the layer layouts
//
//   q (B, S, K, G, h), k and v (B, T, K, h)  ->  o (B, S, K, G, h)
//   optional lse (B, K, S*G) = m + log(l), fp32
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py: flash_prefill
// (_prefill_kernel, pallas_call in _prefill_impl).  Same masking contract:
// query row r = s*G + g sits at q_off[b] + s, key t at k_off[b] + t; a key
// is valid when t < T, (causal) k_pos <= q_pos and (window) q_pos - k_pos <
// window.  Masked scores are NEG_INF = -1e30 and masked probabilities are
// zeroed explicitly; the output divides by max(l, 1e-30), so a fully-masked
// row gives 0.
//
// q, k and v are read through their strides (the head dim must be
// contiguous): no GQA fold, no k/v transpose and no padded copies as the
// TPU path makes.  The TPU's sequential key-tile grid axis becomes a loop
// inside the block, and that loop stops at the causal band (and starts at
// the window band): the serving prefill attends the whole max_len cache,
// most of whose tiles lie past the band.
//
// Bound on the H100: at the serving shapes (S = 128 of a 160-slot cache,
// h = 64) the work is small and the kernel is bound by latency and fp32
// FMA issue, not by the few MB of q/k/v it reads.  Design: one block of
// 4 warps per (b, kv head, 32-row tile); each warp owns 8 rows and keeps
// their m, l and output accumulator in registers, lane c scores key c of
// the 32-key tile staged in shared memory, the row max/sum are warp
// shuffles, and P.V broadcasts p across the warp with shuffles.  Tensor
// cores (mma / wgmma) are later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRows = 32;   // query rows (s*G + g) per block
constexpr int kKeys = 32;   // keys per tile: one per lane
constexpr int kWarps = 4;

struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* q_off_vec;
  const int* k_off_vec;
  int q_off, k_off;
  int B, S, T, K, G, h;
  long long q_sb, q_ss, q_sk, q_sg;
  long long k_sb, k_st, k_sk;
  long long v_sb, v_st, v_sk;
  int causal, window;
  float scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_kernel(PrefillArgs a) {
  constexpr int RPW = kRows / kWarps;   // rows per warp
  constexpr int DPL = HD / 32;          // head dims per lane
  extern __shared__ float smem[];
  float* qs = smem;                              // [kRows][HD]
  float* ks = qs + kRows * HD;                   // [kKeys][HD + 1]
  float* vs = ks + kKeys * (HD + 1);             // [kKeys][HD]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  const int b = blockIdx.z, kh = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int SG = a.S * a.G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qo = a.q_off_vec ? a.q_off_vec[b] : a.q_off;
  const int ko = a.k_off_vec ? a.k_off_vec[b] : a.k_off;

  for (int e = tid; e < kRows * HD; e += kWarps * 32) {
    const int r = e / HD, d = e % HD, rg = r0 + r;
    float val = 0.f;
    if (rg < SG && d < a.h) {
      const int s = rg / a.G, g = rg % a.G;
      val = to_f32(q[b * a.q_sb + s * a.q_ss + kh * a.q_sk + g * a.q_sg + d]);
    }
    qs[e] = val;
  }

  // key-tile range inside the (causal, window) band of this row tile
  const int q_lo = qo + r0 / a.G;
  const int q_hi = qo + (min(r0 + kRows, SG) - 1) / a.G;
  const int n_tiles = (a.T + kKeys - 1) / kKeys;
  int t_end = n_tiles;
  if (a.causal) {
    const int last = q_hi - ko;                  // last key index in band
    t_end = last < 0 ? 0 : min(n_tiles, last / kKeys + 1);
  }
  int t_begin = 0;
  if (a.window >= 0) {
    const int first = q_lo - a.window + 1 - ko;  // first key index in band
    t_begin = first <= 0 ? 0 : first / kKeys;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int t0 = t * kKeys;
    __syncthreads();   // previous tile fully consumed (and qs written)
    // all of a thread's loads for the tile issue before its shared-memory
    // stores: interleaved, each load would wait for the previous store
    constexpr int kPer = kKeys * HD / (kWarps * 32);
    float kr[kPer], vr[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kWarps * 32;
      const int c = e / HD, d = e % HD, tk = t0 + c;
      const bool in = tk < a.T && d < a.h;
      kr[i] = in ? to_f32(k[b * a.k_sb + tk * a.k_st + kh * a.k_sk + d])
                 : 0.f;
      vr[i] = in ? to_f32(v[b * a.v_sb + tk * a.v_st + kh * a.v_sk + d])
                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kWarps * 32;
      ks[(e / HD) * (HD + 1) + e % HD] = kr[i];
      vs[e] = vr[i];
    }
    __syncthreads();

    const int tk = t0 + lane;
    const int kpos = ko + tk;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * kWarps;
      const int qpos = qo + (r0 + r) / a.G;
      bool valid = tk < a.T;
      if (a.causal) valid = valid && kpos <= qpos;
      if (a.window >= 0) valid = valid && qpos - kpos < a.window;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d)
        dot = fmaf(qs[r * HD + d], ks[lane * (HD + 1) + d], dot);
      const float sc = valid ? dot * a.scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float alpha = expf(m[i] - m_new);
      const float p = valid ? expf(sc - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= alpha;
#pragma unroll 8
      for (int c = 0; c < kKeys; ++c) {
        const float pc = __shfl_sync(0xffffffffu, p, c);
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          acc[i][j] = fmaf(pc, vs[c * HD + lane + 32 * j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int rg = r0 + warp + i * kWarps;
    if (rg >= SG) continue;
    const int s = rg / a.G, g = rg % a.G;
    const float inv = 1.f / fmaxf(l[i], kTiny);
    const long long ob =
        ((((long long)b * a.S + s) * a.K + kh) * a.G + g) * a.h;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < a.h) o[ob + d] = from_f32<T>(acc[i][j] * inv);
    }
    if (a.lse && lane == 0)
      a.lse[((long long)b * a.K + kh) * SG + rg] =
          m[i] + logf(fmaxf(l[i], kTiny));
  }
}

template <typename T, int HD>
cudaError_t launch(const PrefillArgs& a, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * (kRows * HD + kKeys * (HD + 1) + kKeys * HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S * a.G + kRows - 1) / kRows, a.K, a.B);
  flash_prefill_kernel<T, HD><<<grid, kWarps * 32, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const PrefillArgs& a, cudaStream_t stream) {
  if (a.h <= 32) return launch<T, 32>(a, stream);
  if (a.h <= 64) return launch<T, 64>(a, stream);
  if (a.h <= 128) return launch<T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_prefill(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const int* q_off_vec, int q_off, const int* k_off_vec, int k_off, int B,
    int S, int T, int K, int G, int h, long long q_sb, long long q_ss,
    long long q_sk, long long q_sg, long long k_sb, long long k_st,
    long long k_sk, long long v_sb, long long v_st, long long v_sk,
    int causal, int window, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  repro::PrefillArgs a{q,    k,    v,    o,    lse,  q_off_vec, k_off_vec,
                       q_off, k_off, B,  S,    T,    K,         G,
                       h,    q_sb, q_ss, q_sk, q_sg, k_sb,      k_st,
                       k_sk, v_sb, v_st, v_sk, causal, window,  scale};
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
