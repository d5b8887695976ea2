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
// Both dtypes run on the tensor cores, at any h <= 128 (padded to the HD
// 64 or 128 instantiation), through flash_fwd_tc.cuh (see the note
// there): bf16 on wgmma bf16 products (flash_fwd_tc_kernel), fp32 on split
// TF32 wgmma products (flash_fwd_tf32_kernel: three tf32 products a pair,
// each good to about 2^-21 relative, fp32 sums; bound at OPT-125m's
// training shape: 3.23 GFLOP at 165 TFLOP/s of fp32 work, 0.0196 ms).
// Head dims past 128 are refused.
#include "flash_fwd_tc.cuh"

namespace repro {
namespace {

template <typename T>
cudaError_t launch_hd(const PrefillArgs& a, cudaStream_t stream) {
  if (a.h <= 64) return ffwd::launch<T, 64>(a, stream);
  if (a.h <= 128) return ffwd::launch<T, 128>(a, stream);
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
