// flash_prefill_grads: the flash-attention backward over the layer layouts
//
//   q, do (B, S, K, G, h), k and v (B, T, K, h), lse and delta (B, K, S*G)
//   ->  dq (B, S, K, G, h), dk and dv (B, T, K, h)
//
// with p = exp(q.k * scale - lse) recomputed per tile from the forward's
// saved log-sum-exp (row r = s*G + g), delta = rowsum(do * o) (computed by
// the wrapper, as the reference computes it outside its kernels),
// ds = p * (do.v - delta) * scale, and
//   dq = ds . k;   dk = ds^T . q;   dv = p^T . do,
// dk and dv summing over the G query heads that share a KV head.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py:
// flash_prefill_grads (_dq_kernel in _dq_impl, _dkv_kernel in _dkv_impl).
// Same masking contract as flash_prefill: query s sits at q_off[b] + s, key
// t at k_off[b] + t; a pair is valid when t < T, (causal) k_pos <= q_pos and
// (window) q_pos - k_pos < window; p is zeroed explicitly where the pair is
// not valid, so a fully-masked row (lse about -1e30) gives zero gradients.
//
// Both routes take any h <= 128 on the tensor cores, as two kernels
// launched one after the other on the caller's stream (dk/dv, then dq; no
// atomics, so every run gives the same bits), in flash_bwd_tc.cuh:
//  - bf16: wgmma products of bf16 operands, P and dS fed back from the
//    accumulator registers (flash_dkv_tc_kernel, flash_dq_tc_kernel);
//  - fp32: split TF32 (3xTF32), P^T and dS^T through shared memory, Q, dO
//    and K read transposed as wgmma's register A (flash_dkv_tf32_kernel,
//    flash_dq_tf32_kernel).
// See the notes there.  q, k, v and do are read through their strides
// (head dim contiguous): no GQA fold, transpose or padded copy in device
// memory.
//
// Bound on the H100: at the OPT-125m training shape (B 8, S = T = 512,
// K 12, h 64, causal, fp32) the backward does 8.07 GFLOP of unique
// products (five 2h products a pair) on about 50 MB: 0.049 ms as three
// TF32 products at 495 TFLOP/s (0.120 ms at fp32 FMA's 67), operations.
// At Qwen3-0.6B's (bf16, K 8 x G 2, h 128) bytes bound it: about 101 MB,
// 0.030 ms.
//
// ptxas (sm_90a, -O3) on the bf16 kernels, no spills: dk/dv 242 registers
// at HD 128 (dK and dV 128 of them, S^T and dP^T 64), 182 at HD 64; dq 190
// and 146.  chip_smoke.py phase 2 prints both routes' registers, spills
// and wgmma serialisation.
#include "flash_bwd_tc.cuh"

extern "C" int repro_flash_prefill_grads(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    const int* q_off_vec, int q_off, const int* k_off_vec, int k_off, int B,
    int S, int T, int K, int G, int h, long long q_sb, long long q_ss,
    long long q_sk, long long q_sg, long long do_sb, long long do_ss,
    long long do_sk, long long do_sg, long long k_sb, long long k_st,
    long long k_sk, long long v_sb, long long v_st, long long v_sk,
    int causal, int window, float scale, int dtype, void* stream) {
  if (B == 0 || K == 0 || S == 0 || T == 0) return cudaSuccess;
  repro::BwdArgs a{q,     k,     v,     dout,  lse,   delta, dq,    dk,
                   dv,    q_off_vec, k_off_vec, q_off, k_off, B, S, T,
                   K,     G,     h,     q_sb,  q_ss,  q_sk,  q_sg,  do_sb,
                   do_ss, do_sk, do_sg, k_sb,  k_st,  k_sk,  v_sb,  v_st,
                   v_sk,  causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      if (h <= 64) return repro::fbwd::launch32<64>(a, s);
      if (h <= 128) return repro::fbwd::launch32<128>(a, s);
      return cudaErrorInvalidValue;
    case repro::kBF16:
      if (h <= 64) return repro::fbwd::launch<64>(a, s);
      if (h <= 128) return repro::fbwd::launch<128>(a, s);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}
