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
// fp32 as they are used, which is the promoted product for fp32/bf16
// (int8 -> fp32 is exact too), so neither operand is cast in memory.
//
// Bound on the H100: the bytes of the live K/V rows (and their scales),
// read once; the arithmetic is 4*h FLOPs per key and query head, far below
// the FMA units' rate, so bytes and memory latency bound the kernel.
// Design (flash-decoding, in flash_decode_split.cuh, which the ring-cache
// decode shares): the grid runs over (split, KV head, slot), a split a
// fixed span of keys; each warp copies its 32-key tile's live rows with
// the copy engine, and the last block of a slot merges the partials in
// split order in the same launch.  Rows past idx (or l_real) and, with a
// window, rows before it are never read, so a poisoned scratch page cannot
// reach the output.  What bounds it now: each block's chain of dependent
// latencies (idx and the table, the copies, scoring, P.V, the merge), about
// as long as its bytes take to arrive.
//
// A slot's splits are functions of its own idx, the window, l_real and
// NB * P only, so a row's bits do not depend on the batch.  The entry works
// out the grid's splits itself and refuses a workspace too short for them.
// Any head dim h <= 128 runs (HD 32, 64 and 128 instantiations; bulk copies
// at h 64 and 128).
#include "flash_decode_split.cuh"

namespace repro {
namespace {

using split_decode::Args;

template <typename TQ, typename TKV, bool QUANT, int HD, int GM, bool PAD>
__global__ void __launch_bounds__(split_decode::kMaxWarps * 32)
flash_decode_paged_kernel(Args a) {
  split_decode::decode<false, TQ, TKV, QUANT, HD, GM, PAD>(a);
}

struct PagedKernels {
  static constexpr bool kInt8 = true;
  template <typename TQ, typename TKV, bool QUANT, int HD, int GM, bool PAD>
  static auto get() {
    return flash_decode_paged_kernel<TQ, TKV, QUANT, HD, GM, PAD>;
  }
};

Args paged_args(int B, int K, int G, int h, int P, int NB, int l_real,
                int span) {
  Args a{};
  a.B = B;
  a.K = K;
  a.G = G;
  a.h = h;
  a.P = P;
  a.NB = NB;
  a.l_real = l_real;
  a.span = span;
  a.rows16 = 1;   // contiguous pools: rows of h 64 and 128 are 16-byte runs
  return a;
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_decode_paged(
    const void* q, const void* pk, const void* pv, const float* sk,
    const float* sv, const int* bt, const int* idx, void* o, float* ws,
    int* counters, int B, int K, int G, int h, int P, int NB, int l_real,
    int span, long long ws_len, long long q_sb, long long q_sk,
    long long q_sg, int window, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (B == 0 || K == 0) return cudaSuccess;
  if ((kv_dtype == repro::split_decode::kI8) != (sk != nullptr && sv != nullptr))
    return cudaErrorInvalidValue;
  repro::split_decode::Args a =
      repro::paged_args(B, K, G, h, P, NB, l_real, span);
  a.q = q;
  a.k = pk;
  a.v = pv;
  a.sk = sk;
  a.sv = sv;
  a.bt = bt;
  a.idx = idx;
  a.o = o;
  a.ws = ws;
  a.counters = counters;
  a.q_sb = q_sb;
  a.q_sk = q_sk;
  a.q_sg = q_sg;
  a.window = window;
  a.scale = scale;
  // the grid's splits must fit the caller's workspace of ws_len floats
  if (!repro::split_decode::workspace_fits(a, ws_len))
    return cudaErrorInvalidValue;
  return repro::split_decode::dispatch<repro::PagedKernels>(
      a, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream), nullptr);
}

// the dynamic shared memory of a block (out[0], bytes) and the blocks an
// SM holds (out[1]) of the instantiation that a launch with these
// arguments takes
extern "C" int repro_flash_decode_paged_occupancy(int q_dtype, int kv_dtype,
                                                  int h, int G, int span,
                                                  int* out) {
  const repro::split_decode::Args a =
      repro::paged_args(1, 1, G, h, 1, 1, 1, span);
  return repro::split_decode::dispatch<repro::PagedKernels>(
      a, q_dtype, kv_dtype, nullptr, out);
}
