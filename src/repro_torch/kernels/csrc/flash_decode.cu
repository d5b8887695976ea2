// flash_decode: one-token attention over a ring-buffer KV cache
//
//   q (B, K, G, h), caches k and v (B, L, K, h), idx scalar or (B,) int32
//   ->  o (B, K, G, h) in q's dtype
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py: flash_decode
// (_decode_kernel, pallas_call in _decode_impl).  Slot j of the ring holds
// absolute position pos = idx - ((idx - j) mod L) (non-negative remainder);
// it is valid when pos >= 0 and, with a window, idx - pos < window.  Masked
// probabilities are exact zeros and the output divides by max(l, 1e-30), as
// in the TPU kernel, so a fully masked row gives 0.
//
// q and the cache may hold different dtypes (fp32 or bf16 each: Qwen3's
// bf16 compute over an fp32 cache): both are converted to fp32 as they are
// used, which is the promoted product the TPU kernel computes per tile, so
// neither operand is cast in memory and o is written in q's dtype.  The
// caches are read in place through their strides (head dim contiguous);
// the TPU path transposes every layer's whole cache on every step.
//
// Bound on the H100: the bytes of the live K and V rows, read once; the
// arithmetic is 4*h FLOPs per key and query head, far below the FMA units'
// rate, so bytes and memory latency bound the kernel.  Design: the
// split-key decode of flash_decode_split.cuh, shared with the paged decode,
// with the ring as its row and mask policy.  The grid runs over (split, KV
// head, slot), a split a fixed span of ring slots; the live slots are the
// n = min(idx + 1, L, window) newest positions, a circular run of slots
// ending at idx mod L, so a slot's live splits are at most two runs (the
// ring's first slots, then its last ones past the wrap point), merged in
// split order by the slot's last block in the same launch.  Rows that are
// not live are never read: a NaN in a dead row cannot reach the output.
// Rows come by bulk copies (h 64 and 128 over 16-byte aligned rows) or
// element by element (other h, or rows off 16 bytes).
#include "flash_decode_split.cuh"

namespace repro {
namespace {

using split_decode::Args;

template <typename TQ, typename TKV, int HD, int GM, bool PAD>
__global__ void __launch_bounds__(split_decode::kMaxWarps * 32)
flash_decode_ring_kernel(Args a) {
  split_decode::decode<true, TQ, TKV, false, HD, GM, PAD>(a);
}

struct RingKernels {
  static constexpr bool kInt8 = false;
  template <typename TQ, typename TKV, bool QUANT, int HD, int GM, bool PAD>
  static auto get() {
    return flash_decode_ring_kernel<TQ, TKV, HD, GM, PAD>;
  }
};

Args ring_args(int B, int L, int K, int G, int h, int span, int rows16) {
  Args a{};
  a.B = B;
  a.K = K;
  a.G = G;
  a.h = h;
  a.P = a.l_real = L;   // a ring is one page of L rows a slot
  a.NB = 1;
  a.span = span;
  a.rows16 = rows16;
  return a;
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_decode(
    const void* q, const void* k, const void* v, void* o, const int* idx_vec,
    int idx, float* ws, int* counters, int B, int L, int K, int G, int h,
    int span, long long ws_len, long long q_sb, long long q_sk,
    long long q_sg, long long k_sb, long long k_st, long long k_sk,
    long long v_sb, long long v_st, long long v_sk, int window, float scale,
    int q_dtype, int kv_dtype, int rows16, void* stream) {
  if (B == 0 || K == 0) return cudaSuccess;
  if (L < 1) return cudaErrorInvalidValue;
  repro::split_decode::Args a =
      repro::ring_args(B, L, K, G, h, span, rows16);
  a.q = q;
  a.k = k;
  a.v = v;
  a.idx = idx_vec;
  a.idx_s = idx;
  a.o = o;
  a.ws = ws;
  a.counters = counters;
  a.q_sb = q_sb;
  a.q_sk = q_sk;
  a.q_sg = q_sg;
  a.k_sb = k_sb;
  a.k_st = k_st;
  a.k_sk = k_sk;
  a.v_sb = v_sb;
  a.v_st = v_st;
  a.v_sk = v_sk;
  a.window = window;
  a.scale = scale;
  // the grid's splits must fit the caller's workspace of ws_len floats
  if (!repro::split_decode::workspace_fits(a, ws_len))
    return cudaErrorInvalidValue;
  return repro::split_decode::dispatch<repro::RingKernels>(
      a, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream), nullptr);
}

// the dynamic shared memory of a block (out[0], bytes) and the blocks an
// SM holds (out[1]) of the instantiation that a launch over 16-byte aligned
// rows with these arguments takes
extern "C" int repro_flash_decode_occupancy(int q_dtype, int kv_dtype, int h,
                                            int G, int span, int* out) {
  const repro::split_decode::Args a = repro::ring_args(1, 1, 1, G, h, span, 1);
  return repro::split_decode::dispatch<repro::RingKernels>(
      a, q_dtype, kv_dtype, nullptr, out);
}
