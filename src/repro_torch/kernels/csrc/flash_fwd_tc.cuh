// flash_prefill (flash_prefill.cu) on the tensor cores, both operand
// types through the same PrefillArgs: bf16 as wgmma products of bf16
// operands, fp32 as split TF32 (3xTF32) wgmma products, both into fp32
// accumulators, at any h <= 128 (padded to HD 64 or 128).
//
// Replaces, on this card, the TPU kernel src/repro/kernels/flash_attn.py:
// flash_prefill (_prefill_kernel in _prefill_impl).
//
// What bounds it on the H100: at Qwen3-0.6B's training shape (B 8, S 512,
// 8 KV heads x G 2, h 128, causal, bf16) a call moves about 50 MB (0.015
// ms) and does 8.6 GFLOP (0.009 ms at 989 TFLOP/s): bytes, closely followed
// by the products.  At OPT-125m's (B 8, S 512, 12 heads of 64, causal,
// fp32) it moves 50 MB (0.015 ms) and does 3.23 GFLOP: 0.0196 ms as three
// TF32 products at 495 TFLOP/s (0.048 ms at fp32 FMA's 67): operations.
// The FMA kernels ran both on fp32 FMA, one lane a key.  The design is the
// dq kernel of flash_bwd_tc.cuh with dP and dS replaced by the online
// softmax, on the pieces of flash_tc.cuh:
//
// - One warpgroup (128 threads) a block, a block per (b, KV head, 64
//   folded rows r = s * G + g).  Q [64][HD] stays in shared memory; the
//   block walks the 64-key tiles of its causal/window band.  The last row
//   tiles of a causal band are the longest and come first.
// - S = Q K^T (m64n64, both K-major), then the online softmax on the
//   accumulator registers: a thread holds 16 scores of each of 2 rows, the
//   row max is 2 quad shuffles, and alpha rescales the thread's O
//   accumulators of those rows.  The row sum l stays a per-thread partial
//   until the end.  A tile whose pairs are all valid takes no mask test.
// - O += P V (m64nHD): p in registers as wgmma's A.  P never touches
//   shared memory.
// - Scores go to exp as ex2.approx on log2e-scaled values (flushing
//   results below 2^-126 to zero); m is kept in that scale, and lse is
//   converted back to the natural log.
//
// bf16 (flash_fwd_tc_kernel, two blocks an SM): k16 products; p rounded
// to bf16 as the A of P V, V the MN-major B of the tile S read K-major.  K
// and V are double-buffered: tile i + 1's cp.async copies issue right
// after tile i's S product and land while tile i computes.  The P V
// product is waited for at once: left running under the next tile's S
// product, as in dq, it made ptxas serialise every wgmma (the O rescale
// reads its accumulators), which cost more than the overlap gained.
//
// fp32 (flash_fwd_tf32_kernel): split TF32.  Every operand element a is
// split as a_hi = cvt.rna.tf32(a), a_lo = cvt.rna.tf32(a - a_hi), and each
// product a b runs as a_lo b_hi + a_hi b_lo + a_hi b_hi (k8 steps, the
// small terms first, a_lo b_lo dropped): each product keeps about 21 of
// fp32's 24 bits (2^-21 relative against FMA's 2^-24), the sums are fp32
// (the error model of dyad_gemm_tc.cuh's header; chip_smoke.py phase 3
// holds it against the plain fp32 version and a float64 one).  No wgmma
// accumulator lives past a tile: S's small terms sum apart from a_hi
// b_hi, and each tile's P V is a fresh product added into O as
// O = alpha O + P V with fp32 FMA (into O across the keys, the tensor
// cores' rounding of each addition put the error against float64 at 4x
// the plain fp32 version's).  Q and K are split in place as they land, each thread its
// own copied chunks; p is split in registers.  tf32 wgmma reads its shared
// operands K-major only, so V is staged as it lies ([keys][HD], by
// cp.async) and transposed in shared memory into V^T hi and lo ([HD][keys]),
// each 8 keys reordered so that the accumulator's columns 2t, 2t + 1 meet
// them as the A fragment's t, t + 4 (P's values are never reordered).
// Shared memory: Q, K and V^T, each hi and lo, and V's landing tile: seven
// [64][HD] fp32 tiles, 112 KB at HD 64 (two blocks an SM) and 224 KB at
// HD 128 (one); so one buffer: tile i + 1's V copies issue once tile i's
// V is transposed, its K copies once tile i's S product is done, and both
// land under the softmax and the P V product.
//
// The function is the FMA kernels': scores in fp32, masked scores kNegInf
// and masked p zeroed, p rounded to v's dtype before P V as the reference
// rounds it (bf16; a no-op in fp32) while l sums the unrounded p, the
// output acc / max(l, 1e-30) divided in fp32 and rounded once, and
// lse = m + log(max(l, 1e-30)): a fully-masked row gives o = 0 and lse
// below -1e29.
//
// ptxas (sm_90a, -O3): the bf16 kernel 160 registers at HD 128 (O 64, S
// 32, P 16), 126 at HD 64, no spill, no wgmma serialised; chip_smoke.py
// phase 2 prints both kernels' registers, spills and wgmma serialisation.
#pragma once

#include "flash_tc.cuh"

namespace repro {

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

namespace ffwd {

using namespace ftc;

constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
constexpr int fwd_smem() {
  // Q; two stages of K, V; alignment
  return 5 * kT * HD * 2 + 1024;
}
template <int HD>
constexpr int fwd32_smem() {
  // Q, K, V^T (hi and lo each), V's landing tile; alignment
  return 7 * kT * HD * 4 + 1024;
}

// the max of x over the 4 threads of a quad (the threads of one row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A block's place: (b, KV head, the row tile at r0), its offsets, and the
// key tiles [t_begin, t_begin + n) inside its causal/window band; the
// thread's rows (accumulator rows 16 warp + lane / 4 + 8 hh), their query
// positions, and m (log2e-scaled units) and l (the thread's partial sum
// over its columns)
struct Block {
  int b, kh, r0, SG, qo, ko, t_begin, n;
  float c;
  float m[2], l[2];
  int qpos[2];
  bool row_ok[2];
};

__device__ __forceinline__ Block block_of(const PrefillArgs& a) {
  Block k;
  k.b = blockIdx.x / a.K;
  k.kh = blockIdx.x % a.K;
  k.r0 = (gridDim.y - 1 - blockIdx.y) * kT;   // longest first
  k.SG = a.S * a.G;
  k.qo = a.q_off_vec ? a.q_off_vec[k.b] : a.q_off;
  k.ko = a.k_off_vec ? a.k_off_vec[k.b] : a.k_off;
  const int q_lo = k.qo + k.r0 / a.G;
  const int q_hi = k.qo + (min(k.r0 + kT, k.SG) - 1) / a.G;
  const int n_tiles = (a.T + kT - 1) / kT;
  int t_end = n_tiles;
  if (a.causal) {
    const int last = q_hi - k.ko;
    t_end = last < 0 ? 0 : min(n_tiles, last / kT + 1);
  }
  k.t_begin = 0;
  if (a.window >= 0) {
    const int fk = q_lo - a.window + 1 - k.ko;
    k.t_begin = fk <= 0 ? 0 : fk / kT;
  }
  k.n = max(0, t_end - k.t_begin);
  k.c = a.scale * kLog2e;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rg = k.r0 + 16 * warp + lane / 4 + 8 * hh;
    k.row_ok[hh] = rg < k.SG;
    k.qpos[hh] = k.qo + (k.row_ok[hh] ? rg / a.G : 0);
    k.m[hh] = kNegInf;
    k.l[hh] = 0.f;
  }
  return k;
}

// The online softmax of the key tile at t0 on its S accumulators
// (register 4 j + 2 hh + e: row hh, key t0 + 8 j + 2 (lane % 4) + e): the
// mask (none on a full tile), log2e scaling, m and l updated, and alpha,
// the factor of the O accumulators of the thread's rows; s becomes p
__device__ __forceinline__ void softmax_tile(const PrefillArgs& a, Block& k,
                                             float (&s)[32],
                                             float (&alpha)[2], int t0) {
  const int lane = threadIdx.x % 32;
  uint32_t live = 0xffffffffu;
  if (!tile_full(a, k.r0, t0, k.qo, k.ko)) {
    live = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tk = t0 + 8 * j + 2 * (lane % 4) + e;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          if (valid(a, k.row_ok[hh], tk < a.T, k.qpos[hh], k.ko + tk))
            live |= 1u << (4 * j + 2 * hh + e);
      }
  }
  float mt[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    s[x] = (live >> x) & 1 ? s[x] * k.c : kNegInf;
    mt[(x >> 1) & 1] = fmaxf(mt[(x >> 1) & 1], s[x]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float m_new = fmaxf(k.m[hh], quad_max(mt[hh]));
    alpha[hh] = ex2(k.m[hh] - m_new);
    k.m[hh] = m_new;
    k.l[hh] *= alpha[hh];
  }
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int hh = (x >> 1) & 1;
    s[x] = (live >> x) & 1 ? ex2(s[x] - k.m[hh]) : 0.f;
    k.l[hh] += s[x];
  }
}

// o / max(l, 1e-30) into the output (of O), and lse
template <int HD, typename O>
__device__ __forceinline__ void finish(const PrefillArgs& a, Block& k,
                                       float (&o)[HD / 2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) k.l[hh] = fmaxf(quad_sum(k.l[hh]), kTiny);
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o[x] = o[x] / k.l[(x >> 1) & 1];
  store_acc<HD, O>(o, a.h, [&](int hh) -> O* {
    const int rg = k.r0 + 16 * warp + lane / 4 + 8 * hh;
    if (rg >= k.SG) return nullptr;
    const int s = rg / a.G, g = rg - s * a.G;
    return static_cast<O*>(a.o) +
           ((((long long)k.b * a.S + s) * a.K + k.kh) * a.G + g) * a.h;
  });
  if (a.lse && lane % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rg = k.r0 + 16 * warp + lane / 4 + 8 * hh;
      // a row with no live key (l clamped to kTiny; a live row has
      // l >= 1) takes the reference's m + log(max(l, 1e-30)) in natural
      // units, m = -1e30: -1e30, the plain version's bits
      if (rg < k.SG)
        a.lse[((long long)k.b * a.K + k.kh) * k.SG + rg] =
            k.l[hh] > kTiny ? k.m[hh] * kLn2 + logf(k.l[hh])
                            : kNegInf + logf(kTiny);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kWG, 2)
flash_fwd_tc_kernel(PrefillArgs a, int flags) {
  constexpr int kTB = kT * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  auto stage = [&](int i) { return base + (1 + 2 * (i & 1)) * kTB; };
  Block k = block_of(a);

  // K (t = 0) or V (t = 1); selected, not branched on, so that the rolled
  // loop over the two holds one copy of the loader
  auto keys = [&](int t) {
    return t ? Pair{a.v, a.v_sb, a.v_st, a.v_sk, 0, (flags & kVecV) != 0}
             : Pair{a.k, a.k_sb, a.k_st, a.k_sk, 0, (flags & kVecK) != 0};
  };
  auto issue = [&](int i) {
    const int k0 = (k.t_begin + i) * kT;
#pragma unroll 1
    for (int t = 0; t < 2; ++t)
      load_keys<HD>(stage(i) + t * kTB, keys(t), a, k.b, k.kh, k0);
  };

  if (k.n > 0) {
    load_fold<HD>(sq, Pair{a.q, a.q_sb, a.q_ss, a.q_sk, a.q_sg,
                           (flags & kVecQ) != 0},
                  flags, a, k.b, k.kh, k.r0);
    issue(0);
  }
  tc::cp_async_commit();

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  tc::fence_acc(o);

  for (int i = 0; i < k.n; ++i) {
    landed();
    const int t0 = (k.t_begin + i) * kT;
    const uint32_t sk = stage(i), sv = sk + kTB;

    float s[32];
    wg_fence();
    mma_ss<HD>(s, sq, sk);   // S: rows x keys
    wg_commit();
    // tile i + 1's copies issue while the tensor cores run, into the slot
    // of tile i - 1, whose products every warp finished before landed()
    if (i + 1 < k.n) issue(i + 1);
    tc::cp_async_commit();
    wg_wait();
    tc::fence_acc(s);
    tc::fence_acc(o);
    float alpha[2];
    softmax_tile(a, k, s, alpha, t0);
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
    tc::fence_acc(o);   // the rescale before wgmma.fence, as wgmma needs

    uint32_t pa[16];
    to_a(s, pa);
    wg_fence();
    mma_rs<HD>(o, pa, sv);   // O += P V
    // waited for here, not under the next tile's S product: ptxas cannot
    // tell that the rescale above reads O only after such a product is
    // done, and would serialise every wgmma of the kernel
    wg_commit_wait();
  }
  tc::cp_async_wait<0>();
  tc::fence_acc(o);
  finish<HD, __nv_bfloat16>(a, k, o);
}

template <int HD>
__global__ void __launch_bounds__(kWG, HD == 64 ? 2 : 1)
flash_fwd_tf32_kernel(PrefillArgs a, int flags) {
  constexpr int kTB = kT * HD * 4;   // one [64][HD] fp32 tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_hi = base, q_lo = q_hi + kTB, k_hi = q_lo + kTB,
                 k_lo = k_hi + kTB, v_raw = k_lo + kTB, vt_hi = v_raw + kTB,
                 vt_lo = vt_hi + kTB;
  Block k = block_of(a);

  const Pair kp{a.k, a.k_sb, a.k_st, a.k_sk, 0, (flags & kVecK) != 0};
  const Pair vp{a.v, a.v_sb, a.v_st, a.v_sk, 0, (flags & kVecV) != 0};
  auto issue = [&](uint32_t tile, const Pair& src, int i) {
    load_keys<HD, uint32_t>(tile, src, a, k.b, k.kh, (k.t_begin + i) * kT);
    tc::cp_async_commit();
  };
  if (k.n > 0) {
    load_fold<HD, uint32_t>(q_hi, Pair{a.q, a.q_sb, a.q_ss, a.q_sk, a.q_sg,
                                       (flags & kVecQ) != 0},
                            flags, a, k.b, k.kh, k.r0);
    issue(k_hi, kp, 0);
    issue(v_raw, vp, 0);
  }

  float o[HD / 2];   // not a wgmma accumulator: the products' sums
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  for (int i = 0; i < k.n; ++i) {
    const int t0 = (k.t_begin + i) * kT;
    // this thread's copies of the tile landed: its Q (first tile) and K
    // chunks split in place; then everyone's V rows, transposed and split
    tc::cp_async_wait<0>();
    if (i == 0) split_tile<HD>(q_hi, q_lo);
    split_tile<HD>(k_hi, k_lo);
    __syncthreads();
    transpose_v<HD>(v_raw, vt_hi, vt_lo);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // V's landing tile is free: tile i + 1's V rows land under this
    // tile's products
    if (i + 1 < k.n) issue(v_raw, vp, i + 1);

    float s[32], small[32];
    wg_fence();
    mma_ss32<HD>(s, small, q_hi, q_lo, k_hi, k_lo);   // S: rows x keys
    wg_commit_wait();
    tc::fence_acc(s);
    tc::fence_acc(small);
    // K is free once the S product is done (the warpgroup's one wgmma)
    if (i + 1 < k.n) issue(k_hi, kp, i + 1);
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] += small[x];
    float alpha[2];
    softmax_tile(a, k, s, alpha, t0);

    // O = alpha O + P V: each 64 columns of h a fresh product of the
    // tile's 24 wgmma, added with fp32 FMA (rounded to nearest), so no
    // accumulator takes the tensor cores' additions over all the keys
    uint32_t ph[32], pl[32];
    to_a32(s, ph, pl);
#pragma unroll
    for (int half = 0; half < HD / 64; ++half) {
      float pv[32];
      wg_fence();
      mma_rs32<HD>(pv, ph, pl, vt_hi + half * 8192, vt_lo + half * 8192);
      wg_commit_wait();
      tc::fence_acc(pv);
#pragma unroll
      for (int x = 0; x < 32; ++x)
        o[32 * half + x] = fmaf(o[32 * half + x], alpha[(x >> 1) & 1], pv[x]);
    }
  }
  tc::cp_async_wait<0>();
  finish<HD, float>(a, k, o);
}

// T: the operand type (bf16 or fp32)
template <typename T, int HD>
cudaError_t launch(const PrefillArgs& a, cudaStream_t stream) {
  constexpr bool kF = sizeof(T) == 4;
  constexpr int epc = 16 / (int)sizeof(T);
  using E = std::conditional_t<kF, uint32_t, unsigned short>;
  const int flags =
      (vec_ok(a.q, a.q_sb, a.q_ss, a.q_sk, a.q_sg, epc) ? kVecQ : 0) |
      (vec_ok(a.k, a.k_sb, a.k_st, a.k_sk, 0, epc) ? kVecK : 0) |
      (vec_ok(a.v, a.v_sb, a.v_st, a.v_sk, 0, epc) ? kVecV : 0) |
      (kRpi<HD, E> % a.G == 0 ? kFoldStep : 0);
  constexpr int bytes = kF ? fwd32_smem<HD>() : fwd_smem<HD>();
  auto kernel = kF ? flash_fwd_tf32_kernel<HD> : flash_fwd_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)a.B * a.K, (a.S * a.G + kT - 1) / kT);
  kernel<<<grid, kWG, bytes, stream>>>(a, flags);
  return cudaGetLastError();
}

}  // namespace ffwd
}  // namespace repro
