// The bf16 route of flash_prefill (flash_prefill.cu) on the tensor cores:
// the same function as the fp32 FMA kernel there, through the same
// PrefillArgs, with both products a wgmma of bf16 operands into fp32
// accumulators.
//
// Replaces, for bf16 on this card, the TPU kernel
// src/repro/kernels/flash_attn.py: flash_prefill (_prefill_kernel in
// _prefill_impl).
//
// What bounds it on the H100: at Qwen3-0.6B's training shape (B 8, S 512,
// 8 KV heads x G 2, h 128, causal) a call moves about 50 MB (0.015 ms) and
// does 8.6 GFLOP (0.009 ms at 989 TFLOP/s): bytes, closely followed by the
// products.  The FMA kernel ran it on fp32 FMA over bf16 widened in shared
// memory, slower than its plain torch version.  The design is the dq
// kernel of flash_bwd_tc.cuh with dP and dS replaced by the online
// softmax, on the pieces of flash_tc.cuh:
//
// - One warpgroup (128 threads) a block, two blocks an SM, a block per
//   (b, KV head, 64 folded rows r = s * G + g).  Q [64][HD] stays in shared
//   memory; the block walks the 64-key tiles of its causal/window band.
//   The last row tiles of a causal band are the longest and come first.
// - S = Q K^T (m64n64k16, both K-major), then the online softmax on the
//   accumulator registers: a thread holds 16 scores of each of 2 rows, the
//   row max is 2 quad shuffles, and alpha rescales the thread's O
//   accumulators of those rows.  The row sum l stays a per-thread partial
//   until the end.  A tile whose pairs are all valid takes no mask test.
// - O += P V (m64nHDk16): p rounded to bf16 in registers as wgmma's A, V
//   the MN-major B of the tile S read K-major.  P never touches shared
//   memory.
// - K and V are double-buffered: tile i + 1's cp.async copies issue right
//   after tile i's S product and land while tile i computes.  The P V
//   product is waited for at once: left running under the next tile's S
//   product, as in dq, it made ptxas serialise every wgmma (the O rescale
//   reads its accumulators), which cost more than the overlap gained.
// - Scores go to exp as ex2.approx on log2e-scaled values (flushing
//   results below 2^-126 to zero); m is kept in that scale, and lse is
//   converted back to the natural log.
//
// The function is the FMA kernel's: scores in fp32 from bf16 products,
// masked scores kNegInf and masked p zeroed, p rounded to bf16 before P V
// as the reference rounds it to v's dtype while l sums the unrounded p,
// the output acc / max(l, 1e-30) divided in fp32 and rounded once, and
// lse = m + log(max(l, 1e-30)): a fully-masked row gives o = 0 and lse
// below -1e29.
//
// ptxas (sm_90a, -O3): 160 registers at HD 128 (O 64, S 32, P 16), 126 at
// HD 64, no spill, no wgmma serialised (chip_smoke.py phase 2 prints
// them).
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

// the max of x over the 4 threads of a quad (the threads of one row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
__global__ void __launch_bounds__(kWG, 2)
flash_fwd_tc_kernel(PrefillArgs a, int flags) {
  constexpr int kTB = kT * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;
  auto stage = [&](int i) { return base + (1 + 2 * (i & 1)) * kTB; };

  const int b = blockIdx.x / a.K, kh = blockIdx.x % a.K;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kT;   // longest first
  const int SG = a.S * a.G;
  const int qo = a.q_off_vec ? a.q_off_vec[b] : a.q_off;
  const int ko = a.k_off_vec ? a.k_off_vec[b] : a.k_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // key tiles inside the (causal, window) band of this row tile
  const int q_lo = qo + r0 / a.G;
  const int q_hi = qo + (min(r0 + kT, SG) - 1) / a.G;
  const int n_tiles = (a.T + kT - 1) / kT;
  int t_end = n_tiles;
  if (a.causal) {
    const int last = q_hi - ko;
    t_end = last < 0 ? 0 : min(n_tiles, last / kT + 1);
  }
  int t_begin = 0;
  if (a.window >= 0) {
    const int fk = q_lo - a.window + 1 - ko;
    t_begin = fk <= 0 ? 0 : fk / kT;
  }
  const int n = max(0, t_end - t_begin);

  // K (t = 0) or V (t = 1); selected, not branched on, so that the rolled
  // loop over the two holds one copy of the loader
  auto keys = [&](int t) {
    return t ? Pair{a.v, a.v_sb, a.v_st, a.v_sk, 0, (flags & kVecV) != 0}
             : Pair{a.k, a.k_sb, a.k_st, a.k_sk, 0, (flags & kVecK) != 0};
  };
  auto issue = [&](int i) {
    const int k0 = (t_begin + i) * kT;
#pragma unroll 1
    for (int t = 0; t < 2; ++t)
      load_keys<HD>(stage(i) + t * kTB, keys(t), a, b, kh, k0);
  };

  if (n > 0) {
    load_fold<HD>(sq, Pair{a.q, a.q_sb, a.q_ss, a.q_sk, a.q_sg,
                           (flags & kVecQ) != 0},
                  flags, a, b, kh, r0);
    issue(0);
  }
  tc::cp_async_commit();

  // the thread's rows: accumulator rows 16 warp + lane / 4 + 8 hh; m in
  // log2e-scaled units, l the thread's partial sum over its columns
  const float c = a.scale * kLog2e;
  float m[2], l[2];
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rg = r0 + 16 * warp + lane / 4 + 8 * hh;
    row_ok[hh] = rg < SG;
    qpos[hh] = qo + (row_ok[hh] ? rg / a.G : 0);
    m[hh] = kNegInf;
    l[hh] = 0.f;
  }

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  tc::fence_acc(o);

  for (int i = 0; i < n; ++i) {
    landed();
    const int t0 = (t_begin + i) * kT;
    const uint32_t sk = stage(i), sv = sk + kTB;

    float s[32];
    wg_fence();
    mma_ss<HD>(s, sq, sk);   // S: rows x keys
    wg_commit();
    // tile i + 1's copies issue while the tensor cores run, into the slot
    // of tile i - 1, whose products every warp finished before landed()
    if (i + 1 < n) issue(i + 1);
    tc::cp_async_commit();
    wg_wait();
    tc::fence_acc(s);
    tc::fence_acc(o);

    // register 4 j + 2 hh + e: row hh, key t0 + 8 j + 2 (lane % 4) + e
    uint32_t live = 0xffffffffu;
    if (!tile_full(a, r0, t0, qo, ko)) {
      live = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tk = t0 + 8 * j + 2 * (lane % 4) + e;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (valid(a, row_ok[hh], tk < a.T, qpos[hh], ko + tk))
              live |= 1u << (4 * j + 2 * hh + e);
        }
    }
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      s[x] = (live >> x) & 1 ? s[x] * c : kNegInf;
      mt[(x >> 1) & 1] = fmaxf(mt[(x >> 1) & 1], s[x]);
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(mt[hh]));
      alpha[hh] = ex2(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int hh = (x >> 1) & 1;
      s[x] = (live >> x) & 1 ? ex2(s[x] - m[hh]) : 0.f;
      l[hh] += s[x];
    }
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

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = fmaxf(quad_sum(l[hh]), kTiny);
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o[x] = o[x] / l[(x >> 1) & 1];
  store_acc<HD>(o, a.h, [&](int hh) -> __nv_bfloat16* {
    const int rg = r0 + 16 * warp + lane / 4 + 8 * hh;
    if (rg >= SG) return nullptr;
    const int s = rg / a.G, g = rg - s * a.G;
    return static_cast<__nv_bfloat16*>(a.o) +
           ((((long long)b * a.S + s) * a.K + kh) * a.G + g) * a.h;
  });
  if (a.lse && lane % 4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rg = r0 + 16 * warp + lane / 4 + 8 * hh;
      // a row with no live key (l clamped to kTiny; a live row has
      // l >= 1) takes the reference's m + log(max(l, 1e-30)) in natural
      // units, m = -1e30: -1e30, the plain version's bits
      if (rg < SG)
        a.lse[((long long)b * a.K + kh) * SG + rg] =
            l[hh] > kTiny ? m[hh] * kLn2 + logf(l[hh])
                          : kNegInf + logf(kTiny);
    }
  }
}

template <int HD>
cudaError_t launch(const PrefillArgs& a, cudaStream_t stream) {
  const int flags =
      (vec_ok(a.q, a.q_sb, a.q_ss, a.q_sk, a.q_sg) ? kVecQ : 0) |
      (vec_ok(a.k, a.k_sb, a.k_st, a.k_sk, 0) ? kVecK : 0) |
      (vec_ok(a.v, a.v_sb, a.v_st, a.v_sk, 0) ? kVecV : 0) |
      (kRpi<HD> % a.G == 0 ? kFoldStep : 0);
  constexpr int bytes = fwd_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)a.B * a.K, (a.S * a.G + kT - 1) / kT);
  flash_fwd_tc_kernel<HD><<<grid, kWG, bytes, stream>>>(a, flags);
  return cudaGetLastError();
}

}  // namespace ffwd
}  // namespace repro
