// flash_prefill_grads (flash_bwd.cu) on the tensor cores, both operand
// types through the same BwdArgs: bf16 as wgmma products of bf16
// operands, fp32 as split TF32 (3xTF32) wgmma products, both into fp32
// accumulators, at any h <= 128 (padded to HD 64 or 128).
//
// Replaces, on this card, the TPU kernel
// src/repro/kernels/flash_attn.py: flash_prefill_grads (_dkv_kernel in
// _dkv_impl, _dq_kernel in _dq_impl), and keeps its two-kernel split:
// dk/dv first, then dq, no atomics, so every run gives the same bits.
//
// What bounds it on the H100: at Qwen3-0.6B's training shape (B 8, S 512,
// 8 KV heads x G 2, h 128, causal, bf16) a call moves about 101 MB (0.030
// ms) and does 21.5 GFLOP of unique products (0.022 ms at 989 TFLOP/s), 32
// GFLOP with S and dP recomputed in both kernels.  At OPT-125m's (B 8,
// S 512, 12 heads of 64, causal, fp32) it does 8.07 GFLOP of unique
// products on about 50 MB: 0.049 ms as three TF32 products at 495
// TFLOP/s, operations.  The FMA kernels ran bf16 at about 8 TFLOP/s, every
// product on fp32 FMA over bf16 widened in shared memory, and fp32 in
// 0.81 ms.
//
// bf16 (flash_dkv_tc_kernel, flash_dq_tc_kernel):
//
// - One warpgroup (128 threads) a block, two blocks an SM.  Every tile is
//   [64][HD] bf16 (HD 64 or 128, the lanes past h zero on load and never
//   stored), kept as HD / 64 sub-tiles of [64][64] in the 128-byte swizzle
//   of dyad_gemm_tc.cuh.  That one layout is K-major along h (the A or B
//   of a product that sums over h) and MN-major along h (the B of one that
//   sums over the tile's rows), so no tile is staged twice.
// - dk/dv: a block per (b, KV head, 64 keys) keeps K and V and walks the
//   64-row tiles of the folded rows r = s * G + g in its causal/window band
//   (dk and dv sum over G in the block): S^T = K Q^T and dP^T = V dO^T
//   (m64n64k16, keys as M), then p = exp(S^T scale - lse) and
//   ds = p (dP^T - delta) scale in the accumulator registers, zero off the
//   mask (flash_bwd.cu's contract; no mask test on a tile whose pairs are
//   all valid), rounded to bf16 in registers and used as wgmma's
//   A: dV += P^T dO and dK += dS^T Q (m64nHDk16, dO and Q MN-major from
//   the tiles the first products read K-major).  The accumulator layout of
//   an m64 product is the A-fragment layout of the next one, so P and dS
//   never touch shared memory.  The key tiles of a causal band's start are
//   the longest: they are the first blocks of the grid.
// - dq: a block per (b, KV head, 64 rows) keeps Q and dO and walks the key
//   tiles of its band: S = Q K^T, dP = dO V^T, ds in registers, then
//   dQ += dS K (K MN-major from the tile S read K-major).  The last row
//   tiles of a causal band are the longest and come first.
// - The walked tiles (Q and dO, or K and V) are double-buffered: tile
//   i + 1's cp.async copies (16 bytes each) issue right after tile i's
//   first products, and land while tile i computes.  In dq, tile i's dQ
//   product also runs on while tile i + 1's first products issue.  A row
//   of the fold is a run of h elements; G rows are neighbours at stride
//   q_sg, then the next s.  An operand whose pointer or strides are off 16
//   bytes is staged element by element.
// - Code size: the loaders stay rolled but for their cp.async route, one
//   copy for each pair of operands.  Fully unrolled, they more than
//   doubled both kernels' SASS, which cost most of the first version's
//   time on the card.
// - p and ds are rounded to bf16 before their products, as the reference
//   rounds them to the operand type; the sums are fp32, the outputs rounded
//   once.  exp is ex2.approx (flushing results below 2^-126 to zero).
//
// fp32 (flash_dkv_tf32_kernel, flash_dq_tf32_kernel): the same function,
// blocks, walks and bands, every product in split TF32 as in the fp32
// forward (flash_fwd_tc.cuh): a_hi = cvt.rna.tf32(a), a_lo =
// cvt.rna.tf32(a - a_hi), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi (k8
// steps, small terms first, a_lo b_lo dropped), each product good to about
// 2^-21 relative.  What the bf16 design cannot keep, and what this one does
// instead:
//
// - tf32 wgmma reads its shared operands K-major only, so the products
//   that sum over a walked tile's rows (dV += P^T dO, dK += dS^T Q) or
//   keys (dQ += dS K) cannot read dO, Q or K as they lie.  They run
//   transposed: dV^T += dO^T P, dK^T += Q^T dS and dQ^T += K^T dS^T (h as
//   M, 64 a product), with A, the walked or kept tile transposed, read
//   from its split tiles into registers as it lies (frags_t), and B, P^T,
//   dS^T or dS, stored by the S and dP accumulators into shared memory
//   K-major and split (store_split).  So no tile is transposed in shared
//   memory, no key order needs undoing (the register A is read in its own
//   layout), and the outputs are stored from the transposed accumulators
//   (h contiguous along a quad's lanes).
// - Sums: S and dP take their small terms apart from a_hi b_hi (as the
//   forward's S); each tile's dV, dK and dQ products go into a fresh
//   partial of 3 K / 8 wgmma, added into the fp32 sums with fp32 adds, so
//   no accumulator takes the tensor cores' additions over a whole walk
//   (which put the forward's error at 4x the plain fp32 version's).
// - Registers: dK and dV (HD / 2 each, not wgmma accumulators), S, dP and
//   their small terms (16 each), or a partial (32) and its fragments (32).
// - Blocks: the walked tiles are 32 rows (dk/dv) or keys (dq); tile
//   i + 1's copies issue once every warp is done with tile i, and land in
//   its tiles, where each thread splits its own chunks in place.  The
//   tensor cores then idle in every block between products (the waits,
//   the softmax, the stores of P and dS, one warpgroup's work), so a second
//   block an SM, not a second buffer, is what keeps them fed: at HD 64 both
//   kernels take 113 KB of shared memory, two blocks an SM (209 KB at HD
//   128, one).  dq: Q and dO kept, hi and lo, [64][HD] each; K and V
//   walked, [32][HD]; dS, [64][32].  dk/dv: K and V kept, Q and dO walked,
//   and P^T and dS^T in one pair of [64][32] tiles in turn (dS^T stored
//   once the dV product has read P^T), each thread loading its rows' lse
//   and delta from device memory under the S products.  (On the card this
//   beat one block an SM with 64-row walks and the next tile landing under
//   the current one.)
//
// The tile layout, the loaders and the products they share with the
// forward are in flash_tc.cuh.  Registers (ptxas, sm_90a): see the header
// note of flash_bwd.cu.
#pragma once

#include "flash_tc.cuh"

namespace repro {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  const int* q_off_vec;
  const int* k_off_vec;
  int q_off, k_off;
  int B, S, T, K, G, h;
  long long q_sb, q_ss, q_sk, q_sg;
  long long do_sb, do_ss, do_sk, do_sg;
  long long k_sb, k_st, k_sk;
  long long v_sb, v_st, v_sk;
  int causal, window;
  float scale;
};

namespace fbwd {

using namespace ftc;

// per walked row tile of dk/dv: lse, delta (fp32) and the query position
// (int) of its 64 rows
constexpr int kStatBytes = 3 * kT * 4;

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// Operand t of a kernel's pair, t = 0 or 1: q and do (rows), k and v
// (keys).  Selected, not branched on, so that a rolled loop over the pair
// holds one copy of its loader.
__device__ __forceinline__ Pair rows_of(const BwdArgs& a, int t, int flags) {
  return t ? Pair{a.dout, a.do_sb, a.do_ss, a.do_sk, a.do_sg,
                  (flags & kVecDo) != 0}
           : Pair{a.q, a.q_sb, a.q_ss, a.q_sk, a.q_sg, (flags & kVecQ) != 0};
}
__device__ __forceinline__ Pair keys_of(const BwdArgs& a, int t, int flags) {
  return t ? Pair{a.v, a.v_sb, a.v_st, a.v_sk, 0, (flags & kVecV) != 0}
           : Pair{a.k, a.k_sb, a.k_st, a.k_sk, 0, (flags & kVecK) != 0};
}

// p (in s) and ds (in dp) of one accumulator element
__device__ __forceinline__ void prob(const BwdArgs& a, bool ok, float lse2,
                                     float delta, float& s, float& dp) {
  const float p = ok ? ex2(fmaf(s, a.scale * kLog2e, -lse2)) : 0.f;
  dp = p * (dp - delta) * a.scale;
  s = p;
}

// S = A B^T and dP = A2 B2^T over h, both tiles K-major
template <int HD>
__device__ __forceinline__ void mma_ss2(float (&s)[32], float (&dp)[32],
                                        uint32_t a1, uint32_t b1,
                                        uint32_t a2, uint32_t b2) {
  mma_ss<HD>(s, a1, b1);
  mma_ss<HD>(dp, a2, b2);
}

template <int HD>
constexpr int dkv_smem() {
  // K, V; two stages of Q, dO; two stages of row stats; alignment
  return 6 * kT * HD * 2 + 2 * kStatBytes + 1024;
}
template <int HD>
constexpr int dq_smem() {
  // Q, dO; two stages of K, V; alignment
  return 6 * kT * HD * 2 + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kWG, 2)
flash_dkv_tc_kernel(BwdArgs a, int flags) {
  constexpr int kTB = kT * HD * 2;   // bytes of a tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sk = base, sv = base + kTB;
  auto stage = [&](int i) { return base + (2 + 2 * (i & 1)) * kTB; };
  const uint32_t stats0 = base + 6 * kTB;
  auto stats_ptr = [&](int i) {
    return smem_raw + (stats0 - raw) + (i & 1) * kStatBytes;
  };

  const int b = blockIdx.x / a.K, kh = blockIdx.x % a.K;
  const int t0 = blockIdx.y * kT;
  const int SG = a.S * a.G;
  const int qo = a.q_off_vec ? a.q_off_vec[b] : a.q_off;
  const int ko = a.k_off_vec ? a.k_off_vec[b] : a.k_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // row tiles inside the (causal, window) band of this key tile
  const int kpos_lo = ko + t0;
  const int kpos_hi = ko + min(t0 + kT, a.T) - 1;
  int s_lo = 0, s_hi = a.S;
  if (a.causal) s_lo = max(0, kpos_lo - qo);
  if (a.window >= 0) s_hi = max(0, min(a.S, kpos_hi + a.window - qo));
  const int first = (s_lo * a.G / kT) * kT, row_hi = s_hi * a.G;
  const int n = row_hi > first ? (row_hi - first + kT - 1) / kT : 0;

  // row tile i: Q, dO, and its rows' lse, delta and query position
  auto issue = [&](int i) {
    const int r0 = first + i * kT;
#pragma unroll 1
    for (int t = 0; t < 2; ++t)
      load_fold<HD>(stage(i) + t * kTB, rows_of(a, t, flags), flags, a, b,
                    kh, r0);
    if (threadIdx.x < kT) {
      const int rg = r0 + threadIdx.x;
      const long long at = ((long long)b * a.K + kh) * SG + rg;
      const uint32_t st = stats0 + (i & 1) * kStatBytes + 4 * threadIdx.x;
      const bool in = rg < SG;
      cp_async4(st, in ? a.lse + at : a.lse, in ? 4 : 0);
      cp_async4(st + 4 * kT, in ? a.delta + at : a.delta, in ? 4 : 0);
      const int qpos = qo + (in ? rg / a.G : 0);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(st + 8 * kT),
                   "r"(qpos));
    }
  };

#pragma unroll 1
  for (int t = 0; t < 2; ++t)
    load_keys<HD>(sk + t * kTB, keys_of(a, t, flags), a, b, kh, t0);
  if (n > 0) issue(0);
  tc::cp_async_commit();

  // the thread's keys: accumulator rows 16 warp + lane / 4 + 8 hh
  int kpos[2];
  bool key_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int tk = t0 + 16 * warp + lane / 4 + 8 * hh;
    kpos[hh] = ko + tk;
    key_ok[hh] = tk < a.T;
  }

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  tc::fence_acc(dk);
  tc::fence_acc(dv);

  for (int i = 0; i < n; ++i) {
    landed();   // tile i is in, and every warp is done with tile i - 1
    const int r0 = first + i * kT;
    const uint32_t sq = stage(i), sdo = sq + kTB;

    float s[32], dp[32];
    wg_fence();
    mma_ss2<HD>(s, dp, sk, sq, sv, sdo);   // S^T, dP^T: keys x rows
    // tile i + 1's copies issue while the tensor cores run
    wg_commit();
    if (i + 1 < n) issue(i + 1);
    tc::cp_async_commit();
    wg_wait();
    tc::fence_acc(s);
    tc::fence_acc(dp);

    const unsigned char* st = stats_ptr(i);
    const float* lse = reinterpret_cast<const float*>(st);
    const float* delta = lse + kT;
    const int* qpos = reinterpret_cast<const int*>(st) + 2 * kT;
    const bool full = tile_full(a, r0, t0, qo, ko);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * (lane % 4) + e;   // row r0 + col
        const float lse2 = lse[col] * kLog2e, dl = delta[col];
        const int qp = qpos[col];
        const bool row_ok = r0 + col < SG;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          const bool ok =
              full || valid(a, row_ok, key_ok[hh], qp, kpos[hh]);
          prob(a, ok, lse2, dl, s[x], dp[x]);
        }
      }
    }
    uint32_t pa[16], da[16];
    to_a(s, pa);
    to_a(dp, da);
    wg_fence();
    mma_rs<HD>(dv, pa, sdo);   // dV += P^T dO
    mma_rs<HD>(dk, da, sq);    // dK += dS^T Q
    wg_commit_wait();
  }
  tc::cp_async_wait<0>();
  tc::fence_acc(dk);
  tc::fence_acc(dv);

  const int h = a.h;
  auto out = [&](void* base_ptr, int hh) -> __nv_bfloat16* {
    const int tk = t0 + 16 * warp + lane / 4 + 8 * hh;
    if (tk >= a.T) return nullptr;
    return static_cast<__nv_bfloat16*>(base_ptr) +
           (((long long)b * a.T + tk) * a.K + kh) * h;
  };
  store_acc<HD>(dk, h, [&](int hh) { return out(a.dk, hh); });
  store_acc<HD>(dv, h, [&](int hh) { return out(a.dv, hh); });
}

template <int HD>
__global__ void __launch_bounds__(kWG, 2)
flash_dq_tc_kernel(BwdArgs a, int flags) {
  constexpr int kTB = kT * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sdo = base + kTB;
  auto stage = [&](int i) { return base + (2 + 2 * (i & 1)) * kTB; };

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

  auto issue = [&](int i) {
    const int k0 = (t_begin + i) * kT;
#pragma unroll 1
    for (int t = 0; t < 2; ++t)
      load_keys<HD>(stage(i) + t * kTB, keys_of(a, t, flags), a, b, kh, k0);
  };

  if (n > 0) {
#pragma unroll 1
    for (int t = 0; t < 2; ++t)
      load_fold<HD>(sq + t * kTB, rows_of(a, t, flags), flags, a, b, kh, r0);
    issue(0);
  }
  tc::cp_async_commit();

  // the thread's rows: accumulator rows 16 warp + lane / 4 + 8 hh
  float lse2[2], dl[2];
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rg = r0 + 16 * warp + lane / 4 + 8 * hh;
    row_ok[hh] = rg < SG;
    const long long at = ((long long)b * a.K + kh) * SG + rg;
    lse2[hh] = row_ok[hh] ? a.lse[at] * kLog2e : 0.f;
    dl[hh] = row_ok[hh] ? a.delta[at] : 0.f;
    qpos[hh] = qo + (row_ok[hh] ? rg / a.G : 0);
  }

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  tc::fence_acc(dq);

  for (int i = 0; i < n; ++i) {
    landed();
    const int t0 = (t_begin + i) * kT;
    const uint32_t sk = stage(i), sv = sk + kTB;

    float s[32], dp[32];
    wg_fence();
    mma_ss2<HD>(s, dp, sq, sk, sdo, sv);   // S, dP: rows x keys
    wg_commit();
    // tile i - 1's dQ product (the group before) is done in every warp:
    // its K tile's slot takes tile i + 1, copied while the tensor cores run
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    __syncthreads();
    if (i + 1 < n) issue(i + 1);
    tc::cp_async_commit();
    wg_wait();
    tc::fence_acc(s);
    tc::fence_acc(dp);

    const bool full = tile_full(a, r0, t0, qo, ko);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tk = t0 + 8 * j + 2 * (lane % 4) + e;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          const bool ok =
              full || valid(a, row_ok[hh], tk < a.T, qpos[hh], ko + tk);
          prob(a, ok, lse2[hh], dl[hh], s[x], dp[x]);
        }
      }
    }
    uint32_t da[16];
    to_a(dp, da);
    wg_fence();
    mma_rs<HD>(dq, da, sk);   // dQ += dS K
    wg_commit();
  }
  wg_wait();
  tc::cp_async_wait<0>();
  tc::fence_acc(dq);

  store_acc<HD>(dq, a.h, [&](int hh) -> __nv_bfloat16* {
    const int rg = r0 + 16 * warp + lane / 4 + 8 * hh;
    if (rg >= SG) return nullptr;
    const int s = rg / a.G, g = rg - s * a.G;
    return static_cast<__nv_bfloat16*>(a.dq) +
           ((((long long)b * a.S + s) * a.K + kh) * a.G + g) * a.h;
  });
}

template <int HD>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const int flags =
      (vec_ok(a.q, a.q_sb, a.q_ss, a.q_sk, a.q_sg) ? kVecQ : 0) |
      (vec_ok(a.dout, a.do_sb, a.do_ss, a.do_sk, a.do_sg) ? kVecDo : 0) |
      (vec_ok(a.k, a.k_sb, a.k_st, a.k_sk, 0) ? kVecK : 0) |
      (vec_ok(a.v, a.v_sb, a.v_st, a.v_sk, 0) ? kVecV : 0) |
      (kRpi<HD> % a.G == 0 ? kFoldStep : 0);
  constexpr int dkv_bytes = dkv_smem<HD>(), dq_bytes = dq_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dq_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  const unsigned bk = (unsigned)a.B * a.K;
  dim3 dkv_grid(bk, (a.T + kT - 1) / kT);
  flash_dkv_tc_kernel<HD><<<dkv_grid, kWG, dkv_bytes, stream>>>(a, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 dq_grid(bk, (a.S * a.G + kT - 1) / kT);
  flash_dq_tc_kernel<HD><<<dq_grid, kWG, dq_bytes, stream>>>(a, flags);
  return cudaGetLastError();
}

// ---- fp32: split TF32 ------------------------------------------------------

// the rows (dk/dv) or keys (dq) of a walked tile
constexpr int kWT = 32;

// either kernel's shared memory: two tiles kept ([64][HD]: K, V or Q, dO)
// and two walked ([32][HD]), hi and lo each; one [64][32] pair, hi and lo,
// for P^T then dS^T, or for dS; alignment.  The same for both kernels: at
// HD 64 two blocks an SM
template <int HD>
constexpr int bwd32_smem() {
  return 4 * kT * HD * 4 + 4 * kWT * HD * 4 + 2 * kT * kWT * 4 + 1024;
}

// The tf32 A fragments, hi and lo, of a product that sums over the ROWS
// rows of a [ROWS][HD] fp32 tile split into the tiles at hi and lo: A[m][k]
// = tile[k][col0 + m], m < 64, k < ROWS (the tile transposed, read as it
// lies).  k8 step s in [4 s .. 4 s + 3], element e at m = 16 warp +
// lane / 4 + 8 (e & 1), k = 8 s + lane % 4 + 4 (e >> 1): the m64nNk8 tf32
// A layout.
template <int ROWS>
__device__ __forceinline__ void frags_t(uint32_t hi, uint32_t lo, int col0,
                                       uint32_t (&fh)[ROWS / 2],
                                       uint32_t (&fl)[ROWS / 2]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < ROWS / 2; ++i) {
    const int s = i / 4, e = i % 4;
    const uint32_t off =
        toff<uint32_t, ROWS>(8 * s + lane % 4 + 4 * (e >> 1),
                             col0 + 16 * warp + lane / 4 + 8 * (e & 1));
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(fh[i]) : "r"(hi + off));
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(fl[i]) : "r"(lo + off));
  }
}

// D (64 x 64) = A B over K rows, a fresh product: A's fragments in
// registers (frags_t), B the [64][K] tile K-major (hi, lo); per k8 step
// a_lo b_hi, a_hi b_lo, then a_hi b_hi
template <int K>
__device__ __forceinline__ void mma_rs32k(float (&d)[32],
                                          const uint32_t (&fh)[K / 2],
                                          const uint32_t (&fl)[K / 2],
                                          uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int s = 0; s < K / 8; ++s) {
    const uint32_t ah[4] = {fh[4 * s], fh[4 * s + 1], fh[4 * s + 2],
                            fh[4 * s + 3]};
    const uint32_t al[4] = {fl[4 * s], fl[4 * s + 1], fl[4 * s + 2],
                            fl[4 * s + 3]};
    const uint64_t bh = desc_k(b_hi, s), bl = desc_k(b_lo, s);
    tc::wgmma_m64n64k8_tf32_rs(d, al, bh, s > 0);
    tc::wgmma_m64n64k8_tf32_rs(d, ah, bl);
    tc::wgmma_m64n64k8_tf32_rs(d, ah, bh);
  }
}

// A 64 x N accumulator (register 4 j + 2 hh + e: row 16 warp + lane / 4 +
// 8 hh, column 8 j + 2 (lane % 4) + e) into a [64][N] tile K-major along
// its columns, split: hi and lo
template <int N>
__device__ __forceinline__ void store_split(const float (&acc)[N / 2],
                                            uint32_t hi, uint32_t lo) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t off = toff<uint32_t>(16 * warp + lane / 4 + 8 * hh,
                                          8 * j + 2 * (lane % 4));
      uint32_t h0, l0, h1, l1;
      tc::split_tf32(acc[4 * j + 2 * hh], h0, l0);
      tc::split_tf32(acc[4 * j + 2 * hh + 1], h1, l1);
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(hi + off),
                   "r"(h0), "r"(h1));
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(lo + off),
                   "r"(l0), "r"(l1));
    }
}

// S (or S^T) and dP (or dP^T) of a tile pair, 64 x N, split TF32: the
// small terms of each summed apart from a_hi b_hi (as the forward's S),
// then added; A tiles [64][HD], B tiles [N][HD], hi and lo of each
template <int HD, int N>
__device__ __forceinline__ void scores32(float (&s)[N / 2],
                                         float (&dp)[N / 2], uint32_t a1,
                                         uint32_t a1_lo, uint32_t b1,
                                         uint32_t b1_lo, uint32_t a2,
                                         uint32_t a2_lo, uint32_t b2,
                                         uint32_t b2_lo) {
  float ss[N / 2], dps[N / 2];
  wg_fence();
  mma_ss32<HD, N>(s, ss, a1, a1_lo, b1, b1_lo);
  mma_ss32<HD, N>(dp, dps, a2, a2_lo, b2, b2_lo);
  wg_commit_wait();
  tc::fence_acc(s);
  tc::fence_acc(ss);
  tc::fence_acc(dp);
  tc::fence_acc(dps);
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    s[x] += ss[x];
    dp[x] += dps[x];
  }
}

// acc (HD / 2 fp32: HD / 64 sets of 32) += the product over K of A, the
// tile [K][HD] at a_hi, a_lo transposed, and B, the [64][K] tile at b_hi,
// b_lo: for each 64 columns of h a fresh product of 3 K / 8 wgmma, added
// with fp32 adds, so no accumulator takes the tensor cores' additions over
// the whole walk
template <int HD, int K>
__device__ __forceinline__ void add_product(float (&acc)[HD / 2],
                                            uint32_t a_hi, uint32_t a_lo,
                                            uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int hb = 0; hb < HD / 64; ++hb) {
    uint32_t fh[K / 2], fl[K / 2];
    frags_t<K>(a_hi, a_lo, 64 * hb, fh, fl);
    float part[32];
    wg_fence();
    mma_rs32k<K>(part, fh, fl, b_hi, b_lo);
    wg_commit_wait();
    tc::fence_acc(part);
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[32 * hb + x] += part[x];
  }
}

// a transposed accumulator, HD / 2 fp32 (h x 64 columns: register
// 32 hb + 4 j + 2 hh + e holds h 64 hb + 16 warp + lane / 4 + 8 hh, column
// 8 j + 2 (lane % 4) + e), into the (column, h) rows of an fp32 output:
// `dst(col)` the column's row, or null
template <int HD, typename F>
__device__ __forceinline__ void store_t(const float (&acc)[HD / 2], int h,
                                        F&& dst) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* row = dst(8 * j + 2 * (lane % 4) + e);
      if (!row) continue;
#pragma unroll
      for (int hb = 0; hb < HD / 64; ++hb)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int d = 64 * hb + 16 * warp + lane / 4 + 8 * hh;
          if (d < h) row[d] = acc[32 * hb + 4 * j + 2 * hh + e];
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(kWG,
                                  bwd32_smem<HD>() <= tc::kTwoPerSm ? 2 : 1)
flash_dkv_tf32_kernel(BwdArgs a, int flags) {
  constexpr int WT = kWT;
  constexpr int R = kT * HD * 4, W = WT * HD * 4, PB = kT * WT * 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_hi = base, k_lo = k_hi + R, v_hi = k_lo + R,
                 v_lo = v_hi + R;
  const uint32_t q_hi = v_lo + R, q_lo = q_hi + W, do_hi = q_lo + W,
                 do_lo = do_hi + W;
  // P^T, then dS^T over it
  const uint32_t p_hi = do_lo + W, p_lo = p_hi + PB;

  const int b = blockIdx.x / a.K, kh = blockIdx.x % a.K;
  const int t0 = blockIdx.y * kT;
  const int SG = a.S * a.G;
  const int qo = a.q_off_vec ? a.q_off_vec[b] : a.q_off;
  const int ko = a.k_off_vec ? a.k_off_vec[b] : a.k_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // row tiles inside the (causal, window) band of this key tile
  const int kpos_lo = ko + t0;
  const int kpos_hi = ko + min(t0 + kT, a.T) - 1;
  int s_lo = 0, s_hi = a.S;
  if (a.causal) s_lo = max(0, kpos_lo - qo);
  if (a.window >= 0) s_hi = max(0, min(a.S, kpos_hi + a.window - qo));
  const int first = (s_lo * a.G / WT) * WT, row_hi = s_hi * a.G;
  const int n = row_hi > first ? (row_hi - first + WT - 1) / WT : 0;

  // row tile i: Q and dO
  auto issue = [&](int i) {
    const int r0 = first + i * WT;
#pragma unroll 1
    for (int t = 0; t < 2; ++t)
      load_fold<HD, uint32_t, WT>(t ? do_hi : q_hi, rows_of(a, t, flags),
                                  flags, a, b, kh, r0);
    tc::cp_async_commit();
  };
  if (n > 0) {
#pragma unroll 1
    for (int t = 0; t < 2; ++t)
      load_keys<HD, uint32_t>(t ? v_hi : k_hi, keys_of(a, t, flags), a, b,
                              kh, t0);
    issue(0);
  }

  // the thread's keys: accumulator rows 16 warp + lane / 4 + 8 hh
  int kpos[2];
  bool key_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int tk = t0 + 16 * warp + lane / 4 + 8 * hh;
    kpos[hh] = ko + tk;
    key_ok[hh] = tk < a.T;
  }

  // dK^T, dV^T (h x keys): the sums of each tile's fresh products
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int r0 = first + i * WT;
    // this thread's copies of the tile landed: its K and V (first tile),
    // Q and dO chunks split; then everyone's, visible to wgmma
    tc::cp_async_wait<0>();
    if (i == 0) {
      split_tile<HD>(k_hi, k_lo);
      split_tile<HD>(v_hi, v_lo);
    }
    split_tile<HD, WT>(q_hi, q_lo);
    split_tile<HD, WT>(do_hi, do_lo);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // the lse and delta of the thread's rows (accumulator columns
    // 8 j + 2 (lane % 4) + e, x = 2 j + e), loaded under the products
    float lse[WT / 4], delta[WT / 4];
#pragma unroll
    for (int x = 0; x < WT / 4; ++x) {
      const int rg = r0 + 8 * (x / 2) + 2 * (lane % 4) + x % 2;
      const long long at = ((long long)b * a.K + kh) * SG + rg;
      lse[x] = rg < SG ? a.lse[at] : 0.f;
      delta[x] = rg < SG ? a.delta[at] : 0.f;
    }
    float s[WT / 2], dp[WT / 2];
    scores32<HD, WT>(s, dp, k_hi, k_lo, q_hi, q_lo, v_hi, v_lo, do_hi,
                     do_lo);   // S^T, dP^T: keys x rows

    const bool full = tile_full(a, r0, t0, qo, ko, WT, kT);
#pragma unroll
    for (int j = 0; j < WT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * (lane % 4) + e;   // row r0 + col
        const bool row_ok = r0 + col < SG;
        const float lse2 = lse[2 * j + e] * kLog2e, dl = delta[2 * j + e];
        const int qp = qo + (row_ok ? (r0 + col) / a.G : 0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          const bool ok =
              full || valid(a, row_ok, key_ok[hh], qp, kpos[hh]);
          prob(a, ok, lse2, dl, s[x], dp[x]);
        }
      }
    }
    store_split<WT>(s, p_hi, p_lo);   // P^T: keys x rows
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    add_product<HD, WT>(dv, do_hi, do_lo, p_hi, p_lo);   // dV^T += dO^T P
    // every warp is done with P^T: dS^T takes its tiles
    __syncthreads();
    store_split<WT>(dp, p_hi, p_lo);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    add_product<HD, WT>(dk, q_hi, q_lo, p_hi, p_lo);   // dK^T += Q^T dS
    // every warp is done with this tile's Q and dO: tile i + 1's copies
    // take their tiles
    __syncthreads();
    if (i + 1 < n) issue(i + 1);
  }
  tc::cp_async_wait<0>();

  auto out = [&](void* base_ptr, int col) -> float* {
    const int tk = t0 + col;
    if (tk >= a.T) return nullptr;
    return static_cast<float*>(base_ptr) +
           (((long long)b * a.T + tk) * a.K + kh) * a.h;
  };
  store_t<HD>(dk, a.h, [&](int col) { return out(a.dk, col); });
  store_t<HD>(dv, a.h, [&](int col) { return out(a.dv, col); });
}

template <int HD>
__global__ void __launch_bounds__(kWG,
                                  bwd32_smem<HD>() <= tc::kTwoPerSm ? 2 : 1)
flash_dq_tf32_kernel(BwdArgs a, int flags) {
  constexpr int WT = kWT;
  constexpr int R = kT * HD * 4, W = WT * HD * 4, PB = kT * WT * 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_hi = base, q_lo = q_hi + R, do_hi = q_lo + R,
                 do_lo = do_hi + R;
  const uint32_t k_hi = do_lo + R, k_lo = k_hi + W, v_hi = k_lo + W,
                 v_lo = v_hi + W;
  const uint32_t ds_hi = v_lo + W, ds_lo = ds_hi + PB;

  const int b = blockIdx.x / a.K, kh = blockIdx.x % a.K;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kT;   // longest first
  const int SG = a.S * a.G;
  const int qo = a.q_off_vec ? a.q_off_vec[b] : a.q_off;
  const int ko = a.k_off_vec ? a.k_off_vec[b] : a.k_off;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // key tiles inside the (causal, window) band of this row tile
  const int qp_lo = qo + r0 / a.G;
  const int qp_hi = qo + (min(r0 + kT, SG) - 1) / a.G;
  const int n_tiles = (a.T + WT - 1) / WT;
  int t_end = n_tiles;
  if (a.causal) {
    const int last = qp_hi - ko;
    t_end = last < 0 ? 0 : min(n_tiles, last / WT + 1);
  }
  int t_begin = 0;
  if (a.window >= 0) {
    const int fk = qp_lo - a.window + 1 - ko;
    t_begin = fk <= 0 ? 0 : fk / WT;
  }
  const int n = max(0, t_end - t_begin);

  auto issue = [&](int i) {
    const int k0 = (t_begin + i) * WT;
#pragma unroll 1
    for (int t = 0; t < 2; ++t)
      load_keys<HD, uint32_t, WT>(t ? v_hi : k_hi, keys_of(a, t, flags),
                                  a, b, kh, k0);
    tc::cp_async_commit();
  };
  if (n > 0) {
#pragma unroll 1
    for (int t = 0; t < 2; ++t)
      load_fold<HD, uint32_t>(t ? do_hi : q_hi, rows_of(a, t, flags), flags,
                              a, b, kh, r0);
    issue(0);
  }

  // the thread's rows: accumulator rows 16 warp + lane / 4 + 8 hh
  float lse2[2], dl[2];
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int rg = r0 + 16 * warp + lane / 4 + 8 * hh;
    row_ok[hh] = rg < SG;
    const long long at = ((long long)b * a.K + kh) * SG + rg;
    lse2[hh] = row_ok[hh] ? a.lse[at] * kLog2e : 0.f;
    dl[hh] = row_ok[hh] ? a.delta[at] : 0.f;
    qpos[hh] = qo + (row_ok[hh] ? rg / a.G : 0);
  }

  // dQ^T (h x rows): the sum of each tile's fresh products
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int t0 = (t_begin + i) * WT;
    tc::cp_async_wait<0>();
    if (i == 0) {
      split_tile<HD>(q_hi, q_lo);
      split_tile<HD>(do_hi, do_lo);
    }
    split_tile<HD, WT>(k_hi, k_lo);
    split_tile<HD, WT>(v_hi, v_lo);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    float s[WT / 2], dp[WT / 2];
    scores32<HD, WT>(s, dp, q_hi, q_lo, k_hi, k_lo, do_hi, do_lo, v_hi,
                     v_lo);   // S, dP: rows x keys

    const bool full = tile_full(a, r0, t0, qo, ko, kT, WT);
#pragma unroll
    for (int j = 0; j < WT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tk = t0 + 8 * j + 2 * (lane % 4) + e;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j + 2 * hh + e;
          const bool ok =
              full || valid(a, row_ok[hh], tk < a.T, qpos[hh], ko + tk);
          prob(a, ok, lse2[hh], dl[hh], s[x], dp[x]);
        }
      }
    }
    store_split<WT>(dp, ds_hi, ds_lo);   // dS: rows x keys
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    add_product<HD, WT>(dq, k_hi, k_lo, ds_hi, ds_lo);   // dQ^T += K^T dS^T
    // every warp is done with this tile's K: tile i + 1's copies take its
    // tiles
    __syncthreads();
    if (i + 1 < n) issue(i + 1);
  }
  tc::cp_async_wait<0>();

  store_t<HD>(dq, a.h, [&](int col) -> float* {
    const int rg = r0 + col;
    if (rg >= SG) return nullptr;
    const int s = rg / a.G, g = rg - s * a.G;
    return static_cast<float*>(a.dq) +
           ((((long long)b * a.S + s) * a.K + kh) * a.G + g) * a.h;
  });
}

template <int HD>
cudaError_t launch32(const BwdArgs& a, cudaStream_t stream) {
  const int flags =
      (vec_ok(a.q, a.q_sb, a.q_ss, a.q_sk, a.q_sg, 4) ? kVecQ : 0) |
      (vec_ok(a.dout, a.do_sb, a.do_ss, a.do_sk, a.do_sg, 4) ? kVecDo : 0) |
      (vec_ok(a.k, a.k_sb, a.k_st, a.k_sk, 0, 4) ? kVecK : 0) |
      (vec_ok(a.v, a.v_sb, a.v_st, a.v_sk, 0, 4) ? kVecV : 0) |
      (kRpi<HD, uint32_t> % a.G == 0 ? kFoldStep : 0);
  constexpr int bytes = bwd32_smem<HD>();
  static_assert(bytes <= 232448, "a block's shared memory on the H100");
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dq_tf32_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const unsigned bk = (unsigned)a.B * a.K;
  dim3 dkv_grid(bk, (a.T + kT - 1) / kT);
  flash_dkv_tf32_kernel<HD><<<dkv_grid, kWG, bytes, stream>>>(a, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 dq_grid(bk, (a.S * a.G + kT - 1) / kT);
  flash_dq_tf32_kernel<HD><<<dq_grid, kWG, bytes, stream>>>(a, flags);
  return cudaGetLastError();
}

}  // namespace fbwd
}  // namespace repro
