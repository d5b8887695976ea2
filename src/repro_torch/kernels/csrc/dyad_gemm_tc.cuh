// The tensor-core mainloop of the DYAD GEMMs (dyad_mm.cu and
// dyad_mm_two.cu past the decode rows, dyad_dgrad.cu, dyad_dgrad_fused.cu,
// dyad_wgrad.cu), through dyad_gemm.cuh's DyadGemmArgs:
//
//   C_c[g][r, j] = sum_{k in [k_begin, k_end)} A_c[g][r, k] * B_c[g][k, j]
//
// for two components c and n dyad blocks g, every operand read through its
// own (g, row, column) strides; split > 1 writes fp32 partials that
// gemm::dyad_gemm_reduce adds in split order; Fuse sums component 0's k
// range, then component 1's, into one accumulator.  The sums are fp32 and
// the output is rounded once.  Two operand types:
//
// - bf16 (every kernel above): one bf16 product per pair.
// - fp32, split TF32 (3xTF32; the forward of dyad_mm.cu, Fuse, and of
//   dyad_mm_two.cu, the components apart: both operands K-major): every
//   operand element a is split as a_hi = cvt.rna.tf32(a), a_lo =
//   cvt.rna.tf32(a - a_hi) (the difference is exact in fp32), and a
//   product a b becomes a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms
//   issued first, each a wgmma m64n128k8 tf32; a_lo b_lo is dropped.  Each
//   stage's 12 wgmma sum into a partial of their own, and the partials
//   are added into the fp32 accumulator with fp32 adds (rounded to
//   nearest): into one accumulator over all of k, the tensor cores'
//   additions made the error grow with k, to 6-14x the plain fp32
//   product's against float64 at OPT-125m's shapes on the card.  Error
//   model: a_hi + a_lo holds a to about 2^-22 relative, so each product
//   keeps about 21 of fp32's 24 bits (2^-21 relative against an FMA's
//   2^-24), and the sums are fp32.  chip_smoke.py phase 3 holds it against
//   the plain fp32 version and against a float64 product.  Bound: three
//   TF32 products at 495 TFLOP/s, 165 TFLOP/s of fp32 work, above the 67
//   TFLOP/s of fp32 FMA.
//
// Replaces, on this card, the TPU kernels src/repro/kernels/dyad_mm.py:
// dyad_mm_blocks (_dyad_kernel, Fuse), dyad_mm_blocks_two
// (_dyad_kernel_two), dyad_mm_dgrad_two (_dgrad_kernel_two), dyad_mm_dgrad
// (_dgrad_kernel, Fuse) and dyad_mm_wgrad (_wgrad_kernel):
// MXU products over VMEM tiles with the reduction carried across the
// sequential grid axis.
//
// What bounds it on the H100: the tensor cores (989 TFLOP/s bf16).  A call
// at Qwen3-0.6B's training rows does 12.9 GFLOP on 25-35 MB: 0.013 ms of
// operations against 0.008-0.010 ms of bytes.  The FMA tile GEMM this
// replaced ran such a call at 12-24 TFLOP/s, with the bf16 operands widened
// to fp32 in shared memory and a barrier every 8 k.  The design:
//
// - Tensor cores: a block of two warpgroups owns a 128 x 128 tile of C;
//   each warpgroup issues wgmma.mma_async m64n128k16 (bf16) or m64n128k8
//   (tf32) into fp32 accumulators in registers on its 64 rows, B read from
//   shared memory through matrix descriptors, A too (bf16) or from
//   registers (fp32: each thread loads its fragments of the stage's A
//   tile and splits them there).
// - Shared memory: a stage holds 128-byte rows along k, 64 bf16 or 32
//   fp32.  bf16: a ring of 6 stages, each a 128 x 64 tile of A and a
//   64 x 128 tile of B (32 KB; 193 KB in all, one block per SM).  fp32: a
//   ring of 3 stages, each A as it lies and B's hi and lo tiles, 128 x 32
//   fp32 each (48 KB; 145 KB in all).  The tiles are in the 128-byte-swizzled
//   layouts wgmma reads without bank conflicts.  A bf16 operand is staged
//   K-major (128-byte rows along k) or MN-major (128-byte rows along r or
//   j) by a template flag, and wgmma's transpose bits take either: the
//   wgrad operands z (r = o) and x (j = i) are contiguous along M and N,
//   not k, so both are MN-major; the dgrad z is K-major and its weight
//   N-major; the forward's x and its weight (o rows of k) are both K-major.
//   tf32 wgmma reads both operands K-major only, which the forward is; the
//   fp32 backward runs on dyad_gemm_tf32.cuh: the dgrad transposed (w read
//   as it lies into registers, z K-major), the wgrad with one operand read
//   as it lies into registers and the other transposed on its way in.
// - The split (fp32): B's copied tile lands raw in the hi slot; once its
//   copies have landed, each thread splits the 16-byte chunks it copied
//   itself (no barrier: its own cp.async writes are visible to it), hi in
//   place and lo into the lo tile, before the stage's barrier; a gathered
//   B is split as it is stored.  A is split in registers (a_frags32).
// - The ring keeps stages in flight while stage t computes: bf16 t + 1 ..
//   t + 4, stage t - 1's wgmma maybe still running; fp32 waits for each
//   stage's products to add its partial sum, so under stage t's products
//   it splits (and stores the gathers of) stage t + 1 and issues t + 2.
// - Copies: an operand that is contiguous along its staged axis, with
//   16-byte aligned strides, is copied 16 bytes at a time with cp.async
//   (zero-filled past a ragged edge).
// - The stride-n DYAD views (the OT z2bar, which B.7 and the down wgrad read,
//   and the IT x2 of the forward and of the up and gate wgrad) hold element m
//   of block g at span[m * n + g]: no 16-byte run of them belongs to one
//   block, so cp.async cannot stage them and no transposed copy is made in
//   device memory.  They go through registers: in bf16 at n = 4 each thread
//   loads, per pair of neighbouring elements, the aligned 16-byte run of the
//   span that holds the pair for all four blocks (neighbouring lanes on
//   neighbouring runs), keeps the raw loads for one iteration, then picks its
//   block's pair with one byte permute and stores it (4 bytes) into the
//   swizzled tile; other n, and fp32, read element by element.  (Picking at
//   once, right after the loads, made every stage wait on them.)  The cost:
//   such a tile moves 4x its bytes from L2 (the other blocks' values), 80 KB
//   a bf16 stage against 32 KB where both operands are copied, and every
//   call has both kinds of block, so the gathered ones set its time
//   (chip_smoke.py phase 4 times each call also with no stride-n view:
//   copied_views_ms).  Only a block that serves all n blocks from one span
//   cuts those bytes; a cluster of the four blocks' CTAs, each copying a
//   quarter of the span and writing each block's elements into its owner's
//   tile through distributed shared memory, was exact on the card but
//   slower than this gather, so it is not used.
// - The interleaved output (fp32, no Fuse): the OT/DT z2 holds element
//   (r, g, j) at r * c_sr + 4 j + g, so a block's own elements are 4 bytes
//   in every 16.  Where a block's k is short (at most kXchgStages stages)
//   the n = 4 blocks of a tile run as one cluster and write it together
//   through distributed shared memory, 16 bytes a store (store_xchg).
// - Determinism: no atomics; the split reduction adds in a fixed order.
//
// The swizzled tile layout, the copies, the descriptors and the wgmma
// wrappers (m64n128k16 here; m64n64k16 and the register-A m64n64k16 and
// m64n128k16 for them, and the tf32 ones) also serve the flash kernels,
// flash_tc.cuh; the layout, the copies and the gathers (of 64-row tiles)
// the bf16 ff megakernel, dyad_ff_tc.cuh; the split-TF32 copies, splits,
// gathers and wgmma the fp32 backward GEMMs of dyad_gemm_tf32.cuh (dgrad,
// fused dgrad, wgrad), whose operands tf32 wgmma cannot read from shared
// memory as they lie, in kernels of their own.
#pragma once

#include <type_traits>

#include "dyad_gemm.cuh"

namespace repro {
namespace tc {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 6;
// the most dynamic shared memory a block may take for two blocks an SM on
// the H100 (228 KB an SM, 1 KB of it the system's for each block)
constexpr int kTwoPerSm = 115712;
constexpr int kThreads = 256;   // two warpgroups, 64 rows of C each
constexpr int kTileBytes = kBM * kBK * 2;             // 16 KB per operand
constexpr int kStageBytes = 2 * kTileBytes;           // A, then B
constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + alignment
// per thread, for a tile of ROWS (mn) x 64 (k): its 16-byte copies and
// its gathered pairs; the loaders below take any ROWS, 128 by default
// (the ff megakernel, dyad_ff_tc.cuh, stages 64)
template <int ROWS>
__host__ __device__ constexpr int chunks() {
  return ROWS * kBK / 8 / kThreads;
}
template <int ROWS>
__host__ __device__ constexpr int pairs() {
  return ROWS * kBK / 2 / kThreads;
}
constexpr int kPairs = pairs<kBM>();   // 16

// the ring of an operand type T: a stage's depth (one 128-byte row along
// k: 64 bf16 or 32 fp32), its tiles (A and B; fp32: A as it lies, split in
// registers, and B's hi and lo) and its stages
template <typename T>
struct Ring {
  static constexpr bool kSplit = sizeof(T) == 4;   // fp32: split TF32
  static constexpr int kBK = 128 / (int)sizeof(T);
  static constexpr int kStageBytes = (kSplit ? 3 : 2) * kTileBytes;
  static constexpr int kDepth = kSplit ? 3 : tc::kStages;
  static constexpr int kSmem = kDepth * kStageBytes + 1024;
};

// how an operand of one component reaches shared memory
enum Load : int {
  kGather = 0,   // element by element through its strides
  kCopy = 1,     // 16-byte cp.async along its contiguous staged axis
  kSpan4 = 2,    // a stride-4 view of 4 interleaved blocks: 16-byte runs
};
struct TcFlags {
  int a[2], b[2];   // Load, per component
  // component c's C is written through the cluster exchange (store_xchg):
  // the split-TF32 mainloop without Fuse, launched in clusters of the n = 4
  // blocks' CTAs
  int xchg[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (mn, k) of a 128 (mn) x 64 (k) bf16 tile with the
// 128-byte swizzle (16-byte chunk index XOR row index mod 8).  K-major:
// row mn holds k 0..63.  MN-major: atom mn / 64 holds, for each k, a
// 128-byte row of mn values.
template <bool KMAJ>
__device__ __forceinline__ uint32_t tile_off(int mn, int k) {
  if constexpr (KMAJ)
    return mn * 128 + ((((k >> 3) ^ mn) & 7) << 4) + (k & 7) * 2;
  else
    return (mn >> 6) * 8192 + k * 128 + (((((mn & 63) >> 3) ^ k) & 7) << 4) +
           (mn & 7) * 2;
}

// An operand of one component: element (mn, k) at p[mn * s_mn + k * s_k],
// mn < ext.  A: mn = r; B: mn = j.  E: the element's bits (bf16 or fp32).
template <typename E>
struct OperandT {
  const E* p;
  long long s_mn, s_k;
  int ext;
};
using Operand = OperandT<unsigned short>;   // bf16 bits
using Operand32 = OperandT<uint32_t>;       // fp32 bits

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the 16-byte copies of one tile: chunk e covers 8 elements along the
// operand's contiguous (staged) axis; neighbouring threads take
// neighbouring chunks
template <bool KMAJ, int ROWS = kBM>
__device__ __forceinline__ void copy_tile(const Operand& o, int mn0, int k0,
                                          int k_end, uint32_t tile) {
#pragma unroll
  for (int i = 0; i < chunks<ROWS>(); ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int mn = KMAJ ? e >> 3 : (e % (ROWS / 8)) * 8;
    const int k = KMAJ ? (e & 7) * 8 : e / (ROWS / 8);
    const int gm = mn0 + mn, gk = k0 + k;
    int n = 0;
    if (KMAJ) {
      if (gm < o.ext) n = min(max(k_end - gk, 0), 8);
    } else {
      if (gk < k_end) n = min(max(o.ext - gm, 0), 8);
    }
    const unsigned short* src = n ? o.p + gm * o.s_mn + gk * o.s_k : o.p;
    cp_async16(tile + tile_off<KMAJ>(mn, k), src, 2 * n);
  }
}

// a tile gathered and stored at once (the second operand of a stage whose
// operands are both gathered): pair q covers 2 neighbouring elements along
// the staged axis, read one by one through the strides (zeros past an
// edge)
template <bool KMAJ, int ROWS = kBM>
__device__ __forceinline__ void gather_tile(const Operand& o, int mn0,
                                            int k0, int k_end,
                                            uint32_t (&reg)[pairs<ROWS>()]) {
#pragma unroll
  for (int i = 0; i < pairs<ROWS>(); ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int mn = KMAJ ? q >> 5 : (q % (ROWS / 2)) * 2;
    const int k = KMAJ ? (q & 31) * 2 : q / (ROWS / 2);
    const int gm = mn0 + mn, gk = k0 + k;
    uint32_t lo = 0, hi = 0;
    if (gm < o.ext && gk < k_end) {
      const unsigned short* s = o.p + gm * o.s_mn + gk * o.s_k;
      lo = __ldg(s);
      if (KMAJ ? gk + 1 < k_end : gm + 1 < o.ext)
        hi = __ldg(s + (KMAJ ? o.s_k : o.s_mn));
    }
    reg[i] = lo | (hi << 16);
  }
}

// The deferred gather of a stage: the loads are issued one iteration
// before their values are packed and stored, so the warp does not wait on
// them while the tensor cores run.  Pair q's raw bits: .x and .y the two
// elements (kGather), or (kSpan4: a stride-4 view of 4 interleaved blocks,
// element m of block g at span[4 m + g]) the aligned 16-byte span load
// that holds the whole pair (m, m + 1), picked out at the store with one
// byte permute.
template <bool KMAJ, int ROWS = kBM>
__device__ __forceinline__ void load_raw(const Operand& o, int mode, int g,
                                         int mn0, int k0, int k_end,
                                         uint4 (&raw)[pairs<ROWS>()]) {
  const long long s_ax = KMAJ ? o.s_k : o.s_mn;
  const long long s_ot = KMAJ ? o.s_mn : o.s_k;
#pragma unroll
  for (int i = 0; i < pairs<ROWS>(); ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int mn = KMAJ ? q >> 5 : (q % (ROWS / 2)) * 2;
    const int k = KMAJ ? (q & 31) * 2 : q / (ROWS / 2);
    const int gm = mn0 + mn, gk = k0 + k;
    const int ax = KMAJ ? gk : gm, ax_end = KMAJ ? k_end : o.ext;
    uint4 w = make_uint4(0, 0, 0, 0);
    if ((KMAJ ? gm < o.ext : gk < k_end) && ax < ax_end) {
      const unsigned short* e = o.p + ax * s_ax + (KMAJ ? gm : gk) * s_ot;
      const bool two = ax + 1 < ax_end;
      if (mode == kSpan4 && two) {
        w = __ldg(reinterpret_cast<const uint4*>(e - g));
      } else if (mode == kSpan4) {   // a lone last element, where the
        const uint32_t v = __ldg(e);  // permute will pick it
        (g & 2 ? w.y : w.x) = v << (16 * (g & 1));
      } else {
        w.x = __ldg(e);
        if (two) w.y = __ldg(e + s_ax);
      }
    }
    raw[i] = w;
  }
}

template <bool KMAJ, int ROWS = kBM>
__device__ __forceinline__ void store_raw(
    uint32_t tile, int mode, int g, const uint4 (&raw)[pairs<ROWS>()]) {
  const uint32_t sel = g & 1 ? 0x7632 : 0x5410;
#pragma unroll
  for (int i = 0; i < pairs<ROWS>(); ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int mn = KMAJ ? q >> 5 : (q % (ROWS / 2)) * 2;
    const int k = KMAJ ? (q & 31) * 2 : q / (ROWS / 2);
    const uint4 w = raw[i];
    const uint32_t v = mode == kSpan4
                           ? __byte_perm(g & 2 ? w.y : w.x,
                                         g & 2 ? w.w : w.z, sel)
                           : w.x | (w.y << 16);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(tile + tile_off<KMAJ>(
                     mn, k)),
                 "r"(v));
  }
}

template <bool KMAJ, int ROWS = kBM>
__device__ __forceinline__ void store_tile(
    uint32_t tile, const uint32_t (&reg)[pairs<ROWS>()]) {
#pragma unroll
  for (int i = 0; i < pairs<ROWS>(); ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int mn = KMAJ ? q >> 5 : (q % (ROWS / 2)) * 2;
    const int k = KMAJ ? (q & 31) * 2 : q / (ROWS / 2);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(tile + tile_off<KMAJ>(
                     mn, k)),
                 "r"(reg[i]));
  }
}

// fp32 to TF32, rounded to nearest (ties away from zero), as its bits
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo to about 2^-22 relative: hi = tf32(x), lo = tf32(x - hi),
// the difference exact in fp32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split_chunk(uint32_t hi_at, uint32_t lo_at) {
  float v[4];
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(hi_at));
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], h[e], l[e]);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi_at),
               "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3]));
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo_at),
               "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3]));
}

// The 16-byte copies of a ROWS x 32 fp32 tile, K-major: chunk e holds k
// 4 (e % 8) .. + 3 of row e / 8 (fp32 element k sits where bf16 element
// 2k would); the raw values land in the hi tile
template <int ROWS>
__device__ __forceinline__ void copy_tile32(const Operand32& o, int mn0,
                                            int k0, int k_end,
                                            uint32_t tile) {
#pragma unroll
  for (int i = 0; i < chunks<ROWS>(); ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int mn = e >> 3, k = (e & 7) * 4;
    const int gm = mn0 + mn, gk = k0 + k;
    const int n = gm < o.ext ? min(max(k_end - gk, 0), 4) : 0;
    const uint32_t* src = n ? o.p + gm * o.s_mn + gk : o.p;
    cp_async16(tile + tile_off<true>(mn, 2 * k), src, 4 * n);
  }
}

// the chunks copy_tile32 gave this thread, once landed, split: hi over
// the raw values, lo into the tile at lo_tile
template <int ROWS>
__device__ __forceinline__ void split_copied32(uint32_t tile,
                                               uint32_t lo_tile) {
#pragma unroll
  for (int i = 0; i < chunks<ROWS>(); ++i) {
    const int e = threadIdx.x + i * kThreads;
    const uint32_t off = tile_off<true>(e >> 3, 2 * ((e & 7) * 4));
    split_chunk(tile + off, lo_tile + off);
  }
}

// A ROWS x 32 fp32 tile, K-major, gathered element by element through its
// strides (zeros past an edge; neighbouring lanes on neighbouring k):
// element i of the thread is (row q / 32, k q % 32), q = tid + i * 256.
// load_raw32 issues the loads, store_split32 splits them into the hi and
// lo tiles (one iteration later for a deferred gather), gather_split32
// does both at once
template <int ROWS>
__device__ __forceinline__ void load_raw32(const Operand32& o, int mn0,
                                           int k0, int k_end,
                                           float (&v)[ROWS / 8]) {
#pragma unroll
  for (int i = 0; i < ROWS / 8; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int gm = mn0 + (q >> 5), gk = k0 + (q & 31);
    v[i] = gm < o.ext && gk < k_end
               ? __uint_as_float(__ldg(o.p + gm * o.s_mn + gk * o.s_k))
               : 0.f;
  }
}
template <int ROWS>
__device__ __forceinline__ void store_split32(uint32_t hi_tile,
                                              uint32_t lo_tile,
                                              const float (&v)[ROWS / 8]) {
#pragma unroll
  for (int i = 0; i < ROWS / 8; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const uint32_t off = tile_off<true>(q >> 5, 2 * (q & 31));
    uint32_t h, l;
    split_tf32(v[i], h, l);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(hi_tile + off), "r"(h));
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(lo_tile + off), "r"(l));
  }
}
template <int ROWS>
__device__ __forceinline__ void store_raw32(uint32_t tile,
                                            const float (&v)[ROWS / 8]) {
#pragma unroll
  for (int i = 0; i < ROWS / 8; ++i) {
    const int q = threadIdx.x + i * kThreads;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(tile + tile_off<true>(
                     q >> 5, 2 * (q & 31))),
                 "r"(__float_as_uint(v[i])));
  }
}
template <int ROWS>
__device__ __forceinline__ void gather_split32(const Operand32& o, int mn0,
                                               int k0, int k_end,
                                               uint32_t hi_tile,
                                               uint32_t lo_tile) {
  float v[ROWS / 8];
  load_raw32<ROWS>(o, mn0, k0, k_end, v);
  store_split32<ROWS>(hi_tile, lo_tile, v);
}

// A thread's tf32 A fragments of a 128 x 32 fp32 tile (K-major, as it
// lies), split: warpgroup w's rows, k8 step s in hi[4 s .. 4 s + 3] and
// lo[...], fragment element e at row 16 warp + lane / 4 + 8 (e & 1),
// column 8 s + lane % 4 + 4 (e >> 1) (the m64nNk8 tf32 A layout).  The
// loads of a warp hit 8 rows' distinct 16-byte chunks.
__device__ __forceinline__ void a_frags32(uint32_t tile, int w,
                                          uint32_t (&hi)[16],
                                          uint32_t (&lo)[16]) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int row = 64 * w + 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int s = i / 4, e = i % 4;
    const int k = 8 * s + lane % 4 + 4 * (e >> 1);
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(v)
                 : "r"(tile + tile_off<true>(row + 8 * (e & 1), 2 * k)));
    split_tf32(v, hi[i], lo[i]);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// the descriptor of k16 step s of a 64-row (A, for warpgroup w) or
// 128-column (B) operand tile.  K-major: 8-row groups 1024 bytes apart
// (SBO), a k step 32 bytes along the swizzled row.  MN-major: 8-k groups
// 1024 bytes apart (SBO), 64-wide mn atoms 8192 bytes apart (LBO), a k
// step 16 rows (2048 bytes).
template <bool KMAJ>
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int w, int s) {
  return KMAJ ? desc(tile + w * 64 * 128 + s * 32, 16, 1024)
              : desc(tile + w * 8192 + s * 2048, 8192, 1024);
}
template <bool KMAJ>
__device__ __forceinline__ uint64_t desc_b(uint32_t tile, int s) {
  return KMAJ ? desc(tile + s * 32, 16, 1024)
              : desc(tile + s * 2048, 8192, 1024);
}

// D (64 x 128, fp32) (+)= A (64 x 16) B (16 x 128), both bf16 from shared
// memory; TA / TB = 1 for an MN-major operand; scale_d = 0 overwrites D
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), both bf16 from shared
// memory; TA / TB = 1 for an MN-major operand; scale_d = 0 overwrites D
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, fp32) += A (64 x 16) B (16 x 64): A bf16 pairs in
// registers (an m64 accumulator's layout: registers 8 s .. 8 s + 7 of an
// m64 product are the A of its k16 step s), B bf16 from shared memory;
// TB = 1 for an MN-major B
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// D (64 x 128, fp32) += A (64 x 16) B (16 x 128): A bf16 pairs in
// registers (an m64 accumulator's layout: registers 8 s .. 8 s + 7 of an
// m64 product are the A of its k16 step s), B bf16 from shared memory;
// TB = 1 for an MN-major B
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// D (64 x 64, fp32) (+)= A (64 x 8) B (8 x 64), both tf32 K-major in
// shared memory (tf32 wgmma has no transpose); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64k8_tf32(
    float (&d)[32], uint64_t da,
    uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, fp32) (+)= A (64 x 8) B (8 x 32), both tf32 K-major in
// shared memory; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n32k8_tf32(
    float (&d)[16], uint64_t da,
    uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) (+)= A (64 x 8) B (8 x 64): A tf32 in registers
// (a thread's rows lane / 4 and + 8, columns lane % 4 and + 4 of its
// warp's 16 rows), B tf32 K-major in shared memory; scale_d = 0
// overwrites D
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(
    float (&d)[32], const uint32_t (&a)[4],
    uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) (+)= A (64 x 8) B (8 x 128): A tf32 in registers
// (a thread's rows lane / 4 and + 8, columns lane % 4 and + 4 of its
// warp's 16 rows), B tf32 K-major in shared memory; scale_d = 0
// overwrites D
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(
    float (&d)[64], const uint32_t (&a)[4],
    uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma boundaries
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <typename O>
__device__ __forceinline__ void store2(O* dst, bool pair, float v0,
                                       float v1) {
  if (pair) {
    if constexpr (sizeof(O) == 4)
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  }
}

// The epilogue: a warpgroup's accumulators (N fp32 a thread: register
// 4 j + 2 h + e holds row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane %
// 4) + e of its 64 x 2N tile at rows r0w, columns j0) into C, or into the
// fp32 partials of split s
template <typename O, int N>
__device__ __forceinline__ void store_c(const DyadGemmArgs& a, int c, int g,
                                        int s, int r0w, int j0,
                                        const float (&acc)[N]) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const long long RN = (long long)a.R * a.N;
  O* C = static_cast<O*>(a.C[c]) + g * a.c_sg[c];
  const long long c_sr = a.c_sr[c], c_sj = a.c_sj[c];
  float* part = a.part ? a.part + (((long long)s * 2 + c) * a.n + g) * RN
                       : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0w + warp * 16 + lane / 4 + 8 * h;
    if (r >= a.R) continue;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const int col = j0 + 8 * j + 2 * (lane % 4);
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (col >= a.N) continue;
      const bool both = col + 1 < a.N;
      if (part) {
        float* d = part + (long long)r * a.N + col;
        const bool pair =
            both && (reinterpret_cast<unsigned long long>(d) & 7) == 0;
        store2(d, pair, v0, v1);
        if (!pair) {
          d[0] = v0;
          if (both) d[1] = v1;
        }
      } else {
        O* d = C + r * c_sr + col * c_sj;
        const bool pair = both && c_sj == 1 &&
                          (reinterpret_cast<unsigned long long>(d) &
                           (2 * sizeof(O) - 1)) == 0;
        store2(d, pair, v0, v1);
        if (!pair) {
          d[0] = from_f32<O>(v0);
          if (both) d[c_sj] = from_f32<O>(v1);
        }
      }
    }
  }
}

// The epilogue of a component whose C interleaves the n = 4 dyad blocks
// along j (element (r, g, j) at r * c_sr + 4 j + g: the OT/DT z2 that
// ref.combine reshapes for free), for a cluster of the 4 blocks' CTAs
// (rank = g) on one (r, j) tile.  store_c would write each element alone,
// 4 bytes in every 16, so each 32-byte sector is written in four pieces by
// four blocks at different times (at OPT-125m's OT up projection, M 4096,
// 0.339 ms against 0.198 with z2 contiguous; tools/two_store.py).  Here
// each CTA puts its 128 x 128 tile into its shared memory, the cluster
// syncs, and CTA q reads rows 32 q .. 32 q + 31 of all four tiles through
// distributed shared memory and writes each (r, j) as one 16-byte store of
// its 4 blocks, neighbouring threads on neighbouring j.  The ring is free
// by then: the caller has waited for its copies and wgmma.
template <typename O>
__device__ __forceinline__ void store_xchg(const DyadGemmArgs& a, int c,
                                           int r0, int j0, int w,
                                           uint32_t tile,
                                           const float (&acc)[64]) {
  static_assert(sizeof(O) == 4, "the exchange writes fp32");
  constexpr int kP = kBN + 4;   // row pitch in floats
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  __syncthreads();   // every warp done reading the ring
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * w + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                       tile + 4 * (r * kP + col)),
                   "f"(acc[4 * j + 2 * h]), "f"(acc[4 * j + 2 * h + 1]));
    }
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  uint32_t q;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(q));
  uint32_t remote[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote[g])
                 : "r"(tile), "r"(g));
  O* C = static_cast<O*>(a.C[c]);
  const long long c_sr = a.c_sr[c];
#pragma unroll 4
  for (int i = 0; i < 32 * kBN / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = 32 * q + e / kBN, col = e % kBN;
    const int r = r0 + row, jj = j0 + col;
    float v[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                   : "=f"(v[g])
                   : "r"(remote[g] + 4 * (row * kP + col)));
    if (r < a.R && jj < a.N)
      *reinterpret_cast<float4*>(C + r * c_sr + 4LL * jj) =
          make_float4(v[0], v[1], v[2], v[3]);
  }
  // no CTA leaves while another reads its tile
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Op: the operand type (bf16, or fp32 on split TF32); O: the output's
template <bool AK, bool BKM, typename O, bool Fuse, typename Op>
__global__ void __launch_bounds__(kThreads, 1)
    dyad_gemm_tc_kernel(DyadGemmArgs a, TcFlags f) {
  using Rg = Ring<Op>;
  constexpr bool kSplit = Rg::kSplit;
  static_assert(!kSplit || (AK && BKM), "tf32 wgmma reads K-major only");
  using E = std::conditional_t<kSplit, uint32_t, unsigned short>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int z = blockIdx.z;
  const int g = z % a.n;
  const int c = Fuse ? 0 : (z / a.n) % 2;
  const int s = z / ((Fuse ? 1 : 2) * a.n);
  const int r0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int k_begin = s * a.krows;
  const int k_end = min(a.K, k_begin + a.krows);
  // stages per component; with Fuse component 0's, then component 1's
  const int per =
      k_end > k_begin ? (k_end - k_begin + Rg::kBK - 1) / Rg::kBK : 0;
  const int T = Fuse ? 2 * per : per;
  const int w = threadIdx.x / 128;

  auto comp = [&](int t) { return Fuse ? (t >= per ? 1 : 0) : c; };
  auto k0_of = [&](int t) {
    return k_begin + (Fuse && t >= per ? t - per : t) * Rg::kBK;
  };
  auto op_a = [&](int cc) {
    return OperandT<E>{static_cast<const E*>(a.A[cc]) + g * a.a_sg[cc],
                       a.a_sr[cc], a.a_sk[cc], a.R};
  };
  auto op_b = [&](int cc) {
    return OperandT<E>{static_cast<const E*>(a.B[cc]) + g * a.b_sg[cc],
                       a.b_sj[cc], a.b_sk[cc], a.N};
  };
  auto tile_a = [&](int t) {
    return base + (t % Rg::kDepth) * Rg::kStageBytes;
  };

  if constexpr (kSplit) {
    // fp32 on split TF32.  A stage: A as it lies, B hi, B lo, 128 x 32
    // each.  A is split in registers, each thread its fragments, and fed
    // to wgmma from there; B is split in shared memory.  A gathered A (the
    // stride-n x2) is loaded one iteration before it is stored; a gathered
    // B at once.  Stage t + 1 is made ready and stage t + 2 issued while
    // stage t's products run.
    constexpr int kB = kTileBytes;
    float raw[kBM / 8];
    auto issue = [&](int t) {
      if (t < T) {
        const int cc = comp(t), k0 = k0_of(t);
        const uint32_t ta = tile_a(t), tb = ta + kTileBytes;
        if (f.a[cc] == kCopy)
          copy_tile32<kBM>(op_a(cc), r0, k0, k_end, ta);
        else
          load_raw32<kBM>(op_a(cc), r0, k0, k_end, raw);
        if (f.b[cc] == kCopy)
          copy_tile32<kBN>(op_b(cc), j0, k0, k_end, tb);
        else
          gather_split32<kBN>(op_b(cc), j0, k0, k_end, tb, tb + kB);
      }
      cp_async_commit();
    };
    // Each stage's three products per pair go into a partial sum of its
    // own, added into acc with fp32 adds (rounded to nearest) once the
    // stage's products are done.  Only 12 wgmma accumulate into a partial,
    // so how the tensor cores round their additions weighs as little as
    // the adds' rounding (into one accumulator over all of k, their error
    // grew with k: 6-14x the plain fp32 product's against float64 at
    // OPT-125m's shapes).  (Two partials in turn, one read while the
    // other's products ran, made ptxas serialise every wgmma.)
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    fence_acc(part);
    // this thread's part of stage t, once landed: its B chunks split, its
    // gathered A stored
    auto ready = [&](int t) {
      if (t < T) {
        const uint32_t ta = tile_a(t), tb = ta + kTileBytes;
        const int cc = comp(t);
        if (f.a[cc] != kCopy) store_raw32<kBM>(ta, raw);
        if (f.b[cc] == kCopy) split_copied32<kBN>(tb, tb + kB);
      }
    };
    issue(0);
    cp_async_wait<0>();
    ready(0);
    issue(1);
    for (int t = 0; t < T; ++t) {
      // stage t landed, split and stored by every thread
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint32_t ta = tile_a(t), tb = ta + kTileBytes;
      uint32_t ah[16], al[16];
      a_frags32(ta, w, ah, al);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // each k8 step: a_lo b_hi, a_hi b_lo, then a_hi b_hi
#pragma unroll
      for (int ks = 0; ks < Rg::kBK / 8; ++ks) {
        const uint32_t h4[4] = {ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2],
                                ah[4 * ks + 3]};
        const uint32_t l4[4] = {al[4 * ks], al[4 * ks + 1], al[4 * ks + 2],
                                al[4 * ks + 3]};
        const uint64_t bh = desc_b<true>(tb, ks),
                       bl = desc_b<true>(tb + kB, ks);
        wgmma_m64n128k8_tf32_rs(part, l4, bh, ks > 0);
        wgmma_m64n128k8_tf32_rs(part, h4, bl);
        wgmma_m64n128k8_tf32_rs(part, h4, bh);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // under the products: stage t + 1 made ready (its loads and gathers
      // were issued an iteration ago), stage t + 2 issued into the slot of
      // stage t - 1, whose products every warpgroup finished before the
      // barrier above
      cp_async_wait<0>();
      ready(t + 1);
      issue(t + 2);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    cp_async_wait<0>();
    if constexpr (!Fuse) {
      if (f.xchg[c]) {
        store_xchg<O>(a, c, r0, j0, w, base, acc);
        return;
      }
    }
    store_c<O>(a, c, g, s, r0 + w * 64, j0, acc);
  } else {
    // the deferred gather of the next stage: one operand's raw loads (A's
    // where A is gathered, else B's); where both are, B is gathered and
    // stored at once
    uint4 raw[kPairs];
    // stage t's copies (one cp.async group, maybe empty) and gathers
    auto issue = [&](int t) {
      if (t < T) {
        const int cc = comp(t), k0 = k0_of(t);
        const int ma = f.a[cc], mb = f.b[cc];
        const uint32_t ta = tile_a(t);
        if (ma == kCopy)
          copy_tile<AK>(op_a(cc), r0, k0, k_end, ta);
        else
          load_raw<AK>(op_a(cc), ma, g, r0, k0, k_end, raw);
        if (mb == kCopy) {
          copy_tile<BKM>(op_b(cc), j0, k0, k_end, ta + kTileBytes);
        } else if (ma == kCopy) {
          load_raw<BKM>(op_b(cc), mb, g, j0, k0, k_end, raw);
        } else {
          uint32_t now[kPairs];
          gather_tile<BKM>(op_b(cc), j0, k0, k_end, now);
          store_tile<BKM>(ta + kTileBytes, now);
        }
      }
      cp_async_commit();
    };
    auto store_gathered = [&](int t) {
      if (t < T) {
        const int cc = comp(t);
        const int ma = f.a[cc], mb = f.b[cc];
        const uint32_t ta = tile_a(t);
        if (ma != kCopy)
          store_raw<AK>(ta, ma, g, raw);
        else if (mb != kCopy)
          store_raw<BKM>(ta + kTileBytes, mb, g, raw);
      }
    };

    // the accumulators are touched only by wgmma between the fences here
    // and after the last wait: any other access while a group is in flight
    // would make ptxas serialise the wgmmas
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_acc(acc);

    // stages in flight ahead of the one computing, one slot kept for the
    // stage whose wgmma may still run; a gathered operand is stored one
    // iteration after its loads
    constexpr int kAhead = Rg::kDepth - 2;
    for (int t = 0; t < kAhead; ++t) {
      if (t) store_gathered(t - 1);
      issue(t);
    }
    for (int t = 0; t < T; ++t) {
      // stage t has landed: this thread's copies, then everyone's
      cp_async_wait<kAhead - 1>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint32_t ta = tile_a(t);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks)
        wgmma_m64n128k16<AK ? 0 : 1, BKM ? 0 : 1>(
            acc, desc_a<AK>(ta, w, ks), desc_b<BKM>(ta + kTileBytes, ks));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // stage t - 1's products are done here, and every warpgroup's stage
      // t - 2 was done before the barrier above: its slot takes stage
      // t + kAhead
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      store_gathered(t + kAhead - 1);
      issue(t + kAhead);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    cp_async_wait<0>();
    fence_acc(acc);
    store_c<O>(a, c, g, s, r0 + w * 64, j0, acc);
  }
}

// an operand takes cp.async when it is contiguous along its staged axis
// and every 16-byte run it copies (epc elements) starts 16-byte aligned;
// a bf16 one the 16-byte span loads when its n = 4 blocks interleave at
// stride 4 (s_g 1) on aligned rows, so that every run it loads lies inside
// the view
inline int load_of(const void* p, long long s_axis, long long s_other,
                   long long s_g, int n, int epc = 8) {
  const bool aligned = (reinterpret_cast<unsigned long long>(p) & 15) == 0 &&
                       s_other % epc == 0;
  if (aligned && s_axis == 1 && s_g % epc == 0) return kCopy;
  if (epc == 8 && aligned && s_axis == 4 && s_g == 1 && n == 4)
    return kSpan4;
  return kGather;
}

// the most k stages a block may run for its C to take the cluster
// exchange: the four CTAs of a cluster start and end together, which cost
// more than the exchange saved at OPT-125m's down projection (24 stages a
// block) in a trial and less at its up (6 stages: 0.339 -> 0.226 ms at M
// 4096, tools/two_store.py); no k between the two was tried
constexpr int kXchgStages = 8;

// whether component c's C takes the cluster exchange (store_xchg): fp32
// out of the split-TF32 mainloop without Fuse, at most kXchgStages stages
// of k, n = 4 blocks interleaved along j (s_g 1, s_j 4) on 16-byte aligned
// rows, written whole (no split partials)
inline int xchg_of(const DyadGemmArgs& a, int c, int bk) {
  return a.n == 4 && a.split == 1 && !a.part && a.K <= kXchgStages * bk &&
         a.c_sg[c] == 1 && a.c_sj[c] == 4 && a.c_sr[c] % 4 == 0 &&
         (reinterpret_cast<unsigned long long>(a.C[c]) & 15) == 0;
}

// AK / BKM: A / B staged K-major (else MN-major); Op the operand type
// (bf16, or fp32 on split TF32, both K-major)
template <bool AK, bool BKM, typename O, bool Fuse = false,
          typename Op = __nv_bfloat16>
cudaError_t launch(const DyadGemmArgs& a, cudaStream_t stream) {
  constexpr int epc = 16 / (int)sizeof(Op);
  // a split range starts on a stage, so its 16-byte copies stay aligned
  if ((Fuse && (a.split != 1 || a.part)) ||
      (a.split > 1 && a.krows % Ring<Op>::kBK))
    return cudaErrorInvalidValue;
  if (a.n == 0 || a.R == 0 || a.N == 0) return cudaSuccess;
  constexpr bool kXchg = Ring<Op>::kSplit && !Fuse && sizeof(O) == 4;
  TcFlags f;
  for (int c = 0; c < 2; ++c) {
    f.a[c] = AK ? load_of(a.A[c], a.a_sk[c], a.a_sr[c], a.a_sg[c], a.n, epc)
                : load_of(a.A[c], a.a_sr[c], a.a_sk[c], a.a_sg[c], a.n, epc);
    f.b[c] = BKM ? load_of(a.B[c], a.b_sk[c], a.b_sj[c], a.b_sg[c], a.n, epc)
                 : load_of(a.B[c], a.b_sj[c], a.b_sk[c], a.b_sg[c], a.n, epc);
    f.xchg[c] = kXchg ? xchg_of(a, c, Ring<Op>::kBK) : 0;
  }
  auto kernel = dyad_gemm_tc_kernel<AK, BKM, O, Fuse, Op>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<Op>::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + kBN - 1) / kBN, (a.R + kBM - 1) / kBM,
            (Fuse ? 1 : 2) * a.n * a.split);
  if (f.xchg[0] || f.xchg[1]) {
    // clusters of the n = 4 blocks' CTAs of one (component, tile): grid.z
    // runs over g fastest
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 4;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Ring<Op>::kSmem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a, f);
  } else {
    kernel<<<grid, kThreads, Ring<Op>::kSmem, stream>>>(a, f);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || !a.part) return err;
  const long long total = 2LL * a.n * a.R * a.N;
  constexpr int kReduceThreads = 256;
  gemm::dyad_gemm_reduce<O><<<(unsigned)((total + kReduceThreads - 1) /
                                         kReduceThreads),
                              kReduceThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace repro
