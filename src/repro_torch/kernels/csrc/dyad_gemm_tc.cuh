// The bf16 tensor-core mainloop of the DYAD GEMMs (dyad_mm.cu and
// dyad_mm_two.cu past the decode rows, dyad_dgrad.cu, dyad_dgrad_fused.cu,
// dyad_wgrad.cu), beside the fp32 FMA one of dyad_gemm.cuh.  It
// computes what that one does, through the same DyadGemmArgs:
//
//   C_c[g][r, j] = sum_{k in [k_begin, k_end)} A_c[g][r, k] * B_c[g][k, j]
//
// for two components c and n dyad blocks g, every operand read through its
// own (g, row, column) strides; split > 1 writes fp32 partials that
// gemm::dyad_gemm_reduce adds in split order; Fuse sums component 0's k
// range, then component 1's, into one accumulator.  The operands are bf16,
// the sums fp32, and the output is rounded once.
//
// Replaces, on this card, the TPU kernels src/repro/kernels/dyad_mm.py:
// dyad_mm_blocks (_dyad_kernel, Fuse), dyad_mm_blocks_two
// (_dyad_kernel_two), dyad_mm_dgrad_two (_dgrad_kernel_two), dyad_mm_dgrad
// (_dgrad_kernel, Fuse) and dyad_mm_wgrad (_wgrad_kernel):
// MXU products over VMEM tiles with the reduction carried across the
// sequential grid axis.
//
// What bounds it on the H100: the bf16 tensor cores (989 TFLOP/s).  A call
// at Qwen3-0.6B's training rows does 12.9 GFLOP on 25-35 MB: 0.013 ms of
// operations against 0.008-0.010 ms of bytes.  The FMA mainloop ran such a
// call at 12-24 TFLOP/s, with the bf16 operands widened to fp32 in shared
// memory and a barrier every 8 k.  The design:
//
// - Tensor cores: a block of two warpgroups owns a 128 x 128 tile of C;
//   each warpgroup issues wgmma.mma_async m64n128k16 (bf16 in, fp32
//   accumulators in registers) on its 64 rows, A and B both read from
//   shared memory through matrix descriptors.
// - Shared memory: a ring of 6 stages, each a 128 x 64 tile of A and a
//   64 x 128 tile of B in bf16 (32 KB; 193 KB in all, one block per SM),
//   in the 128-byte-swizzled layouts wgmma reads without bank conflicts.
//   An operand is staged K-major (128-byte rows along k) or MN-major
//   (128-byte rows along r or j) by a template flag, and wgmma's transpose
//   bits take either: the wgrad operands z (r = o) and x (j = i) are
//   contiguous along M and N, not k, so both are MN-major; the dgrad z is
//   K-major and its weight N-major; the forward's x and its weight (o rows
//   of k) are both K-major.
// - Copies: an operand that is contiguous along its staged axis, with
//   16-byte aligned strides, is copied 16 bytes at a time with cp.async
//   (zero-filled past a ragged edge).  Stages t + 1 .. t + 4 are in flight
//   while stage t computes and stage t - 1's wgmma may still run.
// - The stride-n DYAD views (the OT z2bar, which B.7 and the down wgrad read,
//   and the IT x2 of the forward and of the up and gate wgrad) hold element m
//   of block g at span[m * n + g]: no 16-byte run of them belongs to one
//   block, so cp.async cannot stage them and no transposed copy is made in
//   device memory.  They go through registers: at n = 4 each thread loads,
//   per pair of neighbouring elements, the aligned 16-byte run of the span
//   that holds the pair for all four blocks (neighbouring lanes on
//   neighbouring runs), keeps the raw loads for one iteration, then picks its
//   block's pair with one byte permute and stores it (4 bytes) into the
//   swizzled tile; other n read element by element.  (Picking at once, right
//   after the loads, made every stage wait on them.)  The cost: such a tile
//   moves 4x its bytes from L2 (the other blocks' values), 80 KB a stage
//   against 32 KB where both operands are copied, and every call has both
//   kinds of block, so the gathered ones set its time (chip_smoke.py phase 4
//   times each call also with no stride-n view: copied_views_ms).  Only a
//   block that serves all n blocks from one span cuts those bytes; a cluster
//   of the four blocks' CTAs, each copying a quarter of the span and writing
//   each block's elements into its owner's tile through distributed shared
//   memory, was exact on the card but slower than this gather, so it is not
//   used.
// - Determinism: no atomics; the split reduction adds in a fixed order.
//
// The swizzled tile layout, the copies, the descriptors and the wgmma
// wrappers (m64n128k16 here; m64n64k16 and the register-A m64n64k16 and
// m64n128k16 for them) also serve the bf16 flash kernels, flash_tc.cuh;
// the layout, the copies and the gathers (of 64-row tiles) the bf16 ff
// megakernel, dyad_ff_tc.cuh.
#pragma once

#include "dyad_gemm.cuh"

namespace repro {
namespace tc {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 6;
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

// how an operand of one component reaches shared memory
enum Load : int {
  kGather = 0,   // element by element through its strides
  kCopy = 1,     // 16-byte cp.async along its contiguous staged axis
  kSpan4 = 2,    // a stride-4 view of 4 interleaved blocks: 16-byte runs
};
struct TcFlags {
  int a[2], b[2];   // Load, per component
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
// mn < ext.  A: mn = r; B: mn = j.
struct Operand {
  const unsigned short* p;   // bf16 bits
  long long s_mn, s_k;
  int ext;
};

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

template <bool AK, bool BKM, typename O, bool Fuse>
__global__ void __launch_bounds__(kThreads, 1)
    dyad_gemm_tc_kernel(DyadGemmArgs a, TcFlags f) {
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
  const int per = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int T = Fuse ? 2 * per : per;
  const int w = threadIdx.x / 128;

  auto comp = [&](int t) { return Fuse ? (t >= per ? 1 : 0) : c; };
  auto k0_of = [&](int t) {
    return k_begin + (Fuse && t >= per ? t - per : t) * kBK;
  };
  auto op_a = [&](int cc) {
    return Operand{static_cast<const unsigned short*>(a.A[cc]) +
                       g * a.a_sg[cc],
                   a.a_sr[cc], a.a_sk[cc], a.R};
  };
  auto op_b = [&](int cc) {
    return Operand{static_cast<const unsigned short*>(a.B[cc]) +
                       g * a.b_sg[cc],
                   a.b_sj[cc], a.b_sk[cc], a.N};
  };
  auto tile_a = [&](int t) { return base + (t % kStages) * kStageBytes; };

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

  // stages in flight ahead of the one computing: the ring also holds the
  // stage whose wgmma may still run; a gathered operand is stored one
  // iteration after its loads
  constexpr int kAhead = kStages - 2;
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

  // accumulator fragment: register 4 j + 2 h + e of a thread holds row
  // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e of its
  // warpgroup's 64 x 128 tile
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const long long RN = (long long)a.R * a.N;
  O* C = static_cast<O*>(a.C[c]) + g * a.c_sg[c];
  const long long c_sr = a.c_sr[c], c_sj = a.c_sj[c];
  float* part = a.part ? a.part + (((long long)s * 2 + c) * a.n + g) * RN
                       : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + w * 64 + warp * 16 + lane / 4 + 8 * h;
    if (r >= a.R) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
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

// an operand takes cp.async when it is contiguous along its staged axis
// and every 8-element run it copies starts 16-byte aligned; the 16-byte
// span loads when its n = 4 blocks interleave at stride 4 (s_g 1) on
// aligned rows, so that every run it loads lies inside the view
inline int load_of(const void* p, long long s_axis, long long s_other,
                   long long s_g, int n) {
  const bool aligned =
      (reinterpret_cast<unsigned long long>(p) & 15) == 0 && s_other % 8 == 0;
  if (aligned && s_axis == 1 && s_g % 8 == 0) return kCopy;
  if (aligned && s_axis == 4 && s_g == 1 && n == 4) return kSpan4;
  return kGather;
}

// AK / BKM: A / B staged K-major (else MN-major)
template <bool AK, bool BKM, typename O, bool Fuse = false>
cudaError_t launch(const DyadGemmArgs& a, cudaStream_t stream) {
  // a split range starts on a stage, so its 16-byte copies stay aligned
  if ((Fuse && (a.split != 1 || a.part)) || (a.split > 1 && a.krows % kBK))
    return cudaErrorInvalidValue;
  if (a.n == 0 || a.R == 0 || a.N == 0) return cudaSuccess;
  TcFlags f;
  for (int c = 0; c < 2; ++c) {
    f.a[c] = AK ? load_of(a.A[c], a.a_sk[c], a.a_sr[c], a.a_sg[c], a.n)
                : load_of(a.A[c], a.a_sr[c], a.a_sk[c], a.a_sg[c], a.n);
    f.b[c] = BKM ? load_of(a.B[c], a.b_sk[c], a.b_sj[c], a.b_sg[c], a.n)
                 : load_of(a.B[c], a.b_sj[c], a.b_sk[c], a.b_sg[c], a.n);
  }
  auto kernel = dyad_gemm_tc_kernel<AK, BKM, O, Fuse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.N + kBN - 1) / kBN, (a.R + kBM - 1) / kBM,
            (Fuse ? 1 : 2) * a.n * a.split);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(a, f);
  err = cudaGetLastError();
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
