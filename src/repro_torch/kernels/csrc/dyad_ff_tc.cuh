// The bf16 ff megakernel on the tensor cores (dyad_ff_tc_kernel), and
// what it shares with the FMA megakernel of dyad_ff.cu, which includes
// this header: the arguments and the activation epilogues.  It computes
// dyad_ff.cu's function, per dyad block g,
//
//   pre[b, g, j] = sum_k x1[b, g, k] * wu1[g, j, k] + x2[b, g, k] * wu2[g, j, k]
//   h[b, g, j]   = act(pre)            (swiglu: silu(gate pre) * pre)
//   z1[b, g, o]  = sum_j h[b, g, j] * wd1[g, o, j]
//   z2[b, g, o]  = sum_j h[b, g, j] * wd2[g, o, j]
//
// with bf16 x and weights: both components of the up (and gate) product
// summed in one fp32 accumulator; the activation on the fp32 sums (gelu
// in the tanh form, relu, silu, swiglu); the hidden rounded to bf16
// before the down products; z1 and z2 kept apart, each rounded once and
// written through its strides (z2 through the permuted view of the
// wrapper, so ref.combine stays a free reshape plus one add).  Ragged
// edges are masked on load and store, with no padded copies; the hidden
// never goes to device memory (the fp32 partials of a hidden split are
// sums over a range of it, not the hidden).
//
// Replaces, for bf16 x, the TPU kernels src/repro/kernels/dyad_mm.py:
// dyad_ff_fused (_ff_kernel, _ff_kernel_swiglu, pallas_call in
// _dyad_ff_impl) and, instantiated on a payload type W (int8, fp8 e4m3),
// dyad_ff_fused_q (_ff_kernel_q, _ff_kernel_swiglu_q, pallas_call in
// _dyad_ff_q_impl).  dyad_ff.cu's FMA kernel keeps fp32 x; the wrapper's
// ff_plan (ff_q_plan) picks the kernel, the hidden split and its span.
//
// What bounds it on the H100: one Qwen3-0.6B layer (n 4, d_in_b 256,
// d_ff_b 768, d_out_b 256, swiglu) at M 4096 does 38.7 GFLOP, 0.039 ms on
// the bf16 tensor cores, on 32 MB (x, weights and z once each).  But
// every block of 64 rows reads its dyad block's 2.36 MB of bf16 weights
// again from L2: about 0.6 GB a call at M 4096, which is what likely
// bounds this first design (0.1 ms at about 6 TB/s).  The design:
//
// - A block of two warpgroups (256 threads) owns 64 rows of one dyad
//   block g and up to 256 outputs of both components; one block an SM.
// - x resident: the block's x1 and x2 tiles (64 rows x 2 d_in bf16, at
//   most 64 KB: d_in <= 256) are staged once, K-major in 128-byte-swizzled
//   64 x 64 tiles (dyad_gemm_tc.cuh's layout): x1 by cp.async, the
//   stride-n x2 through dyad_gemm_tc.cuh's register gather (the kSpan4
//   16-byte runs at n 4, else element by element).
// - The hidden walk, one 64-column tile at a time:
//   1. warpgroup w computes hidden columns 32 w .. 32 w + 31 of the up and
//      gate tiles with wgmma m64n32k16 over the fused k of both components
//      (A = x from shared memory, B = the up or gate weight tile, K-major
//      as it lies: j rows of k); 2 x 16 fp32 registers a thread;
//   2. applies the activation to those registers, rounds to bf16 and
//      stores into a swizzled 64 x 64 hidden tile in shared memory (8 KB);
//   3. a barrier;
//   4. warpgroup 0 adds h wd1_tile^T into z1, warpgroup 1 h wd2_tile^T
//      into z2, each with wgmma m64n256k16 (128 fp32 registers a thread);
//      the product runs on under the next tile's first up stage.
// - Weights: the main path hands over fp32 params; the entry casts them to
//   bf16 once a call, all six in one launch (dyad_ff_cast_kernel), into a
//   scratch the wrapper allocates: what a cast before the call computes.
// - Weight staging: the up and gate tiles flow through a cp.async ring of
//   5 stages, 64 deep (16 KB a stage; 3 in flight ahead of the computing
//   one).  The 64 KB of wd1 and wd2 tiles of hidden tile j load into one
//   buffer from tile j's second up stage on, once both warpgroups' down
//   products of tile j - 1 are done, and land under its up products.
//   Shared memory: 64 + 8 + 64 + 80 KB and 1 KB of alignment, 217 KB.
// - A hidden tile with fewer live columns (d_ff or a split range off a
//   multiple of 64) skips the down k-steps past the range; its masked
//   columns see zero weights, so act(0) = 0 adds nothing.  (Skipping a
//   warpgroup's up products whose 32 columns are all masked made ptxas
//   serialise every wgmma: a branch on the warpgroup is divergent to it.)
// - Filling the card at prefill and decode rows: the wrapper splits the
//   hidden into ranges (ff_tc_split); each range writes fp32 partials that
//   dyad_ff.cu's second pass adds in split order: the same bits on every
//   run, no atomics.  A row's up sums run in one order whatever M and the
//   split.  Its down sums follow the ranges, and wgmma's fp32 sums round
//   coarser than FMA's, so where one 64-column range per hidden tile keeps
//   the grid within two waves (the serving rows) every tile is a range: a
//   row then gets the same bits whatever M, and serving routes that batch
//   rows apart agree.  Past that, ranges as narrow as keep the grid within
//   one wave (a second wave cost more than it spread).
// - Quantized weights (W int8 or fp8: the quantized serving path), the
//   same walk with these changes:
//   - the payloads reach the swizzled bf16 tiles through quant_tc.cuh's
//     loader: the ring holds raw up (and gate) bytes (8 KB a stage), each
//     stage converted into one of two bf16 stages after a barrier, then a
//     proxy fence and a second barrier before its wgmma (it runs under
//     the previous stage's products); the down bytes land in a raw buffer
//     and are converted after the activation, fenced like the hidden
//     tile.  No weight is cast or dequantized in device memory, so there
//     is no per-call cast launch;
//   - the scales differ by component, so each up (and gate) sum is kept
//     per component (component 0's k tiles into up / gate, then component
//     1's into up2 / gate2: two loops, no branch around a wgmma) and each
//     is multiplied by its per-(block, hidden column) scale and added in
//     fp32 before the activation;
//   - a block owns 128 outputs of each component (m64n128k16 down, 64
//     accumulators a thread), so that the four up sums (64 registers)
//     fit beside them: the up product is computed once per 128 outputs
//     (twice for Qwen3's 256);
//   - each output's down sum is multiplied by its scale once, before it
//     is stored or written as a partial of the hidden split (whose second
//     pass only adds).
//   Shared memory: 64 + 8 + 32 (bf16 down) + 32 (converted stages) + 16
//   (raw down) + 40 (raw ring) KB and 1 KB of alignment, 193 KB.
// - Not yet: TMA, a producer warp, setmaxnreg, or a cluster multicasting a
//   dyad block's weights to its row tiles (the L2 reads above).
#pragma once

#include "quant_tc.cuh"

namespace repro {

enum Act : int { kGelu = 0, kRelu = 1, kSilu = 2, kSwiglu = 3 };

struct FFArgs {
  const void* x1;
  const void* x2;
  long long x1_sb, x1_sg, x1_sk, x2_sb, x2_sg, x2_sk;
  const void* wu[4];   // wu1, wu2, wg1, wg2: (n, d_ff, d_in), contiguous
  const void* wd[2];   // wd1, wd2: (n, d_out, d_ff), contiguous
  void* z[2];
  long long z_sb[2], z_sg[2], z_so[2];
  float* part;         // (split, 2, M, n, d_out) fp32 when split > 1
  int M, n, d_in, d_ff, d_out;
  int split, span;     // hidden columns [s * span, (s + 1) * span) per split
  int act;
  // quantized weights only: the scales of wu[w], (n, d_ff), and of wd[c],
  // (n, d_out), fp32 and contiguous
  const float* su[4];
  const float* sd[2];
};

__device__ __forceinline__ float silu(float u) { return u / (1.f + expf(-u)); }

__device__ __forceinline__ float activate(int act, float u) {
  switch (act) {
    case kGelu: {
      const float c = 0.7978845608028654f;   // sqrt(2 / pi)
      return 0.5f * u * (1.f + tanhf(c * (u + 0.044715f * u * u * u)));
    }
    case kRelu:
      return fmaxf(u, 0.f);
    default:
      return silu(u);
  }
}

namespace fftc {

constexpr int kRows = 64;     // rows of one dyad block per block
constexpr int kHid = 64;      // hidden columns per tile
constexpr int kOut = 256;     // outputs per block and component (bf16)
constexpr int kBK = tc::kBK;  // up contraction per stage: 64
constexpr int kMaxIn = 256;   // d_in whose x tiles stay resident
constexpr int kStages = 5, kAhead = kStages - 2;
constexpr int kThreads = tc::kThreads;   // 256: two warpgroups
constexpr int kTile = kRows * kBK * 2;   // 8 KB: 64 rows of 64 bf16
constexpr int kXBytes = 2 * (kMaxIn / kBK) * kTile;   // 64 KB
constexpr int kStageBytes = 2 * kTile;                // up, gate
constexpr int kPairs = tc::pairs<kRows>();

// the shared-memory plan of the kernel for weight type W: x tiles, the
// hidden tile, the bf16 down tiles (wd1's rows, then wd2's) and the ring;
// payloads add the raw down tiles and two converted up (and gate) stages,
// and their ring holds raw bytes.  A payload block owns 128 outputs of a
// component (64 accumulators a thread), so that the up and gate sums of
// both components fit beside them in registers.
template <typename W>
struct Plan {
  static constexpr bool kQ = is_payload<W>::value;
  static constexpr int kO = kQ ? 128 : kOut;
  static constexpr int kRawUp = qtc::raw_bytes<kRows>();   // 4 KB
  static constexpr int kD = 2 * (kO / kRows) * kTile;      // wd1, wd2
  static constexpr int kConv = kQ ? 2 * kStageBytes : 0;
  static constexpr int kDRaw = kQ ? 2 * qtc::raw_bytes<kO>() : 0;
  static constexpr int kSlot = kQ ? 2 * kRawUp : kStageBytes;
  // offsets from the 1 KB-aligned base: every bf16 tile starts on 1 KB
  static constexpr int kHs = kXBytes, kDs = kHs + kTile, kCv = kDs + kD;
  static constexpr int kDr = kCv + kConv, kRing = kDr + kDRaw;
  static constexpr int kSmem = kRing + kStages * kSlot + 1024;
  static_assert(kCv % 1024 == 0, "swizzled tiles start on 1 KB");
  static_assert(kSmem <= 232448, "over the H100's 227 KB a block");
};

// how each operand reaches shared memory (tc::Load)
struct Loads {
  int x[2], wu, wd;
};

// D (64 x 32, fp32) (+)= A (64 x 16) B (16 x 32), both bf16 K-major
// from shared memory; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 256, fp32) (+)= A (64 x 16) B (16 x 256), both bf16 K-major
// from shared memory; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// cp.async groups: wait until at most n (0 .. kAhead - 1) are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  if (n <= 0)
    tc::cp_async_wait<0>();
  else if (n == 1)
    tc::cp_async_wait<1>();
  else
    tc::cp_async_wait<2>();
}

__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return tc::desc(addr, 16, 1024);   // K-major, 8-row groups 1 KB apart
}

// one 64-row K-major tile of a weight: 16-byte copies (cp.async), or
// element by element through registers, stored at once
__device__ __forceinline__ void stage_w(const tc::Operand& o, int mode,
                                        int mn0, int k0, int k_end,
                                        uint32_t tile) {
  if (mode == tc::kCopy) {
    tc::copy_tile<true, kRows>(o, mn0, k0, k_end, tile);
  } else {
    uint32_t reg[kPairs];
    tc::gather_tile<true, kRows>(o, mn0, k0, k_end, reg);
    tc::store_tile<true, kRows>(tile, reg);
  }
}

template <bool kGated, typename W>
__global__ void __launch_bounds__(kThreads, 1)
    dyad_ff_tc_kernel(FFArgs a, Loads f) {
  using P = Plan<W>;
  constexpr bool kQ = P::kQ;
  constexpr int kO = P::kO;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  // x tiles (component 0's k tiles, then component 1's), the hidden
  // tile, the down-weight tiles (wd1's kO rows, then wd2's), the
  // converted up stages and raw down tiles (payloads), the ring
  const uint32_t xs = base, hs = base + P::kHs, ds = base + P::kDs;
  const uint32_t cv = base + P::kCv, dr = base + P::kDr;
  const uint32_t ring = base + P::kRing;

  const int o_tiles = (a.d_out + kO - 1) / kO;
  const int o0 = (blockIdx.x % o_tiles) * kO;
  const int s = blockIdx.x / o_tiles;
  const int m0 = blockIdx.y * kRows;
  const int g = blockIdx.z;
  const int j_begin = s * a.span;
  const int j_end = min(a.d_ff, j_begin + a.span);
  const int kt1 = (a.d_in + kBK - 1) / kBK;   // k tiles per component
  const int KT = 2 * kt1;                     // up stages per hidden tile
  const int NJ = (j_end - j_begin + kHid - 1) / kHid;
  const int T = NJ * KT;
  const int w = threadIdx.x / 128;            // warpgroup: z1 or z2

  const long long wu_g = (long long)g * a.d_ff * a.d_in;
  const long long wd_g = (long long)g * a.d_out * a.d_ff;
  auto up_op = [&](int i) {   // wu1 wu2 wg1 wg2[g]: j rows of k
    return tc::Operand{static_cast<const unsigned short*>(a.wu[i]) + wu_g,
                       a.d_in, 1, j_end};
  };
  auto up_q = [&](int i) {
    return qtc::Operand{static_cast<const uint8_t*>(a.wu[i]) + wu_g, a.d_in,
                        j_end};
  };
  auto x_op = [&](int c) {
    return c ? tc::Operand{static_cast<const unsigned short*>(a.x2) +
                               g * a.x2_sg,
                           a.x2_sb, a.x2_sk, a.M}
             : tc::Operand{static_cast<const unsigned short*>(a.x1) +
                               g * a.x1_sg,
                           a.x1_sb, a.x1_sk, a.M};
  };

  // the down-weight tiles of hidden tile d_next ride on the next stage's
  // cp.async group, d_group
  bool d_due = false;
  int d_next = 0, d_group = 0;
  // stage t's up (and gate) tiles, and the due down tiles: one group
  auto issue = [&](int t) {
    if (t < T) {
      const int jt = t / KT, kt = t - jt * KT;
      const int c = kt < kt1 ? 0 : 1;
      const int k0 = (kt - c * kt1) * kBK;
      const int j0 = j_begin + jt * kHid;
      const uint32_t slot = ring + (t % kStages) * P::kSlot;
      if constexpr (kQ) {
        qtc::copy_raw<kRows>(up_q(c), f.wu == tc::kCopy, j0, k0, a.d_in,
                             slot);
        if (kGated)
          qtc::copy_raw<kRows>(up_q(2 + c), f.wu == tc::kCopy, j0, k0,
                               a.d_in, slot + P::kRawUp);
      } else {
        stage_w(up_op(c), f.wu, j0, k0, a.d_in, slot);
        if (kGated)
          stage_w(up_op(2 + c), f.wu, j0, k0, a.d_in, slot + kTile);
      }
    }
    if (d_due) {
      const int j0 = j_begin + d_next * kHid;
#pragma unroll 1
      for (int c = 0; c < 2; ++c) {
        if constexpr (kQ) {
          const qtc::Operand o{static_cast<const uint8_t*>(a.wd[c]) + wd_g,
                               a.d_ff, a.d_out};
          qtc::copy_raw<kO>(o, f.wd == tc::kCopy, o0, j0, j_end,
                            dr + c * qtc::raw_bytes<kO>());
        } else {
          const tc::Operand o{static_cast<const unsigned short*>(a.wd[c]) +
                                  wd_g,
                              a.d_ff, 1, a.d_out};
#pragma unroll 1
          for (int q = 0; q < kO / kRows; ++q)
            stage_w(o, f.wd, o0 + q * kRows, j0, j_end,
                    ds + (c * (kO / kRows) + q) * kTile);
        }
      }
      d_due = false;
      d_group = t;
    }
    tc::cp_async_commit();
  };

  // x1 by cp.async in stage 0's group, the first down tiles in stage 1's;
  // the gathered x tiles while those copies fly
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    if (f.x[c] != tc::kCopy) continue;
#pragma unroll 1
    for (int kt = 0; kt < kt1; ++kt)
      tc::copy_tile<true, kRows>(x_op(c), m0, kt * kBK, a.d_in,
                                 xs + (c * kt1 + kt) * kTile);
  }
  for (int t = 0; t < kAhead; ++t) {
    d_due = t == 1;
    issue(t);
  }
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    if (f.x[c] == tc::kCopy) continue;
#pragma unroll 1
    for (int kt = 0; kt < kt1; ++kt) {
      uint4 raw[kPairs];
      tc::load_raw<true, kRows>(x_op(c), f.x[c], g, m0, kt * kBK, a.d_in,
                                raw);
      tc::store_raw<true, kRows>(xs + (c * kt1 + kt) * kTile, f.x[c], g,
                                 raw);
    }
  }

  // the accumulators are touched only by wgmma until the waits that
  // precede their reads (the up pairs before the activation, the down pair
  // after the walk); the first product of each sum overwrites (scale_d 0).
  // Payloads sum each component's up (and gate) apart (up2, gate2: the
  // scales differ), component 0's k tiles first.
  float up[16], gate[16], up2[kQ ? 16 : 1], gate2[kQ ? 16 : 1];
  float acc[kO / 2];
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;

#pragma unroll 1
  for (int jt = 0; jt < NJ; ++jt) {
    const int j0 = j_begin + jt * kHid;
    const int live = min(kHid, j_end - j0);
    // up stage kt of the tile into (u, gt); `first`: the sums' first stage
    auto stage = [&](int kt, bool first, float (&u)[16], float (&gt)[16]) {
      const int t = jt * KT + kt;
      // stage t has landed: this thread's copies, then everyone's
      tc::cp_async_wait<kAhead - 1>();
      uint32_t wt = ring + (t % kStages) * P::kSlot;
      if constexpr (kQ) {
        // every warpgroup's products of stage t - 2 are done: their
        // converted tiles take stage t's
        __syncthreads();
        const uint32_t cb = cv + (t & 1) * kStageBytes;
        qtc::convert<W, kRows>(wt, cb);
        if (kGated) qtc::convert<W, kRows>(wt + P::kRawUp, cb + kTile);
        wt = cb;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      // every warpgroup's down products of tile jt - 1 were done before
      // the barrier: their weight buffer takes tile jt's
      if (kt == 1 && jt > 0) {
        d_due = true;
        d_next = jt;
      }
      const uint32_t xt = xs + kt * kTile;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const uint64_t da = desc_k(xt + ks * 32);
        const int acc_in = !first || ks > 0;
        wgmma_m64n32k16(u, da, desc_k(wt + w * 4096 + ks * 32), acc_in);
        if (kGated)
          wgmma_m64n32k16(gt, da, desc_k(wt + kTile + w * 4096 + ks * 32),
                          acc_in);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // stage t - 1's products (and tile jt - 1's down) are done here, and
      // every warpgroup's stage t - 2 was done before the barrier above:
      // its slot takes stage t + kAhead
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      issue(t + kAhead);
    };
    if constexpr (kQ) {
#pragma unroll 1
      for (int kt = 0; kt < kt1; ++kt) stage(kt, kt == 0, up, gate);
#pragma unroll 1
      for (int kt = kt1; kt < KT; ++kt) stage(kt, kt == kt1, up2, gate2);
    } else {
#pragma unroll 1
      for (int kt = 0; kt < KT; ++kt) stage(kt, kt == 0, up, gate);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    tc::fence_acc(up);
    if (kGated) tc::fence_acc(gate);
    if constexpr (kQ) {
      tc::fence_acc(up2);
      if (kGated) tc::fence_acc(gate2);
    }

    // the activation on the fp32 sums (payloads: each component's sum
    // times its scale, added), rounded to bf16 into the hidden tile;
    // fragment register 4 jj + 2 hh + e: row 16 warp + lane / 4 + 8 hh,
    // column 32 w + 8 jj + 2 (lane % 4) + e
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = 32 * w + 8 * jj + 2 * (lane % 4);
      float sc[4][2];   // su1 su2 sg1 sg2 of columns col, col + 1
      if constexpr (kQ) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jc = j0 + col + e;
          const long long sj = (long long)g * a.d_ff + jc;
#pragma unroll
          for (int p = 0; p < 4; ++p)
            sc[p][e] = (p < 2 || kGated) && jc < j_end ? __ldg(a.su[p] + sj)
                                                       : 0.f;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * jj + 2 * hh;
        float h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float u = up[i + e], v = kGated ? gate[i + e] : 0.f;
          if constexpr (kQ) {
            u = up[i + e] * sc[0][e] + up2[i + e] * sc[1][e];
            if (kGated) v = gate[i + e] * sc[2][e] + gate2[i + e] * sc[3][e];
          }
          h[e] = kGated ? silu(v) * u : activate(a.act, u);
        }
        const __nv_bfloat162 v = __floats2bfloat162_rn(h[0], h[1]);
        const int r = 16 * warp + lane / 4 + 8 * hh;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         hs + tc::tile_off<true>(r, col)),
                     "r"(*reinterpret_cast<const uint32_t*>(&v)));
      }
    }
    // the down tiles landed: their group is waited for here if the up
    // stages did not reach it (few k tiles)
    const int t_last = jt * KT + KT - 1;
    if (d_group > t_last) cp_async_wait_n(t_last + kAhead - d_group);
    if constexpr (kQ) {   // every warpgroup's down of tile jt - 1 is done
      __syncthreads();
#pragma unroll 1
      for (int c = 0; c < 2; ++c)
        qtc::convert<W, kO>(dr + c * qtc::raw_bytes<kO>(),
                            ds + c * (kO / kRows) * kTile);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // z_w += h wd_w^T over the tile's live k steps
    const int nk = (live + 15) / 16;
    const uint32_t dw = ds + w * (kO / kRows) * kTile;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll 1
    for (int ks = 0; ks < nk; ++ks) {
      if constexpr (kQ)
        tc::wgmma_m64n128k16<0, 0>(acc, desc_k(hs + ks * 32),
                                   desc_k(dw + ks * 32), jt > 0 || ks > 0);
      else
        wgmma_m64n256k16(acc, desc_k(hs + ks * 32), desc_k(dw + ks * 32),
                         jt > 0 || ks > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  tc::cp_async_wait<0>();
  tc::fence_acc(acc);

  // warpgroup w writes z_w (or its fp32 partial of split s); fragment
  // register 4 jj + 2 hh + e: row 16 warp + lane / 4 + 8 hh, output
  // 8 jj + 2 (lane % 4) + e; payloads: each output's sum times its down
  // scale, once, here
  const long long per = (long long)a.M * a.n * a.d_out;
  __nv_bfloat16* z = static_cast<__nv_bfloat16*>(a.z[w]);
  const long long z_sb = a.z_sb[w], z_sg = a.z_sg[w], z_so = a.z_so[w];
  // (rows outer: with the outputs outer the decode rows, M 8, took 1.45x
  // as long on an H100)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = m0 + 16 * warp + lane / 4 + 8 * hh;
    if (m >= a.M) continue;
#pragma unroll
    for (int jj = 0; jj < kO / 8; ++jj) {
      const int o = o0 + 8 * jj + 2 * (lane % 4);
      float v0 = acc[4 * jj + 2 * hh], v1 = acc[4 * jj + 2 * hh + 1];
      if (o >= a.d_out) continue;
      const bool both = o + 1 < a.d_out;
      if constexpr (kQ) {
        const float* sd = a.sd[w] + (long long)g * a.d_out + o;
        v0 *= __ldg(sd);
        v1 *= both ? __ldg(sd + 1) : 0.f;
      }
      if (a.part) {
        float* d = a.part + (2LL * s + w) * per +
                   ((long long)m * a.n + g) * a.d_out + o;
        const bool pair =
            both && (reinterpret_cast<unsigned long long>(d) & 7) == 0;
        tc::store2(d, pair, v0, v1);
        if (!pair) {
          d[0] = v0;
          if (both) d[1] = v1;
        }
      } else {
        __nv_bfloat16* d = z + m * z_sb + g * z_sg + o * z_so;
        const bool pair =
            both && z_so == 1 &&
            (reinterpret_cast<unsigned long long>(d) & 3) == 0;
        tc::store2(d, pair, v0, v1);
        if (!pair) {
          d[0] = __float2bfloat16(v0);
          if (both) d[z_so] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// fp32 weights to bf16 (round to nearest even, as a cast before the
// call), all of a call's in one launch: weight i's cnt[i] elements from
// src[i] to dst + off[i]
struct CastArgs {
  const float* src[6];
  long long cnt[6], off[6];
  __nv_bfloat16* dst;
  int segs;
};

__global__ void __launch_bounds__(256) dyad_ff_cast_kernel(CastArgs c) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (int i = 0; i < c.segs; ++i) {
    const float* src = c.src[i];
    __nv_bfloat16* dst = c.dst + c.off[i];
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < c.cnt[i]; e += step)
      dst[e] = __float2bfloat16(__ldg(src + e));
  }
}

// casts a's fp32 weights (wu1, wu2, wg1, wg2, wd1, wd2 where present)
// into buf, each from a 16-byte boundary (the wrapper's ff_cast_elems),
// and points a at the copies
inline cudaError_t cast_weights(FFArgs& a, __nv_bfloat16* buf,
                                cudaStream_t stream) {
  const int ups = a.act == kSwiglu ? 4 : 2;
  const long long up_n = (long long)a.n * a.d_ff * a.d_in;
  const long long down_n = (long long)a.n * a.d_out * a.d_ff;
  CastArgs c{};
  c.dst = buf;
  long long off = 0, most = 0;
  for (int i = 0; i < ups + 2; ++i) {
    const bool up = i < ups;
    c.src[i] = static_cast<const float*>(up ? a.wu[i] : a.wd[i - ups]);
    c.cnt[i] = up ? up_n : down_n;
    c.off[i] = off;
    (up ? a.wu[i] : a.wd[i - ups]) = buf + off;
    off += (c.cnt[i] + 7) / 8 * 8;
    most = c.cnt[i] > most ? c.cnt[i] : most;
  }
  c.segs = ups + 2;
  const long long blocks = (most + 255) / 256;
  dyad_ff_cast_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0,
                        stream>>>(c);
  return cudaGetLastError();
}

// bf16 x, with bf16 weights or (W a payload type) int8 / fp8 payloads and
// their scales; the caller adds a split's partials (dyad_ff.cu)
template <typename W>
inline cudaError_t launch(const FFArgs& a, cudaStream_t stream) {
  using P = Plan<W>;
  // x resident for d_in <= 256; a split range starts on a 16-byte run of
  // the down rows (8 bf16, 16 payloads), so their copies stay aligned
  if (a.d_in > kMaxIn || a.span % (P::kQ ? 16 : 8))
    return cudaErrorInvalidValue;
  if (P::kQ && !(a.su[0] && a.su[1] && a.sd[0] && a.sd[1] &&
                 (a.act != kSwiglu || (a.su[2] && a.su[3]))))
    return cudaErrorInvalidValue;
  const bool gated = a.act == kSwiglu;
  Loads f;
  f.x[0] = tc::load_of(a.x1, a.x1_sk, a.x1_sb, a.x1_sg, a.n);
  f.x[1] = tc::load_of(a.x2, a.x2_sk, a.x2_sb, a.x2_sg, a.n);
  // payloads: kCopy where every row starts on 16 bytes, else byte by byte
  auto load_w = [&](const void* p, long long row, long long per_g) -> int {
    if constexpr (P::kQ)
      return qtc::vec_ok(p, row) ? tc::kCopy : tc::kGather;
    else
      return tc::load_of(p, 1, row, per_g, a.n);
  };
  f.wu = f.wd = tc::kCopy;
  for (int i = 0; i < (gated ? 4 : 2); ++i)
    if (load_w(a.wu[i], a.d_in, (long long)a.d_ff * a.d_in) != tc::kCopy)
      f.wu = tc::kGather;
  for (int c = 0; c < 2; ++c)
    if (load_w(a.wd[c], a.d_ff, (long long)a.d_out * a.d_ff) != tc::kCopy)
      f.wd = tc::kGather;
  auto kernel =
      gated ? dyad_ff_tc_kernel<true, W> : dyad_ff_tc_kernel<false, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  const int o_tiles = (a.d_out + P::kO - 1) / P::kO;
  dim3 grid(o_tiles * a.split, (a.M + kRows - 1) / kRows, a.n);
  kernel<<<grid, kThreads, P::kSmem, stream>>>(a, f);
  return cudaGetLastError();
}

}  // namespace fftc
}  // namespace repro
