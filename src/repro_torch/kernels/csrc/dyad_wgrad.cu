// dyad_mm_wgrad: both DYAD weight cotangents in one launch, fp32 sums, one
// cast to the output dtype,
//
//   dw1[g, o, i] = sum_b z1[b, g, o] * x1[b, g, i]
//   dw2[g, o, i] = sum_b z2[b, g, o] * x2[b, g, i]
//
// Replaces the TPU kernel src/repro/kernels/dyad_mm.py: dyad_mm_wgrad
// (_wgrad_kernel, pallas_call in _wgrad_impl).
//
// x1, x2, z1 and z2 are read through their (b, g, inner) strides: for IT
// the caller passes x1 = x viewed (M, n, d_in), x2 = the stride-n view
// x[b, i * n + g] (strides (f_in, 1, n)) and z1 = z2 = the output
// cotangent viewed (M, n, d_out); the OT down projection x1 = x2 and the
// stride-n z2bar.  No view is materialised.
//
// The TPU kernel runs the batch reduction as the innermost, sequential
// grid axis with the accumulators carried in VMEM.  Here each
// (component, dyad block) is one GEMM over the M rows.  Where the tiles
// alone leave SMs idle, the wrapper splits the M rows into `split` ranges
// (dyad_mm.wgrad_split): each block then writes fp32 partial sums and a
// second pass adds them in a fixed order and casts, so the result does
// not depend on the run (no atomics).
//
// bf16 operands take the tensor-core mainloop of dyad_gemm_tc.cuh, C =
// z^T x: 128 x 128 tiles of dw, both operands staged MN-major (z is
// contiguous along o, x along i; the IT x2 and the OT z2bar are gathered),
// 64 rows of M per stage.  At Qwen3-0.6B's training rows (M = 4096, n = 4,
// 768 x 256 blocks) a call does 12.9 GFLOP on about 25 MB: 0.013 ms on the
// bf16 tensor cores, which bound it; at 96 tiles it needs no split.
//
// fp32 operands (dw in fp32 or bf16) run on split TF32: the
// dyad_wgrad_tf32_kernel of dyad_gemm_tf32.cuh, whose header holds the
// design.  tf32 wgmma reads its shared operands K-major only (k = the M
// rows here) and neither z nor x lies so: one of them is wgmma's register
// A, read as it lies from its staged [32 rows][64] tile (16-byte copies
// along its contiguous axis, a stride-n view element by element, the
// loads an iteration ahead) and split in registers; the other is the B,
// its 16-byte row runs copied so that each thread's 4 x 4 blocks land
// where their K-major chunks will lie, then read back, transposed in
// registers and split in place: the transpose costs no pass of its own.
// x_as_a picks which (dyad_mm.wgrad_orient: the way with fewer 64 x 96
// tiles, on a tie the operand with a stride-n view; at OPT-125m's 192 x 768
// up and 768 x 192 down blocks both ways take 24 tiles, so A is x for the
// IT views and z for the OT ones, each gathered along A's contiguous tile
// rows).  One warpgroup a block, 64 x 96 of dw (or dw^T), 32 rows a stage,
// two stages, 67 KB: two blocks an SM.  At OPT's 192 tiles a call, on 264
// block slots, the rows are split into the ranges wgrad_split picks to fill
// whole waves of them (4); each split adds 2 * n * d_out * d_in fp32
// partials written and read back (4.7 MB each way at OPT's widths).
// Bound: a call at OPT-125m's rows (M 4096, n 4) does 9.7 GFLOP on about 68
// MB: 0.059 ms as three TF32 products at 495 TFLOP/s (0.144 ms at fp32
// FMA's 67), operations.
#include <utility>

#include "dyad_gemm_tf32.cuh"

extern "C" int repro_dyad_mm_wgrad(
    const void* x1, const void* x2, const void* z1, const void* z2,
    void* dw1, void* dw2, float* part, int M, int n, int d_in, int d_out,
    int split, int rows, int x_as_a, long long x1_sb, long long x1_sg,
    long long x1_si, long long x2_sb, long long x2_sg, long long x2_si,
    long long z1_sb, long long z1_sg, long long z1_so, long long z2_sb,
    long long z2_sg, long long z2_so, int dtype, int out_dtype,
    void* stream) {
  if (split < 1 || rows < 1 || (split > 1 && !part))
    return cudaErrorInvalidValue;
  const long long w_sg = (long long)d_out * d_in;
  // C_c[g] = dw_c[g] (d_out x d_in), summed over b: A_c[g][o, b] =
  // z_c[b, g, o], B_c[g][b, i] = x_c[b, g, i]; also the reduce's view of dw
  repro::DyadGemmArgs a{{z1, z2},       {z1_sg, z2_sg}, {z1_so, z2_so},
                        {z1_sb, z2_sb}, {x1, x2},       {x1_sg, x2_sg},
                        {x1_sb, x2_sb}, {x1_si, x2_si}, {dw1, dw2},
                        {w_sg, w_sg},   {d_in, d_in},   {1, 1},
                        split > 1 ? part : nullptr,     n,
                        d_out,          d_in,           M,
                        split,          rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  namespace tc = repro::tc;
  namespace t32 = repro::tf32t;
  if (dtype == repro::kF32) {
    // D = dw^T (A = x, B = z) or dw (A = z, B = x), through dw's strides;
    // the partials laid out as dw
    t32::Args t{{x1, x2},       {x1_sg, x2_sg}, {x1_sb, x2_sb},
                {x1_si, x2_si}, {z1, z2},       {z1_sg, z2_sg},
                {z1_so, z2_so}, {z1_sb, z2_sb}, {dw1, dw2},
                {w_sg, w_sg},   {1, 1},         {d_in, d_in},
                a.part,         w_sg,           n,
                d_in,           d_out,          M,
                split,          rows};
    if (!x_as_a) {
      for (int c = 0; c < 2; ++c) {
        std::swap(t.A[c], t.B[c]);
        std::swap(t.a_sg[c], t.b_sg[c]);
        t.a_sk[c] = c ? z2_sb : z1_sb;
        t.a_sm[c] = c ? z2_so : z1_so;
        t.b_sj[c] = c ? x2_si : x1_si;
        t.b_sk[c] = c ? x2_sb : x1_sb;
        std::swap(t.c_sm[c], t.c_sj[c]);
      }
      std::swap(t.Mx, t.Jx);
    }
    if (out_dtype == repro::kF32)
      return t32::launch_wgrad<float, 96>(t, a, s);
    if (out_dtype == repro::kBF16)
      return t32::launch_wgrad<__nv_bfloat16, 96>(t, a, s);
    return cudaErrorInvalidValue;
  }
  if (rows % tc::kBK) return cudaErrorInvalidValue;
  // bf16: A = z^T (o x b) and B = x (b x i), both staged MN-major
  if (dtype == repro::kBF16 && out_dtype == repro::kF32)
    return tc::launch<false, false, float>(a, s);
  if (dtype == repro::kBF16 && out_dtype == repro::kBF16)
    return tc::launch<false, false, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}
