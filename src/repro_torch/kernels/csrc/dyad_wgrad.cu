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
// cotangent viewed (M, n, d_out).  No view is materialised.
//
// The TPU kernel runs the batch reduction as the innermost, sequential
// grid axis with the accumulators carried in VMEM.  Here each
// (component, dyad block) is one GEMM, C = z^T x over the M rows.  bf16
// operands take the tensor-core mainloop of dyad_gemm_tc.cuh: 128 x 128
// tiles of dw, both operands staged MN-major (z is contiguous along o, x
// along i; the IT x2 and the OT z2bar are gathered), 64 rows of M per
// stage.  fp32 operands take the FMA mainloop of dyad_gemm.cuh (128 x 64
// tiles).  Where the tiles alone leave SMs idle, the wrapper splits the M
// rows into `split` ranges (dyad_mm.wgrad_split): each block then writes
// fp32 partial sums and a second pass adds them in a fixed order and
// casts, so the result does not depend on the run (no atomics).
//
// Bound on the H100: a call at Qwen3-0.6B's training rows (M = 4096, n = 4,
// 768 x 256 blocks) does 12.9 GFLOP on about 25 MB in bf16: 0.013 ms on
// the bf16 tensor cores, which bound it; at 96 tiles it needs no split, so
// no partials cross device memory.  An fp32 call at OPT-125m's rows (9.7
// GFLOP, plus 2 * split * 2.4 MB of partials) is bound by fp32 FMA
// operations; its tensor-core (3xTF32) mainloop is later work.
#include "dyad_gemm_tc.cuh"

extern "C" int repro_dyad_mm_wgrad(
    const void* x1, const void* x2, const void* z1, const void* z2,
    void* dw1, void* dw2, float* part, int M, int n, int d_in, int d_out,
    int split, int rows, long long x1_sb, long long x1_sg, long long x1_si,
    long long x2_sb, long long x2_sg, long long x2_si, long long z1_sb,
    long long z1_sg, long long z1_so, long long z2_sb, long long z2_sg,
    long long z2_so, int dtype, int out_dtype, void* stream) {
  const int step =
      dtype == repro::kBF16 ? repro::tc::kBK : repro::gemm::kBK;
  if (split < 1 || rows < 1 || rows % step || (split > 1 && !part))
    return cudaErrorInvalidValue;
  const long long w_sg = (long long)d_out * d_in;
  // C_c[g] = dw_c[g] (d_out x d_in), A_c[g][o, b] = z_c[b, g, o],
  // B_c[g][b, i] = x_c[b, g, i], summed over b
  repro::DyadGemmArgs a{{z1, z2},       {z1_sg, z2_sg}, {z1_so, z2_so},
                        {z1_sb, z2_sb}, {x1, x2},       {x1_sg, x2_sg},
                        {x1_sb, x2_sb}, {x1_si, x2_si}, {dw1, dw2},
                        {w_sg, w_sg},   {d_in, d_in},   {1, 1},
                        split > 1 ? part : nullptr,     n,
                        d_out,          d_in,           M,
                        split,          rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  namespace gemm = repro::gemm;
  namespace tc = repro::tc;
  if (dtype == repro::kF32 && out_dtype == repro::kF32)
    return gemm::launch<float, float>(a, s);
  if (dtype == repro::kF32 && out_dtype == repro::kBF16)
    return gemm::launch<float, __nv_bfloat16>(a, s);
  // bf16: A = z^T (o x b) and B = x (b x i), both staged MN-major
  if (dtype == repro::kBF16 && out_dtype == repro::kF32)
    return tc::launch<false, false, float>(a, s);
  if (dtype == repro::kBF16 && out_dtype == repro::kBF16)
    return tc::launch<false, false, __nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}
