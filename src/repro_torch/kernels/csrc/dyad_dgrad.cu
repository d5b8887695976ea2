// dyad_mm_dgrad_two: the DYAD input cotangent, one component per output,
//
//   dx1[b, g, i] = sum_o z1[b, g, o] * w1[g, o, i]
//   dx2[b, g, i] = sum_o z2[b, g, o] * w2[g, o, i]
//
// Replaces the TPU kernel src/repro/kernels/dyad_mm.py: dyad_mm_dgrad_two
// (_dgrad_kernel_two, pallas_call in _dgrad_impl with fused=False).
//
// z1, z2, dx1 and dx2 are read and written through their (b, g, inner)
// strides, so the caller passes the views it has and no copy is made:
//  - for IT, z1 = z2 = the output cotangent viewed (M, n, d_out);
//  - dx2 may be a strided view, e.g. (M, n, d_in) with strides
//    (n * d_in, 1, n) over a contiguous (M, d_in, n) buffer: the IT/DT
//    un-view (transpose of the last two axes, then add) becomes a free
//    reshape, as in the reference's direct lowering (bgo,goi->big).
// The weights are read in place as (n, d_out, d_in): the contraction runs
// over o, with no transposed copy.  Ragged edges are masked on load and
// store; there are no padded copies.
//
// Bound on the H100: at the OPT-125m training shapes (M = 4096 rows,
// d_in x d_out = 192 x 768 or 768 x 192, n = 4) a call does 9.7 GFLOP on
// about 28 MB, so fp32 operations bound it.  Each (component, dyad block)
// is one GEMM of the shared FMA kernel in dyad_gemm.cuh (128 x 64 tiles,
// 8 x 8 per thread, two shared-memory stages); no tensor cores yet.
#include "dyad_gemm.cuh"

extern "C" int repro_dyad_mm_dgrad_two(
    const void* z1, const void* z2, const void* w1, const void* w2,
    void* dx1, void* dx2, int M, int n, int d_in, int d_out,
    long long z1_sb, long long z1_sg, long long z1_so, long long z2_sb,
    long long z2_sg, long long z2_so, long long d1_sb, long long d1_sg,
    long long d1_si, long long d2_sb, long long d2_sg, long long d2_si,
    int dtype, void* stream) {
  const long long w_sg = (long long)d_out * d_in;
  // C_c[g] = dx_c (M x d_in), A_c[g] = z_c (M x d_out), B_c[g] = w_c[g]
  repro::DyadGemmArgs a{{z1, z2},      {z1_sg, z2_sg}, {z1_sb, z2_sb},
                        {z1_so, z2_so}, {w1, w2},      {w_sg, w_sg},
                        {d_in, d_in},   {1, 1},        {dx1, dx2},
                        {d1_sg, d2_sg}, {d1_sb, d2_sb}, {d1_si, d2_si},
                        nullptr,        n,             M,
                        d_in,           d_out,         1,
                        d_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::gemm::launch<float, float>(a, s);
    case repro::kBF16:
      return repro::gemm::launch<__nv_bfloat16, __nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
