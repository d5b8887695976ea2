// dyad_mm_blocks_two: the DYAD forward with the two components emitted
// apart (the OT and DT forward; the caller applies ref.combine),
//
//   z1[b, g, o] = sum_k x1[b, g, k] * w1[g, o, k]
//   z2[b, g, o] = sum_k x2[b, g, k] * w2[g, o, k]
//
// Replaces the TPU kernel src/repro/kernels/dyad_mm.py: dyad_mm_blocks_two
// (_dyad_kernel_two, pallas_call in _dyad_mm_two_impl).
//
// x1, x2, z1 and z2 are read and written through their (b, g, inner)
// strides: the DT x2 is the stride-n view of the flat input, and the
// wrapper hands z2 over as an (M, n, d_out) view of a contiguous
// (M, d_out, n) buffer, so the OT/DT re-view of component 2 in
// ref.combine (transpose, then reshape) is a free reshape plus one add.
// The weights are read in place as (n, d_out, d_in).  Ragged edges are
// masked on load and store; there are no padded copies.
//
// Bound on the H100: at the training rows of OPT-125m (M = 4096, n = 4,
// 192 x 768) a call does 4.8 GFLOP per component on about 20 MB, so fp32
// operations bound it; at Qwen3-0.6B's split ff (d_ff_b 768 -> d_out 256)
// likewise.  Each (component, dyad block) is one GEMM of the shared FMA
// kernel in dyad_gemm.cuh (128 x 64 tiles, 8 x 8 per thread, two
// shared-memory stages); no tensor cores yet.
#include "dyad_gemm.cuh"

extern "C" int repro_dyad_mm_blocks_two(
    const void* x1, const void* x2, const void* w1, const void* w2, void* z1,
    void* z2, int M, int n, int d_in, int d_out, long long x1_sb,
    long long x1_sg, long long x1_sk, long long x2_sb, long long x2_sg,
    long long x2_sk, long long z1_sb, long long z1_sg, long long z1_so,
    long long z2_sb, long long z2_sg, long long z2_so, int dtype,
    void* stream) {
  const long long w_sg = (long long)d_out * d_in;
  // C_c[g] = z_c (M x d_out), A_c[g] = x_c (M x d_in), B_c[g][k, o] =
  // w_c[g, o, k]
  repro::DyadGemmArgs a{{x1, x2},       {x1_sg, x2_sg}, {x1_sb, x2_sb},
                        {x1_sk, x2_sk}, {w1, w2},       {w_sg, w_sg},
                        {1, 1},         {d_in, d_in},   {z1, z2},
                        {z1_sg, z2_sg}, {z1_sb, z2_sb}, {z1_so, z2_so},
                        nullptr,        n,              M,
                        d_out,          d_in,           1,
                        d_in};
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
