// dyad_mm_dgrad: the DYAD input cotangent with both components in one fp32
// accumulator,
//
//   dx[b, g, i] = sum_o z1[b, g, o] * w1[g, o, i] + sum_o z2[b, g, o] * w2[g, o, i]
//
// valid where both dx components share the block layout: the OT input
// cotangent, and the down projection's dh in the ff backward.  Replaces
// the TPU kernel src/repro/kernels/dyad_mm.py: dyad_mm_dgrad
// (_dgrad_kernel, pallas_call in _dgrad_impl with fused=True).
//
// z1 and z2 are read through their (b, g, o) strides (the OT z2bar is the
// stride-n view of the output cotangent), dx written through its own; the
// weights are read in place as (n, d_out, d_in), contracted over o with no
// transposed copy.  Ragged edges are masked on load and store.
//
// Bound on the H100: at Qwen3-0.6B's training rows (M = 4096, n = 4,
// d_out 256 -> d_in 768) a call does 12.9 GFLOP on about 35 MB in bf16:
// 0.013 ms on the bf16 tensor cores against 0.010 ms of bytes.  bf16 takes
// the tensor-core mainloop of dyad_gemm_tc.cuh with Fuse: one GEMM per
// dyad block whose k stages run over component 1's o range and then
// component 2's into one fp32 accumulator, 128 x 128 tiles of dx, z staged
// K-major (z1 copied, the stride-n z2bar gathered) and w N-major, 64 o per
// stage.  fp32 takes the FMA mainloop of dyad_gemm.cuh in the same order,
// bound by fp32 FMA operations (its 3xTF32 mainloop is later work).
#include "dyad_gemm_tc.cuh"

extern "C" int repro_dyad_mm_dgrad(
    const void* z1, const void* z2, const void* w1, const void* w2, void* dx,
    int M, int n, int d_in, int d_out, long long z1_sb, long long z1_sg,
    long long z1_so, long long z2_sb, long long z2_sg, long long z2_so,
    long long dx_sb, long long dx_sg, long long dx_si, int dtype,
    void* stream) {
  const long long w_sg = (long long)d_out * d_in;
  // C_0[g] = dx (M x d_in); A_c[g] = z_c (M x d_out), B_c[g] = w_c[g]
  repro::DyadGemmArgs a{{z1, z2},       {z1_sg, z2_sg}, {z1_sb, z2_sb},
                        {z1_so, z2_so}, {w1, w2},       {w_sg, w_sg},
                        {d_in, d_in},   {1, 1},         {dx, dx},
                        {dx_sg, dx_sg}, {dx_sb, dx_sb}, {dx_si, dx_si},
                        nullptr,        n,              M,
                        d_in,           d_out,          1,
                        d_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::gemm::launch<float, float, true>(a, s);
    case repro::kBF16:   // A = z (b x o) K-major, B = w[g] (o x i) N-major
      return repro::tc::launch<true, false, __nv_bfloat16, true>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
