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
// stage.
//
// fp32 runs on split TF32: dyad_dgrad_tf32_kernel<true, 96>,
// dyad_mm_dgrad_two's transposed kernel (dyad_gemm_tf32.cuh) with Fuse.
// dx^T = sum_c w_c^T z_c^T, w^T the register A read as w lies, z the
// K-major B: z1 copied and split in place, the stride-n z2bar gathered
// (its loads an iteration ahead of its stores) and split as it is stored.
// Each tile's 32-o stages run over component 1's o range, then component
// 2's, into one accumulator, still a fresh partial a stage; the grid's z
// axis is n, and tiles_of counts both components' stages.  Tiles of 64 i x
// 96 rows: the 24 registers a thread of the deferred gather fit beside the
// accumulators (at 128 rows they did not).  dx is written through its own
// strides (a quad's lanes on 32 contiguous bytes of a row).  At OPT-125m's
// OT dx (M 4096, n 4, up 768 -> 192 and down 192 -> 768 blocks) a call
// does 9.7 GFLOP on about 28 MB: 0.059 ms as three TF32 products at 495
// TFLOP/s (0.144 ms at fp32 FMA's 67), operations.
#include "dyad_gemm_tf32.cuh"

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
    case repro::kF32: {   // split TF32, transposed: D = dx^T, A = w, B = z
      repro::tf32t::Args t{{w1, w2},       {w_sg, w_sg},   {d_in, d_in},
                           {1, 1},         {z1, z2},       {z1_sg, z2_sg},
                           {z1_sb, z2_sb}, {z1_so, z2_so}, {dx, dx},
                           {dx_sg, dx_sg}, {dx_si, dx_si}, {dx_sb, dx_sb},
                           nullptr,        0,              n,
                           d_in,           M,              d_out,
                           1,              d_out};
      return repro::tf32t::launch_dgrad<true, 96>(t, s);
    }
    case repro::kBF16:   // A = z (b x o) K-major, B = w[g] (o x i) N-major
      return repro::tc::launch<true, false, __nv_bfloat16, true>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
