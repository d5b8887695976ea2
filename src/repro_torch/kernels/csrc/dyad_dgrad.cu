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
// Bound on the H100: at Qwen3-0.6B's training rows (M = 4096, n = 4, the
// up projection's 256 -> 768 blocks, so d_in 256 and d_out 768 here) a
// call does 12.9 GFLOP on about 45 MB in bf16: 0.013 ms on the bf16 tensor
// cores, 0.0135 ms of bytes (dx1 and dx2 are a third of them).  bf16 takes
// the tensor-core mainloop of dyad_gemm_tc.cuh: one GEMM per (component,
// dyad block), 128 x 128 tiles of dx_c, z staged K-major (the IT cotangent
// view copied with cp.async; a stride-n DT z2 gathered through registers)
// and w[g] N-major, 64 o per stage.  The permuted dx2 has column stride n,
// so its epilogue stores single elements, not pairs.
//
// fp32, split TF32 (dyad_dgrad_tf32_kernel<false, 128> of dyad_gemm_tf32.cuh,
// whose header holds the design): at OPT-125m's training shapes (d_in x
// d_out = 192 x 768 or 768 x 192, M 4096) a call does 9.7 GFLOP on about 28
// MB: 0.059 ms as three TF32 products at 495 TFLOP/s (0.144 ms at fp32
// FMA's 67), operations.  tf32 wgmma reads its shared operands K-major only
// (k = o here), and w[g] lies o x i, i contiguous: as the B of dx = z w it
// is N-major.  So the product runs transposed,
//
//   dx_c^T[i, r] = sum_o w_c[g][o, i] z_c[r, g, o]
//
// with w^T as wgmma's register A, read from w's tile as it lies (16-byte
// copies along i), and z (o contiguous) as the K-major B, copied raw and
// split in place (a DT strided z2 gathered and split as it is stored): no
// transpose pass, and w's copies coalesced (the tensor-core mainloop's own
// instantiation for fp32 would gather w element by element at a stride of
// d_in).  A block is one warpgroup over 64 i x 128 rows of dx_c^T (64 i
// tiles d_in 192 and 768 exactly), up to four row tiles in turn through
// one pipeline where d_out is short; two blocks an SM.  The epilogue writes
// the transposed accumulator into dx_c (i along a quad's lanes: 32
// contiguous bytes of a dx1 row a store; the permuted dx2, column stride
// n, a 4-byte element each).
#include "dyad_gemm_tf32.cuh"

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
    case repro::kF32: {   // split TF32, transposed: D = dx^T, A = w, B = z
      repro::tf32t::Args t{{w1, w2},       {w_sg, w_sg},   {d_in, d_in},
                           {1, 1},         {z1, z2},       {z1_sg, z2_sg},
                           {z1_sb, z2_sb}, {z1_so, z2_so}, {dx1, dx2},
                           {d1_sg, d2_sg}, {d1_si, d2_si}, {d1_sb, d2_sb},
                           nullptr,        0,              n,
                           d_in,           M,              d_out,
                           1,              d_out};
      return repro::tf32t::launch_dgrad<false, 128>(t, s);
    }
    case repro::kBF16:   // A = z (b x o) K-major, B = w[g] (o x i) N-major
      return repro::tc::launch<true, false, __nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
