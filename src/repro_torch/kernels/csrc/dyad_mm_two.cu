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
// operations bound it: up + down, 19.3 GFLOP, take 0.117 ms as three TF32
// products at 495 TFLOP/s (0.289 ms at the 67 TFLOP/s of fp32 FMA)
// against 0.040 ms of bytes; Qwen3-0.6B's split-route down projection
// (M 4096, d_ff_b 768 -> d_out_b 256, bf16) does 12.9 GFLOP on 45 MB:
// 0.013 ms on the bf16 tensor cores, 0.0135 ms of bytes.  Each (component,
// dyad block) is one GEMM on the tensor-core mainloop of dyad_gemm_tc.cuh
// (128 x 128 tiles of z_c, wgmma), at every row count, A = x and B = w[g]
// (o rows of k) both K-major, the components apart (no Fuse): x1 and the
// weights copied with cp.async, the stride-n x2 (the DT view) gathered
// through registers, z2 written through its permuted strides.
//  - bf16: one wgmma product per pair, 64-deep cp.async stages (the stride-n
//    x2 from the 16-byte runs at n = 4).  It runs the split ff route (the
//    ff demotion rung of the continuous engine, REPRO_KERNEL_FF=split) and
//    the bf16 OT/DT forward.  At Qwen3's decode rows (M 8) it is faster
//    than the FMA kernel too, so there is no cut by M.
//  - fp32 (OPT-125m's OT and DT train steps): split TF32, as dyad_mm.cu's
//    fp32 forward runs it (the same mainloop, 32-deep stages, three tf32
//    products a pair, each stage's products summed into a partial of its
//    own and added into the accumulator with fp32 adds; the error model in
//    dyad_gemm_tc.cuh's header), with z1 and z2 apart: the OT x2 (= x1) is
//    copied, the DT x2 gathered element by element.  z2's elements, 4
//    bytes in every 16 for one block, written one by one took the OT up
//    projection (6 stages of k a block) 0.339 ms against 0.198 with z2
//    contiguous (tools/two_store.py), so there the four blocks of a tile
//    write it together as one cluster (store_xchg, 0.226 ms); the down
//    projection (24 stages) writes them one by one.
#include "dyad_gemm_tc.cuh"

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
      return repro::tc::launch<true, true, float, false, float>(a, s);
    case repro::kBF16:
      return repro::tc::launch<true, true, __nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
