// The arguments of the batched, strided DYAD GEMMs on the tensor cores
// (dyad_gemm_tc.cuh's mainloop, dyad_gemm_tf32.cuh's transposed kernels)
// and the split reduction that each one's row or k split ends with:
//
//   C_c[g][r, j] = sum_{k in [k_begin, k_end)} A_c[g][r, k] * B_c[g][k, j]
//
// for two components c (BLOCKDIAG, BLOCKTRANS) and n dyad blocks g, every
// operand read or written through its own (g, row, column) strides, so the
// caller passes the DYAD views (the stride-n x2, the permuted dx2, a
// transposed cotangent) as they are.  grid.z runs over (split, c, g): with
// split > 1 each block sums one range of k and writes fp32 partials for a
// second pass (dyad_gemm_reduce) to add in a fixed order.  With Fuse the
// two components sum into one accumulator and C_0 (grid.z over g only,
// split 1):
//
//   C_0[g][r, j] = sum_k A_0[g][r, k] B_0[g][k, j] + sum_k A_1[g][r, k] B_1[g][k, j]
//
// component 0's k range first, then component 1's.
#pragma once

#include "common.cuh"

namespace repro {

struct DyadGemmArgs {
  const void* A[2];
  long long a_sg[2], a_sr[2], a_sk[2];
  const void* B[2];
  long long b_sg[2], b_sk[2], b_sj[2];
  void* C[2];
  long long c_sg[2], c_sr[2], c_sj[2];
  float* part;       // (split, 2, n, R, N) fp32 when split > 1
  int n, R, N, K;    // C is R x N per (c, g); K summed in split ranges
  int split, krows;  // krows: the k range of one split, a whole number of
                     // the kernel's stages
};

namespace gemm {

// second pass for split > 1: C_c[g][r, j] = the partials added in split
// order, cast once
template <typename O>
__global__ void dyad_gemm_reduce(DyadGemmArgs a) {
  const long long RN = (long long)a.R * a.N;
  const long long total = 2LL * a.n * RN;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float sum = 0.f;
  for (int s = 0; s < a.split; ++s) sum += a.part[s * total + e];
  const int c = (int)(e / (a.n * RN));
  const int g = (int)((e / RN) % a.n);
  const long long rj = e % RN;
  const int r = (int)(rj / a.N), j = (int)(rj % a.N);
  O* C = static_cast<O*>(a.C[c]) + g * a.c_sg[c];
  C[r * a.c_sr[c] + j * a.c_sj[c]] = from_f32<O>(sum);
}

}  // namespace gemm
}  // namespace repro
