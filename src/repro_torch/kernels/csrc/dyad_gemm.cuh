// A batched, strided fp32-accumulating FMA GEMM shared by the DYAD kernels
// that are plain products (dyad_dgrad.cu, dyad_dgrad_fused.cu,
// dyad_wgrad.cu, dyad_mm_two.cu):
//
//   C_c[g][r, j] = sum_{k in [k_begin, k_end)} A_c[g][r, k] * B_c[g][k, j]
//
// for two components c (BLOCKDIAG, BLOCKTRANS) and n dyad blocks g, every
// operand read or written through its own (g, row, column) strides, so the
// caller passes the DYAD views (the stride-n x2, the permuted dx2, a
// transposed cotangent) as they are.  grid.z runs over (split, c, g): with
// split > 1 each block sums one range of k and writes fp32 partials for a
// second pass to add in a fixed order.  With Fuse the two components sum
// into one accumulator and C_0 (grid.z over g only, split 1):
//
//   C_0[g][r, j] = sum_k A_0[g][r, k] B_0[g][k, j] + sum_k A_1[g][r, k] B_1[g][k, j]
//
// component 0's k range first, then component 1's.
//
// Tiling: a block of 128 threads owns a 128 x 64 tile of C; each thread
// keeps an 8 x 8 register tile (rows 8 ty .. 8 ty + 7, columns
// 4 tx .. 4 tx + 3 and 32 + 4 tx .. 32 + 4 tx + 3), so a k step reads 16
// shared-memory values for 64 FMAs (4 x 4 tiles read 8 for 16, which the
// H100's shared-memory bandwidth caps at about half the FMA rate), and the
// 8 threads along a row write 128 contiguous bytes of C per store.  Tiles
// of A and B, 8 deep in k, stream through two shared-memory stages: the
// global loads of step k + 1 are in flight while step k computes.  Loads
// follow whichever axis of an operand is contiguous.
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
  int split, krows;  // krows: the k range of one split, a multiple of kBK
};

namespace gemm {

constexpr int kBM = 128, kBN = 64, kBK = 8;
constexpr int kTM = 8, kTN = 8;
// shared-memory row pitches: +4 floats keeps rows 16-byte aligned for the
// float4 reads and spreads the k-major stores over the banks
constexpr int kPA = kBM + 4, kPB = kBN + 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 128
constexpr int kAPer = kBM * kBK / kThreads;           // 8
constexpr int kBPer = kBN * kBK / kThreads;           // 4

template <typename T>
__device__ __forceinline__ void load_a(const T* A, long long sr, long long sk,
                                       int r0, int k0, int R, int k_end,
                                       float (&reg)[kAPer]) {
  const bool k_fast = sk == 1;   // contiguous along k: threads walk k
#pragma unroll
  for (int p = 0; p < kAPer; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int r = k_fast ? e / kBK : e % kBM;
    const int k = k_fast ? e % kBK : e / kBM;
    const int rr = r0 + r, kk = k0 + k;
    reg[p] = (rr < R && kk < k_end) ? to_f32(A[rr * sr + kk * sk]) : 0.f;
  }
}

__device__ __forceinline__ void store_a(float* As, long long sk,
                                        const float (&reg)[kAPer]) {
  const bool k_fast = sk == 1;
#pragma unroll
  for (int p = 0; p < kAPer; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int r = k_fast ? e / kBK : e % kBM;
    const int k = k_fast ? e % kBK : e / kBM;
    As[k * kPA + r] = reg[p];
  }
}

template <typename T>
__device__ __forceinline__ void load_b(const T* B, long long sk, long long sj,
                                       int k0, int j0, int k_end, int N,
                                       float (&reg)[kBPer]) {
  const bool j_fast = sj == 1 || sk != 1;   // walk j unless k is contiguous
#pragma unroll
  for (int p = 0; p < kBPer; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int j = j_fast ? e % kBN : e / kBK;
    const int k = j_fast ? e / kBN : e % kBK;
    const int jj = j0 + j, kk = k0 + k;
    reg[p] = (jj < N && kk < k_end) ? to_f32(B[kk * sk + jj * sj]) : 0.f;
  }
}

__device__ __forceinline__ void store_b(float* Bs, long long sk,
                                        long long sj,
                                        const float (&reg)[kBPer]) {
  const bool j_fast = sj == 1 || sk != 1;
#pragma unroll
  for (int p = 0; p < kBPer; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int j = j_fast ? e % kBN : e / kBK;
    const int k = j_fast ? e / kBN : e % kBK;
    Bs[k * kPB + j] = reg[p];
  }
}

// up to 4 consecutive columns (`left` of them exist) at stride sj: one
// 16-byte store where the row is contiguous and aligned, else one by one
template <typename O>
__device__ __forceinline__ void store4(O* dst, long long sj, int left,
                                       float v0, float v1, float v2,
                                       float v3) {
  if constexpr (sizeof(O) == 4) {
    if (sj == 1 && left >= 4 &&
        (reinterpret_cast<unsigned long long>(dst) & 15) == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(v0, v1, v2, v3);
      return;
    }
  }
  if (left > 0) dst[0] = from_f32<O>(v0);
  if (left > 1) dst[sj] = from_f32<O>(v1);
  if (left > 2) dst[2 * sj] = from_f32<O>(v2);
  if (left > 3) dst[3 * sj] = from_f32<O>(v3);
}

// acc += A[r0.., k] B[k, j0..] over k in [k_begin, k_end) for one
// component: tiles of A and B, kBK deep, through two shared-memory stages,
// the global loads of step k + 1 in flight while step k computes
template <typename T>
__device__ __forceinline__ void mainloop(
    const T* A, long long a_sr, long long a_sk, const T* B, long long b_sk,
    long long b_sj, int r0, int j0, int k_begin, int k_end, int R, int N,
    int tx, int ty, float (&As)[2][kBK * kPA], float (&Bs)[2][kBK * kPB],
    float (&acc)[kTM][kTN]) {
  float ra[kAPer], rb[kBPer];
  load_a(A, a_sr, a_sk, r0, k_begin, R, k_end, ra);
  load_b(B, b_sk, b_sj, k_begin, j0, k_end, N, rb);
  store_a(As[0], a_sk, ra);
  store_b(Bs[0], b_sk, b_sj, rb);
  __syncthreads();

  int stage = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const bool more = k0 + kBK < k_end;
    if (more) {   // next tile's loads in flight during this tile's FMAs
      load_a(A, a_sr, a_sk, r0, k0 + kBK, R, k_end, ra);
      load_b(B, b_sk, b_sj, k0 + kBK, j0, k_end, N, rb);
    }
    const float* as = As[stage];
    const float* bs = Bs[stage];
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float fa[kTM], fb[kTN];
      const float4 a0 = *reinterpret_cast<const float4*>(
          as + kk * kPA + ty * kTM);
      const float4 a1 = *reinterpret_cast<const float4*>(
          as + kk * kPA + ty * kTM + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(
          bs + kk * kPB + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(
          bs + kk * kPB + 32 + tx * 4);
      fa[0] = a0.x; fa[1] = a0.y; fa[2] = a0.z; fa[3] = a0.w;
      fa[4] = a1.x; fa[5] = a1.y; fa[6] = a1.z; fa[7] = a1.w;
      fb[0] = b0.x; fb[1] = b0.y; fb[2] = b0.z; fb[3] = b0.w;
      fb[4] = b1.x; fb[5] = b1.y; fb[6] = b1.z; fb[7] = b1.w;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
    }
    if (more) {
      store_a(As[stage ^ 1], a_sk, ra);
      store_b(Bs[stage ^ 1], b_sk, b_sj, rb);
    }
    __syncthreads();
    stage ^= 1;
  }
}

template <typename T, typename O, bool Fuse>
__global__ void __launch_bounds__(kThreads) dyad_gemm_kernel(DyadGemmArgs a) {
  __shared__ __align__(16) float As[2][kBK * kPA];
  __shared__ __align__(16) float Bs[2][kBK * kPB];

  const int z = blockIdx.z;
  const int g = z % a.n;
  const int c = Fuse ? 0 : (z / a.n) % 2;
  const int s = z / ((Fuse ? 1 : 2) * a.n);
  const int r0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int k_begin = s * a.krows;
  const int k_end = min(a.K, k_begin + a.krows);
  const int tx = threadIdx.x % (kBN / kTN);   // 0..7, along j
  const int ty = threadIdx.x / (kBN / kTN);   // 0..15, along r

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  auto run = [&](int ca) {
    mainloop(static_cast<const T*>(a.A[ca]) + g * a.a_sg[ca], a.a_sr[ca],
             a.a_sk[ca], static_cast<const T*>(a.B[ca]) + g * a.b_sg[ca],
             a.b_sk[ca], a.b_sj[ca], r0, j0, k_begin, k_end, a.R, a.N, tx,
             ty, As, Bs, acc);
  };
  if constexpr (Fuse) {   // both components into the one accumulator
    run(0);
    run(1);
  } else {
    run(c);
  }

  // column chunk h of the thread: 4 tx + 32 h .. + 3
  const long long RN = (long long)a.R * a.N;
  O* C = static_cast<O*>(a.C[c]) + g * a.c_sg[c];
  const long long c_sr = a.c_sr[c], c_sj = a.c_sj[c];
  float* part = a.part ? a.part + (((long long)s * 2 + c) * a.n + g) * RN
                       : nullptr;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + ty * kTM + i;
    if (r >= a.R) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jj = j0 + 32 * h + tx * 4;
      const float* v = acc[i] + 4 * h;
      if (part)
        store4(part + (long long)r * a.N + jj, 1, a.N - jj, v[0], v[1], v[2],
               v[3]);
      else
        store4(C + r * c_sr + jj * c_sj, c_sj, a.N - jj, v[0], v[1], v[2],
               v[3]);
    }
  }
}

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

template <typename T, typename O, bool Fuse = false>
cudaError_t launch(const DyadGemmArgs& a, cudaStream_t stream) {
  if (Fuse && (a.split != 1 || a.part)) return cudaErrorInvalidValue;
  if (a.n == 0 || a.R == 0 || a.N == 0) return cudaSuccess;
  dim3 grid((a.N + kBN - 1) / kBN, (a.R + kBM - 1) / kBM,
            (Fuse ? 1 : 2) * a.n * a.split);
  dyad_gemm_kernel<T, O, Fuse><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !a.part) return err;
  const long long total = 2LL * a.n * a.R * a.N;
  constexpr int kReduceThreads = 256;
  dyad_gemm_reduce<O><<<(unsigned)((total + kReduceThreads - 1) /
                                   kReduceThreads),
                        kReduceThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace gemm
}  // namespace repro
