// dyad_mm_blocks: the DYAD forward with both components in one fp32
// accumulator,
//
//   out[b, g, o] = sum_k x1[b, g, k] * w1[g, o, k] + x2[b, g, k] * w2[g, o, k]
//
// Replaces the TPU kernel src/repro/kernels/dyad_mm.py: dyad_mm_blocks
// (_dyad_kernel, pallas_call in _dyad_mm_impl).
//
// The two input views are indexed here from the flat activation x (M, f_in),
// f_in = n * d_in, instead of being materialised by the caller:
//   x1[b, g, k] = x[b, g * d_in + k]
//   x2[b, g, k] = x[b, k * n + g]          (it / dt: the stride-n view)
//   x2 = x1                                 (ot)
// Ragged edges (M, d_out, d_in not multiples of the tile) are masked on
// load and store; there are no padded copies.
//
// Bound on the H100: at decode (M = 8) the kernel is bound by the bytes of
// w1 + w2 (4.7 MB of fp32 per OPT-125m projection against a few KB of x);
// at the training rows by operations: a call at Qwen3-0.6B's up (M = 4096,
// n = 4, 256 -> 768 blocks) does 12.9 GFLOP on 36 MB in bf16, 0.013 ms on
// the bf16 tensor cores against 0.011 ms of bytes; OPT-125m's fp32 rows are
// bound by fp32 FMA.  Three designs, chosen by M and the dtype:
//  - M <= 8 (decode), either dtype: one warp per output row o of block g.
//    The block stages both views of its group's x rows in shared memory
//    (loads batched ahead of the stores, as in the attention kernels), then
//    each warp streams its two weight rows once, lanes along k (coalesced,
//    unrolled so several loads are in flight), and reduces the M dot
//    products with shuffles.  Every weight byte is read once and a
//    projection spreads over n * d_out / 8 blocks.
//  - larger M in bf16: the tensor-core mainloop of dyad_gemm_tc.cuh with
//    Fuse, one GEMM per dyad block g whose 64-deep k stages run over
//    component 1's k (x1 against w1[g]) and then component 2's (x2 against
//    w2[g]) into one fp32 accumulator: 128 x 128 tiles of out, x staged
//    K-major (x1 copied with cp.async, the stride-n x2 gathered through
//    registers: at n = 4 from the 16-byte runs that hold a k pair of all
//    four blocks, else element by element), w[g] staged K-major as it
//    lies (o rows of k).  Rows, d_in or d_out off the tile are masked.
//  - larger M in fp32: each block owns one dyad block g and a (64 x 64)
//    output tile, streams 32-deep slices of x1, x2, w1, w2 through shared
//    memory with coalesced loads along k, and accumulates a 4 x 4 register
//    tile per thread on fp32 FMA (a 3xTF32 tensor-core route is later
//    work).
#include "dyad_gemm_tc.cuh"

namespace repro {
namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
dyad_mm_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const T* __restrict__ w2, T* __restrict__ out, int M, int n,
               int d_in, int d_out, long long ldx, int x2_strided) {
  constexpr int NX = BN / TN;          // threads along the output tile
  constexpr int NY = BM / TM;          // threads along the row tile
  constexpr int NT = NX * NY;
  __shared__ float xs1[BK][BM + 1];
  __shared__ float xs2[BK][BM + 1];
  __shared__ float ws1[BK][BN + 1];
  __shared__ float ws2[BK][BN + 1];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int o0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % NX;
  const int ty = tid / NX;
  const long long wbase = (long long)g * d_out * d_in;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d_in; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int m = m0 + r, k = k0 + c;
      float a = 0.f, b = 0.f;
      if (m < M && k < d_in) {
        const T* xr = x + (long long)m * ldx;
        a = to_f32(xr[g * d_in + k]);
        b = to_f32(xr[x2_strided ? k * n + g : g * d_in + k]);
      }
      xs1[c][r] = a;
      xs2[c][r] = b;
    }
    for (int e = tid; e < BN * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int o = o0 + r, k = k0 + c;
      float a = 0.f, b = 0.f;
      if (o < d_out && k < d_in) {
        const long long off = wbase + (long long)o * d_in + k;
        a = to_f32(w1[off]);
        b = to_f32(w2[off]);
      }
      ws1[c][r] = a;
      ws2[c][r] = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a1[TM], a2[TM], b1[TN], b2[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a1[i] = xs1[kk][ty + i * NY];
        a2[i] = xs2[kk][ty + i * NY];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b1[j] = ws1[kk][tx + j * NX];
        b2[j] = ws2[kk][tx + j * NX];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(a2[i], b2[j], fmaf(a1[i], b1[j], acc[i][j]));
    }
    __syncthreads();
  }

  const long long ldo = (long long)n * d_out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * NY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx + j * NX;
      if (o < d_out) out[m * ldo + g * d_out + o] = from_f32<T>(acc[i][j]);
    }
  }
}

constexpr int kMaxRowsMv = 8;     // rows of x the decode kernel takes
constexpr int kMvWarps = 8;       // output rows per decode block

template <typename T>
__global__ void __launch_bounds__(kMvWarps * 32)
dyad_mv_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const T* __restrict__ w2, T* __restrict__ out, int M, int n,
               int d_in, int d_out, long long ldx, int x2_strided) {
  extern __shared__ float xs[];   // [M][d_in] of x1, then [M][d_in] of x2
  const int g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // stage both views, kStage elements per thread per round: the loads of
  // a round issue before its stores, so memory latency is paid per round
  constexpr int kStage = 8, NT = kMvWarps * 32;
  const int total = M * d_in;
  for (int e0 = 0; e0 < total; e0 += kStage * NT) {
    float v1[kStage], v2[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int e = e0 + tid + i * NT;
      const int m = e / d_in, k = e % d_in;
      const T* xr = x + m * ldx;
      const bool in = e < total;
      v1[i] = in ? to_f32(xr[g * d_in + k]) : 0.f;
      v2[i] = in ? to_f32(xr[x2_strided ? k * n + g : g * d_in + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int e = e0 + tid + i * NT;
      if (e < total) {
        xs[e] = v1[i];
        xs[total + e] = v2[i];
      }
    }
  }
  __syncthreads();
  const int o = blockIdx.x * kMvWarps + warp;
  if (o >= d_out) return;
  const long long row = ((long long)g * d_out + o) * d_in;
  const T* r1 = w1 + row;
  const T* r2 = w2 + row;
  float acc[kMaxRowsMv];
#pragma unroll
  for (int m = 0; m < kMaxRowsMv; ++m) acc[m] = 0.f;
#pragma unroll 4
  for (int k = lane; k < d_in; k += 32) {
    const float a = to_f32(r1[k]), b = to_f32(r2[k]);
#pragma unroll
    for (int m = 0; m < kMaxRowsMv; ++m)
      if (m < M)
        acc[m] = fmaf(b, xs[(M + m) * d_in + k],
                      fmaf(a, xs[m * d_in + k], acc[m]));
  }
  const long long ldo = (long long)n * d_out;
#pragma unroll
  for (int m = 0; m < kMaxRowsMv; ++m) {
    if (m >= M) break;
    const float v = warp_sum(acc[m]);
    if (lane == 0) out[m * ldo + g * d_out + o] = from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch_mv(const void* x, const void* w1, const void* w2,
                      void* out, int M, int n, int d_in, int d_out,
                      long long ldx, int x2_strided, size_t smem,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dyad_mv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((d_out + kMvWarps - 1) / kMvWarps, n);
  dyad_mv_kernel<T><<<grid, kMvWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<T*>(out), M, n, d_in, d_out,
      ldx, x2_strided);
  return cudaGetLastError();
}

template <typename T, int BM, int BN, int TM, int TN>
cudaError_t launch_tile(const void* x, const void* w1, const void* w2,
                        void* out, int M, int n, int d_in, int d_out,
                        long long ldx, int x2_strided, cudaStream_t stream) {
  constexpr int BK = 32;
  dim3 grid((d_out + BN - 1) / BN, (M + BM - 1) / BM, n);
  dyad_mm_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w1),
          static_cast<const T*>(w2), static_cast<T*>(out), M, n, d_in, d_out,
          ldx, x2_strided);
  return cudaGetLastError();
}

// bf16 rows past the decode kernel, on the tensor cores: A_0 = x1 and
// A_1 = x2 with element (r, k) at x[r * ldx + g * d_in + k] and (it / dt)
// x[r * ldx + k * n + g], B_c[g][k, o] = w_c[g, o, k] (contiguous along k:
// K-major), C[g][r, o] = out[r, g, o]
cudaError_t launch_tc(const void* x, const void* w1, const void* w2,
                      void* out, int M, int n, int d_in, int d_out,
                      long long ldx, int x2_strided, cudaStream_t stream) {
  const long long w_sg = (long long)d_out * d_in;
  const long long ldo = (long long)n * d_out;
  const long long x2_sg = x2_strided ? 1 : d_in;
  const long long x2_sk = x2_strided ? n : 1;
  DyadGemmArgs a{{x, x},         {d_in, x2_sg}, {ldx, ldx},  {1, x2_sk},
                 {w1, w2},       {w_sg, w_sg},  {1, 1},      {d_in, d_in},
                 {out, out},     {d_out, d_out}, {ldo, ldo}, {1, 1},
                 nullptr,        n,             M,           d_out,
                 d_in,           1,             d_in};
  return tc::launch<true, true, __nv_bfloat16, true>(a, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* w2, void* out,
                   int M, int n, int d_in, int d_out, long long ldx,
                   int x2_strided, cudaStream_t stream) {
  // decode rows: the weight-streaming kernel, while both views of the
  // group's x rows fit in shared memory
  const size_t smem = sizeof(float) * 2 * (size_t)M * d_in;
  if (M <= kMaxRowsMv && smem <= 200 * 1024)
    return launch_mv<T>(x, w1, w2, out, M, n, d_in, d_out, ldx, x2_strided,
                        smem, stream);
  if constexpr (sizeof(T) == 2)
    return launch_tc(x, w1, w2, out, M, n, d_in, d_out, ldx, x2_strided,
                     stream);
  else
    return launch_tile<T, 64, 64, 4, 4>(x, w1, w2, out, M, n, d_in, d_out,
                                        ldx, x2_strided, stream);
}

}  // namespace
}  // namespace repro

extern "C" int repro_dyad_mm_blocks(const void* x, const void* w1,
                                    const void* w2, void* out, int M, int n,
                                    int d_in, int d_out, long long ldx,
                                    int x2_strided, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return cudaSuccess;
  switch (dtype) {
    case repro::kF32:
      return repro::launch<float>(x, w1, w2, out, M, n, d_in, d_out, ldx,
                                  x2_strided, s);
    case repro::kBF16:
      return repro::launch<__nv_bfloat16>(x, w1, w2, out, M, n, d_in, d_out,
                                          ldx, x2_strided, s);
    default:
      return cudaErrorInvalidValue;
  }
}
