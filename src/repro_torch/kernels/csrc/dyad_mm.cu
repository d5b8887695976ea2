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
// the bf16 tensor cores against 0.011 ms of bytes; OPT-125m's up + down in
// fp32 at M 4096 do 19.3 GFLOP on 135 MB: 0.117 ms as three TF32 products
// at 495 TFLOP/s (0.289 ms at the 67 TFLOP/s of fp32 FMA) against 0.040 ms
// of bytes.  Two designs, chosen by M:
//  - M <= 8 (decode), either dtype: one warp per output row o of block g.
//    The block stages both views of its group's x rows in shared memory
//    (loads batched ahead of the stores, as in the attention kernels), then
//    each warp streams its two weight rows once, lanes along k (coalesced,
//    unrolled so several loads are in flight), and reduces the M dot
//    products with shuffles.  Every weight byte is read once and a
//    projection spreads over n * d_out / 8 blocks.
//  - larger M: the tensor-core mainloop of dyad_gemm_tc.cuh with Fuse, one
//    GEMM per dyad block g whose k stages run over component 1's k (x1
//    against w1[g]) and then component 2's (x2 against w2[g]) into one fp32
//    accumulator: 128 x 128 tiles of out, x staged K-major (x1 copied with
//    cp.async, the stride-n x2 gathered through registers: in bf16 at n = 4
//    from the 16-byte runs that hold a k pair of all four blocks, else
//    element by element), w[g] staged K-major as it lies (o rows of k).
//    Rows, d_in or d_out off the tile are masked.  bf16 runs one wgmma
//    product per pair; fp32 runs split TF32 (3xTF32): x split into tf32 hi
//    and lo in registers as wgmma's A, w split in shared memory as each
//    stage lands, three wgmma products per pair (x_lo w_hi, x_hi w_lo,
//    x_hi w_hi) into a partial of each stage's own, added into the fp32
//    accumulator with fp32 adds, each product good to about 2^-21 relative
//    (the error model in dyad_gemm_tc.cuh's header).
#include "dyad_gemm_tc.cuh"

namespace repro {
namespace {

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

// rows past the decode kernel, on the tensor cores (T: bf16, or fp32 on
// split TF32): A_0 = x1 and A_1 = x2 with element (r, k) at
// x[r * ldx + g * d_in + k] and (it / dt) x[r * ldx + k * n + g],
// B_c[g][k, o] = w_c[g, o, k] (contiguous along k: K-major),
// C[g][r, o] = out[r, g, o]
template <typename T>
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
  return tc::launch<true, true, T, true, T>(a, stream);
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
  return launch_tc<T>(x, w1, w2, out, M, n, d_in, d_out, ldx, x2_strided,
                      stream);
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
