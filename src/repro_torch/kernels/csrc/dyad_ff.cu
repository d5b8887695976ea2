// dyad_ff_fused: the whole DYAD ff module in one kernel, per dyad block g,
//
//   pre[b, g, j] = sum_k x1[b, g, k] * wu1[g, j, k] + x2[b, g, k] * wu2[g, j, k]
//   h[b, g, j]   = act(pre)            (swiglu: silu(gate pre) * pre)
//   z1[b, g, o]  = sum_j h[b, g, j] * wd1[g, o, j]
//   z2[b, g, o]  = sum_j h[b, g, j] * wd2[g, o, j]
//
// the IT up projection (and the gate), the activation and the OT down
// projection; the caller applies the OT re-view of z2 (ref.combine).
// Replaces the TPU kernel src/repro/kernels/dyad_mm.py: dyad_ff_fused
// (_ff_kernel, _ff_kernel_swiglu, pallas_call in _dyad_ff_impl), and with
// quantized weights (the entry repro_dyad_ff_fused_q) dyad_ff_fused_q
// (_ff_kernel_q, _ff_kernel_swiglu_q, pallas_call in _dyad_ff_q_impl).
//
// Two kernels, chosen by the wrapper (ff_plan, ff_q_plan) through the
// entries' tc flag: bf16 x at every row count runs on the tensor cores
// (dyad_ff_tc_kernel, dyad_ff_tc.cuh: fp32 weights cast to bf16 once a
// call, in one launch; quantized weights on its payload instantiation,
// converted as they are staged); fp32 x on the fp32 FMA kernel below
// (dyad_ff_kernel), with fp32 or quantized weights.  Both share the
// hidden split and its second pass (dyad_ff_reduce).
//
// The FMA kernel.  The hidden never goes to device memory.  A block owns
// 32 rows of one dyad block g and up to 256 output columns of both
// components, whose fp32 accumulators stay in registers (32 per thread and
// component).  For each
// 64-column tile of the hidden it
//   1. accumulates the up (and gate) tile in fp32 over k, 16 deep per
//      shared-memory stage (2 rows x 4 columns per thread);
//   2. applies the activation to the fp32 sums in registers (gelu in the
//      tanh form, as jax.nn.gelu; relu; silu; swiglu);
//   3. rounds the hidden to the activation dtype, as the TPU kernel does
//      before its down product;
//   4. stages it in shared memory;
//   5. adds its products with 16-deep tiles of wd1 and wd2 into the two
//      output accumulators (4 rows x 8 columns per thread each).
// Only z1 and z2 are written.  Ragged edges are masked on load and store:
// padded hidden columns see zero up weights, so act(0) = 0 for every
// epilogue, and zero down weights as well, as plan_ff_tiles keeps the TPU
// kernel exact.
//
// The weights are read in the activation dtype, or in fp32 for bf16
// activations: each is then rounded to bf16 as it is loaded, which is what
// a cast before the call computes, without the copy of every weight.
//
// Quantized weights on the FMA kernel (dyad_ff_fused_q's fp32 route): int8
// or fp8 e4m3 payloads, read as bytes and converted exactly to fp32 as
// they are staged (quant.cuh), with
// one fp32 scale per (block, hidden column) for the up and gate payloads
// and per (block, output column) for the down payloads.  The two up (and
// gate) components then sum in accumulators of their own, and their
// scales multiply the finished fp32 sums before the activation, as the TPU
// kernel scales each partial before its activation epilogue.  The hidden
// is rounded to the activation dtype before the down products, as above.
// The down scales multiply each output's fp32 sum once: before it is
// stored, or before it is written as a partial of the hidden split, whose
// second pass only adds; never in both places.  The unquantized kernels
// are the same code as before (the quantized steps are compiled only for
// payload types).
//
// Parallelism: at the training rows (M = 4096) the grid has n x M / 32 =
// 512 blocks, but at the decode rows (M = 8) only n = 4.  The TPU kernel's
// other parallel axis, the output tiles, would recompute the up tile once
// per output tile; the up and gate products are two thirds of the work, so
// the hidden axis is split instead: each of `split` blocks per row tile
// sums its range of the hidden (`span` columns, a multiple of the 16-deep
// down stage) into fp32 partials, and a second pass adds them in split
// order and casts, so the bits are the same on every run (no atomics).
// The wrapper picks split from the row count (Qwen3 decode: 48 ranges of
// 16 columns, 192 blocks; prefill: 3 of 256); output tiles beyond 256
// columns are a grid axis too (with the up recomputed), for generality
// only.
//
// Bound on the H100: one Qwen3-0.6B layer (n 4, d_in_b 256, d_ff_b 768,
// d_out_b 256, swiglu) does 38.7 GFLOP at M = 4096, 0.58 ms on fp32 FMA;
// at M = 8 it moves its 4.7 M weights, 9.4 MB in bf16, 2.8 us at
// 3.35 TB/s (4.7 MB of int8 or fp8 payloads and 57 KB of scales: 1.4 us).
// This kernel runs on FMA; it keeps the rows that bound is about.
#include <type_traits>

#include "dyad_ff_tc.cuh"
#include "quant.cuh"

namespace repro {
namespace {

constexpr int kBB = 32;        // rows per block
constexpr int kBJ = 64;        // hidden columns per tile
constexpr int kBK = 16;        // up contraction depth per stage
constexpr int kBO = 256;       // output columns per block, per component
constexpr int kBD = 16;        // down contraction depth per stage
constexpr int kThreads = 256;
// shared-memory pitches (+4 floats: 16-byte rows, spread banks)
constexpr int kPX = kBB + 4, kPW = kBJ + 4, kPH = kBB + 4, kPD = kBO + 4;
// the up stage (x1, x2 and up to four up-weight tiles) and the down stage
// (the two down-weight tiles) are used in turn and share one buffer
constexpr int kUpFloats = 2 * kBK * kPX + 4 * kBK * kPW;
constexpr int kDownFloats = 2 * kBD * kPD;
constexpr int kStageFloats = kUpFloats > kDownFloats ? kUpFloats : kDownFloats;

// a weight as the activation dtype T holds it, in fp32
template <typename T, typename TW>
__device__ __forceinline__ float load_w(const TW* p) {
  if constexpr (std::is_same<T, TW>::value || is_payload<TW>::value)
    return to_f32(*p);   // a payload is exact in T: no rounding to do
  else
    return to_f32(from_f32<T>(to_f32(*p)));
}

template <typename T, typename TW, bool kGated>
__global__ void __launch_bounds__(kThreads) dyad_ff_kernel(FFArgs a) {
  __shared__ __align__(16) float stage[kStageFloats];
  __shared__ __align__(16) float hs[kBJ * kPH];   // hidden tile [j][row]
  constexpr int kUps = kGated ? 4 : 2;
  constexpr bool kQ = is_payload<TW>::value;

  const int o_tiles = (a.d_out + kBO - 1) / kBO;
  const int o0 = (blockIdx.x % o_tiles) * kBO;
  const int s = blockIdx.x / o_tiles;
  const int m0 = blockIdx.y * kBB;
  const int g = blockIdx.z;
  const int j_begin = s * a.span;
  const int j_end = min(a.d_ff, j_begin + a.span);
  const int tid = threadIdx.x;
  const int ux = tid % 16, uy = tid / 16;     // up: rows 2 uy + r, cols ux + 16 c
  const int lane = tid % 32, warp = tid / 32; // down: rows 4 warp + r, cols lane + 32 c

  const T* x1 = static_cast<const T*>(a.x1) + g * a.x1_sg;
  const T* x2 = static_cast<const T*>(a.x2) + g * a.x2_sg;
  const long long wu_g = (long long)g * a.d_ff * a.d_in;
  const long long wd_g = (long long)g * a.d_out * a.d_ff;
  const TW* wu[4];
#pragma unroll
  for (int w = 0; w < 4; ++w)
    wu[w] = w < kUps ? static_cast<const TW*>(a.wu[w]) + wu_g : nullptr;
  const TW* wd1 = static_cast<const TW*>(a.wd[0]) + wd_g;
  const TW* wd2 = static_cast<const TW*>(a.wd[1]) + wd_g;

  float* xs1 = stage;                 // [k][row]
  float* xs2 = stage + kBK * kPX;
  float* ws = stage + 2 * kBK * kPX;  // [w][k][j]
  float* ds = stage;                  // [c][k][o]

  float acc1[4][8], acc2[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc1[r][c] = acc2[r][c] = 0.f;

  for (int j0 = j_begin; j0 < j_end; j0 += kBJ) {
    // 1. the up (and gate) tile, fp32 over k; quantized, component 2 sums
    // apart (hu2, hg2) until the scales are applied
    float hu[2][4], hg[2][4], hu2[2][4], hg2[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        hu[r][c] = hg[r][c] = hu2[r][c] = hg2[r][c] = 0.f;
    for (int k0 = 0; k0 < a.d_in; k0 += kBK) {
      for (int e = tid; e < kBB * kBK; e += kThreads) {
        const int r = e / kBK, k = e % kBK;
        const int m = m0 + r, kk = k0 + k;
        float v1 = 0.f, v2 = 0.f;
        if (m < a.M && kk < a.d_in) {
          v1 = to_f32(x1[m * a.x1_sb + kk * a.x1_sk]);
          v2 = to_f32(x2[m * a.x2_sb + kk * a.x2_sk]);
        }
        xs1[k * kPX + r] = v1;
        xs2[k * kPX + r] = v2;
      }
      for (int e = tid; e < kBJ * kBK; e += kThreads) {
        const int j = e / kBK, k = e % kBK;
        const int jj = j0 + j, kk = k0 + k;
        const bool in = jj < j_end && kk < a.d_in;
        const long long off = (long long)jj * a.d_in + kk;
#pragma unroll
        for (int w = 0; w < kUps; ++w)
          ws[(w * kBK + k) * kPW + j] = in ? load_w<T>(wu[w] + off) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float2 a1 = *reinterpret_cast<const float2*>(
            xs1 + k * kPX + 2 * uy);
        const float2 a2 = *reinterpret_cast<const float2*>(
            xs2 + k * kPX + 2 * uy);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = ux + 16 * c;
          const float b1 = ws[k * kPW + j];
          const float b2 = ws[(kBK + k) * kPW + j];
          if constexpr (kQ) {
            hu[0][c] = fmaf(a1.x, b1, hu[0][c]);
            hu[1][c] = fmaf(a1.y, b1, hu[1][c]);
            hu2[0][c] = fmaf(a2.x, b2, hu2[0][c]);
            hu2[1][c] = fmaf(a2.y, b2, hu2[1][c]);
          } else {
            hu[0][c] = fmaf(a2.x, b2, fmaf(a1.x, b1, hu[0][c]));
            hu[1][c] = fmaf(a2.y, b2, fmaf(a1.y, b1, hu[1][c]));
          }
          if (kGated) {
            const float c1 = ws[(2 * kBK + k) * kPW + j];
            const float c2 = ws[(3 * kBK + k) * kPW + j];
            if constexpr (kQ) {
              hg[0][c] = fmaf(a1.x, c1, hg[0][c]);
              hg[1][c] = fmaf(a1.y, c1, hg[1][c]);
              hg2[0][c] = fmaf(a2.x, c2, hg2[0][c]);
              hg2[1][c] = fmaf(a2.y, c2, hg2[1][c]);
            } else {
              hg[0][c] = fmaf(a2.x, c2, fmaf(a1.x, c1, hg[0][c]));
              hg[1][c] = fmaf(a2.y, c2, fmaf(a1.y, c1, hg[1][c]));
            }
          }
        }
      }
      __syncthreads();
    }

    // quantized: the scaled sums, s1 * (x1 . q1) + s2 * (x2 . q2) per
    // hidden column (columns past the range have zero sums: scale 0)
    if constexpr (kQ) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jj = j0 + ux + 16 * c;
        const long long sj = (long long)g * a.d_ff + jj;
        const bool in = jj < j_end;
        const float u1 = in ? a.su[0][sj] : 0.f, u2 = in ? a.su[1][sj] : 0.f;
        const float g1 = kGated && in ? a.su[2][sj] : 0.f;
        const float g2 = kGated && in ? a.su[3][sj] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          hu[r][c] = hu[r][c] * u1 + hu2[r][c] * u2;
          if (kGated) hg[r][c] = hg[r][c] * g1 + hg2[r][c] * g2;
        }
      }
    }

    // 2-4. the activation on the fp32 sums, rounded to T, staged
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float h = kGated ? silu(hg[r][c]) * hu[r][c]
                               : activate(a.act, hu[r][c]);
        hs[(ux + 16 * c) * kPH + 2 * uy + r] = to_f32(from_f32<T>(h));
      }
    __syncthreads();

    // 5. the down products of this hidden tile into both accumulators
    // (the stages past the block's hidden range hold only zeros: skipped)
    for (int jd = 0; jd < kBJ && j0 + jd < j_end; jd += kBD) {
      for (int e = tid; e < kBO * kBD; e += kThreads) {
        const int o = e / kBD, k = e % kBD;
        const int oo = o0 + o, jj = j0 + jd + k;
        const bool in = oo < a.d_out && jj < j_end;
        const long long off = (long long)oo * a.d_ff + jj;
        ds[k * kPD + o] = in ? load_w<T>(wd1 + off) : 0.f;
        ds[(kBD + k) * kPD + o] = in ? load_w<T>(wd2 + off) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kBD; ++k) {
        const float4 h = *reinterpret_cast<const float4*>(
            hs + (jd + k) * kPH + 4 * warp);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float d1 = ds[k * kPD + lane + 32 * c];
          const float d2 = ds[(kBD + k) * kPD + lane + 32 * c];
          acc1[0][c] = fmaf(h.x, d1, acc1[0][c]);
          acc1[1][c] = fmaf(h.y, d1, acc1[1][c]);
          acc1[2][c] = fmaf(h.z, d1, acc1[2][c]);
          acc1[3][c] = fmaf(h.w, d1, acc1[3][c]);
          acc2[0][c] = fmaf(h.x, d2, acc2[0][c]);
          acc2[1][c] = fmaf(h.y, d2, acc2[1][c]);
          acc2[2][c] = fmaf(h.z, d2, acc2[2][c]);
          acc2[3][c] = fmaf(h.w, d2, acc2[3][c]);
        }
      }
      __syncthreads();
    }
  }

  const long long per = (long long)a.M * a.n * a.d_out;
  T* z1 = static_cast<T*>(a.z[0]);
  T* z2 = static_cast<T*>(a.z[1]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + 4 * warp + r;
    if (m >= a.M) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int o = o0 + lane + 32 * c;
      if (o >= a.d_out) continue;
      if constexpr (kQ) {   // the down scales, once per output sum
        const long long so = (long long)g * a.d_out + o;
        acc1[r][c] *= a.sd[0][so];
        acc2[r][c] *= a.sd[1][so];
      }
      if (a.part) {
        const long long e = ((long long)m * a.n + g) * a.d_out + o;
        a.part[(2LL * s) * per + e] = acc1[r][c];
        a.part[(2LL * s + 1) * per + e] = acc2[r][c];
      } else {
        z1[m * a.z_sb[0] + g * a.z_sg[0] + o * a.z_so[0]] =
            from_f32<T>(acc1[r][c]);
        z2[m * a.z_sb[1] + g * a.z_sg[1] + o * a.z_so[1]] =
            from_f32<T>(acc2[r][c]);
      }
    }
  }
}

// second pass for split > 1: z_c = the partials added in split order
template <typename T>
__global__ void dyad_ff_reduce(FFArgs a) {
  const long long per = (long long)a.M * a.n * a.d_out;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * per) return;
  const int c = (int)(e / per);
  const long long i = e % per;
  float sum = 0.f;
  for (int s = 0; s < a.split; ++s) sum += a.part[(2LL * s + c) * per + i];
  const int o = (int)(i % a.d_out);
  const int g = (int)((i / a.d_out) % a.n);
  const long long m = i / ((long long)a.n * a.d_out);
  static_cast<T*>(a.z[c])[m * a.z_sb[c] + g * a.z_sg[c] + o * a.z_so[c]] =
      from_f32<T>(sum);
}

// after a launch: for split > 1, the second pass over the partials
template <typename T>
cudaError_t reduce(const FFArgs& a, cudaError_t err, cudaStream_t stream) {
  if (err != cudaSuccess || !a.part) return err;
  const long long total = 2LL * a.M * a.n * a.d_out;
  constexpr int kReduceThreads = 256;
  dyad_ff_reduce<T><<<(unsigned)((total + kReduceThreads - 1) /
                                 kReduceThreads),
                      kReduceThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t launch(const FFArgs& a, cudaStream_t stream) {
  const int o_tiles = (a.d_out + kBO - 1) / kBO;
  dim3 grid(o_tiles * a.split, (a.M + kBB - 1) / kBB, a.n);
  if (a.act == kSwiglu)
    dyad_ff_kernel<T, TW, true><<<grid, kThreads, 0, stream>>>(a);
  else
    dyad_ff_kernel<T, TW, false><<<grid, kThreads, 0, stream>>>(a);
  return reduce<T>(a, cudaGetLastError(), stream);
}

}  // namespace
}  // namespace repro

extern "C" int repro_dyad_ff_fused(
    const void* x1, const void* x2, const void* wu1, const void* wu2,
    const void* wg1, const void* wg2, const void* wd1, const void* wd2,
    void* z1, void* z2, float* part, void* wcast, int M, int n, int d_in,
    int d_ff, int d_out, int split, int span, long long x1_sb,
    long long x1_sg, long long x1_sk, long long x2_sb, long long x2_sg,
    long long x2_sk, long long z1_sb, long long z1_sg, long long z1_so,
    long long z2_sb, long long z2_sg, long long z2_so, int act, int dtype,
    int wdtype, int tc, void* stream) {
  using namespace repro;
  if (split < 1 || span < 1 || (split > 1 && !part) || act < kGelu ||
      act > kSwiglu || (act == kSwiglu && !(wg1 && wg2)))
    return cudaErrorInvalidValue;
  if (M == 0 || n == 0 || d_out == 0) return cudaSuccess;
  FFArgs a{x1,    x2,    x1_sb, x1_sg, x1_sk, x2_sb, x2_sg, x2_sk,
           {wu1, wu2, wg1, wg2},  {wd1, wd2},  {z1, z2},
           {z1_sb, z2_sb}, {z1_sg, z2_sg}, {z1_so, z2_so},
           split > 1 ? part : nullptr, M, n, d_in, d_ff, d_out, split, span,
           act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // tc: the tensor-core kernel of dyad_ff_tc.cuh, bf16 x; fp32 weights are
  // cast into wcast first
  if (tc) {
    if (dtype != kBF16 || !(wdtype == kBF16 || (wdtype == kF32 && wcast)))
      return cudaErrorInvalidValue;
    if (wdtype == kF32) {
      const cudaError_t err = fftc::cast_weights(
          a, static_cast<__nv_bfloat16*>(wcast), s);
      if (err != cudaSuccess) return err;
    }
    return reduce<__nv_bfloat16>(a, fftc::launch<__nv_bfloat16>(a, s), s);
  }
  if (dtype == kF32 && wdtype == kF32) return launch<float, float>(a, s);
  if (dtype == kBF16 && wdtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (dtype == kBF16 && wdtype == kF32)
    return launch<__nv_bfloat16, float>(a, s);
  return cudaErrorInvalidValue;
}

// the quantized weights: wdtype is the payload (kInt8 or kE4M3); su1, su2
// (and sg1, sg2) scale the up (and gate) payloads, sd1, sd2 the down ones;
// tc: the tensor-core kernel's payload instantiation (bf16 x)
extern "C" int repro_dyad_ff_fused_q(
    const void* x1, const void* x2, const void* wu1, const void* wu2,
    const void* wg1, const void* wg2, const void* wd1, const void* wd2,
    const float* su1, const float* su2, const float* sg1, const float* sg2,
    const float* sd1, const float* sd2, void* z1, void* z2, float* part,
    int M, int n, int d_in, int d_ff, int d_out, int split, int span,
    long long x1_sb, long long x1_sg, long long x1_sk, long long x2_sb,
    long long x2_sg, long long x2_sk, long long z1_sb, long long z1_sg,
    long long z1_so, long long z2_sb, long long z2_sg, long long z2_so,
    int act, int dtype, int wdtype, int tc, void* stream) {
  using namespace repro;
  if (split < 1 || span < 1 || (split > 1 && !part) || act < kGelu ||
      act > kSwiglu || !(su1 && su2 && sd1 && sd2) ||
      (act == kSwiglu && !(wg1 && wg2 && sg1 && sg2)))
    return cudaErrorInvalidValue;
  if (M == 0 || n == 0 || d_out == 0) return cudaSuccess;
  FFArgs a{x1,    x2,    x1_sb, x1_sg, x1_sk, x2_sb, x2_sg, x2_sk,
           {wu1, wu2, wg1, wg2},  {wd1, wd2},  {z1, z2},
           {z1_sb, z2_sb}, {z1_sg, z2_sg}, {z1_so, z2_so},
           split > 1 ? part : nullptr, M, n, d_in, d_ff, d_out, split, span,
           act, {su1, su2, sg1, sg2}, {sd1, sd2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype == kBF16 && wdtype == kInt8)
      return reduce<__nv_bfloat16>(a, fftc::launch<int8_t>(a, s), s);
    if (dtype == kBF16 && wdtype == kE4M3)
      return reduce<__nv_bfloat16>(a, fftc::launch<__nv_fp8_e4m3>(a, s), s);
    return cudaErrorInvalidValue;
  }
  if (dtype == kF32 && wdtype == kInt8) return launch<float, int8_t>(a, s);
  if (dtype == kF32 && wdtype == kE4M3)
    return launch<float, __nv_fp8_e4m3>(a, s);
  if (dtype == kBF16 && wdtype == kInt8)
    return launch<__nv_bfloat16, int8_t>(a, s);
  if (dtype == kBF16 && wdtype == kE4M3)
    return launch<__nv_bfloat16, __nv_fp8_e4m3>(a, s);
  return cudaErrorInvalidValue;
}
