// dyad_mm_blocks_q and dyad_mm_blocks_two_q: the DYAD forward over
// quantized weights (int8 or fp8 e4m3 payloads, one fp32 scale per
// (block, out_row)),
//
//   z1[b, g, o] = s1[g, o] * sum_k x1[b, g, k] * q1[g, o, k]
//   z2[b, g, o] = s2[g, o] * sum_k x2[b, g, k] * q2[g, o, k]
//
// dyad_mm_blocks_q writes z1 + z2 (the IT forward: both components share
// the output layout); dyad_mm_blocks_two_q writes z1 and z2 apart (OT and
// DT, and the split ff route's down projection; the caller applies
// ref.combine).  Replaces the TPU kernels src/repro/kernels/dyad_mm.py:
// dyad_mm_blocks_q and dyad_mm_blocks_two_q (_dyad_kernel_q and
// _dyad_kernel_two_q, pallas_call in _dyad_mm_q_impl).
//
// No dequantized weight exists in device memory: the payload is read as
// bytes and converted exactly where the products need it.  Each
// component sums in its own fp32 accumulator and its scale multiplies the
// finished sum once (the TPU kernel multiplies each k step's partial: the
// same in exact arithmetic, apart in fp32 rounding only).  x1, x2, z1 and
// z2 are read and written through their (b, g, inner) strides, so the
// IT/DT x2 is the stride-n view of the flat input and z2 can be a view of
// a (M, d_out, n) buffer, as in dyad_mm_two.cu.  Ragged edges are masked
// on load and store; there are no padded copies.
//
// Bound on the H100: at the decode and prefill-chunk rows the payload
// bytes (one a weight: 1.6 MB for a Qwen3-0.6B up or down projection,
// 0.5 us at 3.35 TB/s) against a few hundred KB of x; at the prefill rows
// the products: on the bf16 tensor cores for bf16 x; for fp32 x two TF32
// products a pair at 495 TFLOP/s, 247.5 TFLOP/s of fp32 work (OPT-125m's
// up or down at M 1024, both components, 2.4 GFLOP: 0.0098 ms of
// operations, against 0.036 ms at the 67 TFLOP/s of fp32 FMA and about
// 0.005 ms of bytes).  Routes, picked by the wrapper (dyad_mm.mm_q_plan)
// through the entry's tc flag:
//  - tensor cores, one wgmma GEMM per (component, dyad block) on
//    dyad_gemm_tc.cuh's pieces: a block of two warpgroups owns a 128 x 128
//    tile of z_c; x staged K-major as in dyad_mm_two.cu (copied with
//    cp.async, the stride-n x2 through the register gather); the payload
//    staged K-major as it lies (o rows of k) through quant_tc.cuh's
//    loader.  Each component's scale multiplies its sum once, in the
//    epilogue.  The hidden k is split into ranges of whole stages when the
//    tiles alone leave SMs idle (the split route's down at M 128 has 16
//    tiles for 132 SMs): each range writes its scaled fp32 partial and a
//    second pass (dyad_mm_q_reduce) adds them in a fixed order and rounds
//    once to x's dtype, so no scale is applied twice and every run gives
//    the same bits.  dyad_mm_blocks_q always takes that pass, since its
//    two components' scales differ: each (component, block) GEMM writes
//    its scaled partial and the pass adds both components, rounding the
//    sum once.
//     - bf16 x (Qwen3's split ff route; dyad_mm_q_tc_kernel): m64n128k16
//       per warpgroup, a 6-stage cp.async ring of the x tile and the raw
//       payload bytes (64 k, 24 KB a stage), each stage's bytes converted
//       to bf16 into one of two swizzled tiles after a barrier, then a
//       proxy fence and a second barrier before its wgmma (the conversion
//       runs under the previous stage's products).
//     - fp32 x (OPT-125m's quantized serving; dyad_mm_q_tf32_kernel): 32
//       k a stage, a ring of 3 (the x tile as it lies, 16 KB, and the raw
//       payload bytes, 4 KB).  x is split in registers into tf32 hi and lo
//       (a_frags32, as dyad_gemm_tc.cuh's split-TF32 branch does), the
//       payload converted exactly to fp32 (convert32, each thread its own
//       copied chunk) into one of two fp32 tiles, which wgmma reads as
//       tf32: every int8 and finite e4m3 value is a tf32 value, so the
//       weight needs no low term and a pair takes two m64n128k8 tf32
//       products, x_lo w then x_hi w (3xTF32's x_hi w_lo is zero here).
//       As in that branch, each stage's products sum into a partial of
//       their own, added into the fp32 accumulator with fp32 adds, and
//       stage t + 1 is made ready and stage t + 2 issued under stage t's
//       products.  Each product keeps x to about 2^-22 relative (x_hi +
//       x_lo), the sums are fp32; chip_smoke.py phase 3 holds it against
//       the plain fp32 version and a float64 product.
//  - FMA, the decode rows where the plan keeps them (M <= 8 and both x
//    views of a group, as fp32, within 200 KB of shared memory: fp32 x
//    always, bf16 x where the decode blocks fill two waves of the SMs): one
//    warp per output row o of block g; the block stages both x views of
//    its group in shared memory, then each warp streams its two payload
//    rows once, four bytes a lane per load (one 32-bit word where d_in
//    allows), and reduces the M dot products with shuffles.  The entry
//    refuses any other call on this route.
#include "quant_tc.cuh"

namespace repro {
namespace {

struct QArgs {
  const void* x[2];
  long long x_sb[2], x_sg[2], x_sk[2];
  const void* w[2];     // (n, d_out, d_in) payloads, contiguous
  const float* s[2];    // (n, d_out) scales, contiguous
  void* z[2];           // z[1] unused when the components are summed
  long long z_sb[2], z_sg[2], z_so[2];
  int M, n, d_in, d_out;
};

// the finished sums of output (m, g, o), scaled; summed into z[0] or
// written apart
template <typename T, bool kTwo>
__device__ __forceinline__ void store_out(const QArgs& a, int m, int g, int o,
                                          float acc1, float acc2) {
  const long long so = (long long)g * a.d_out + o;
  const float v1 = acc1 * a.s[0][so], v2 = acc2 * a.s[1][so];
  T* z1 = static_cast<T*>(a.z[0]);
  const long long e1 = m * a.z_sb[0] + g * a.z_sg[0] + o * a.z_so[0];
  if constexpr (kTwo) {
    z1[e1] = from_f32<T>(v1);
    static_cast<T*>(a.z[1])[m * a.z_sb[1] + g * a.z_sg[1] + o * a.z_so[1]] =
        from_f32<T>(v2);
  } else {
    z1[e1] = from_f32<T>(v1 + v2);
  }
}

constexpr int kMaxRowsMv = 8;     // rows of x the decode kernel takes
constexpr int kMvWarps = 8;       // output rows per decode block
constexpr size_t kMvSmem = 200 * 1024;   // its most shared memory

// four payloads from k on (those at or past d_in read as 0), as one
// little-endian word
template <typename W>
__device__ __forceinline__ uint32_t load4(const W* row, int k, int d_in,
                                          bool vec) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(row) + k;
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < d_in) w |= (uint32_t)p[i] << (8 * i);
  return w;
}

template <typename T, typename W, bool kTwo>
__global__ void __launch_bounds__(kMvWarps * 32)
dyad_mv_q_kernel(QArgs a, int vec) {
  extern __shared__ __align__(16) float xs[];  // [M][d_in] of x1, then x2
  const int g = blockIdx.y;
  const int M = a.M, d_in = a.d_in;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* x1 = static_cast<const T*>(a.x[0]) + g * a.x_sg[0];
  const T* x2 = static_cast<const T*>(a.x[1]) + g * a.x_sg[1];
  // stage both views, kStage elements per thread per round, the loads of a
  // round issued before its stores
  constexpr int kStage = 8, NT = kMvWarps * 32;
  const int total = M * d_in;
  for (int e0 = 0; e0 < total; e0 += kStage * NT) {
    float v1[kStage], v2[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int e = e0 + tid + i * NT;
      const int m = e / d_in, k = e % d_in;
      const bool in = e < total;
      v1[i] = in ? to_f32(x1[m * a.x_sb[0] + k * a.x_sk[0]]) : 0.f;
      v2[i] = in ? to_f32(x2[m * a.x_sb[1] + k * a.x_sk[1]]) : 0.f;
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
  if (o >= a.d_out) return;
  const long long row = ((long long)g * a.d_out + o) * d_in;
  const W* r1 = static_cast<const W*>(a.w[0]) + row;
  const W* r2 = static_cast<const W*>(a.w[1]) + row;
  float acc1[kMaxRowsMv], acc2[kMaxRowsMv];
#pragma unroll
  for (int m = 0; m < kMaxRowsMv; ++m) acc1[m] = acc2[m] = 0.f;
#pragma unroll 2
  for (int k = 4 * lane; k < d_in; k += 128) {
    const uint32_t q1 = load4(r1, k, d_in, vec);
    const uint32_t q2 = load4(r2, k, d_in, vec);
    float b1[4], b2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b1[i] = byte_f32<W>(q1, i);
      b2[i] = byte_f32<W>(q2, i);
    }
#pragma unroll
    for (int m = 0; m < kMaxRowsMv; ++m) {
      if (m >= M) break;
      const float* s1 = xs + m * d_in + k;
      const float* s2 = xs + (M + m) * d_in + k;
      if (vec) {   // 16-byte rows: d_in % 4 == 0
        const float4 u = *reinterpret_cast<const float4*>(s1);
        const float4 v = *reinterpret_cast<const float4*>(s2);
        acc1[m] = fmaf(u.w, b1[3], fmaf(u.z, b1[2],
                       fmaf(u.y, b1[1], fmaf(u.x, b1[0], acc1[m]))));
        acc2[m] = fmaf(v.w, b2[3], fmaf(v.z, b2[2],
                       fmaf(v.y, b2[1], fmaf(v.x, b2[0], acc2[m]))));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + i < d_in) {
            acc1[m] = fmaf(s1[i], b1[i], acc1[m]);
            acc2[m] = fmaf(s2[i], b2[i], acc2[m]);
          }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxRowsMv; ++m) {
    if (m >= M) break;
    const float u = warp_sum(acc1[m]), v = warp_sum(acc2[m]);
    if (lane == 0) store_out<T, kTwo>(a, m, g, o, u, v);
  }
}

// the decode kernel, for up to kMaxRowsMv rows whose two x views (as
// fp32) fit in kMvSmem bytes of shared memory; the plan sends every other
// call to the tensor cores
template <typename T, typename W, bool kTwo>
cudaError_t launch(const QArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * (size_t)a.M * a.d_in;
  if (a.M > kMaxRowsMv || smem > kMvSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dyad_mv_q_kernel<T, W, kTwo>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const bool aligned = (reinterpret_cast<uintptr_t>(a.w[0]) % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(a.w[1]) % 4 == 0);
  const int vec = (a.d_in % 4 == 0) && aligned;
  dim3 grid((a.d_out + kMvWarps - 1) / kMvWarps, a.n);
  dyad_mv_q_kernel<T, W, kTwo><<<grid, kMvWarps * 32, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

// -- the tensor-core routes -------------------------------------------------

// the k split and how each operand reaches shared memory
struct QTc {
  float* part;     // (split, 2, n, M, d_out) scaled fp32 partials, or null
  int split, krows;
  int xload[2];    // tc::Load of x_c
  int vec[2];      // payload c in 16-byte copies
};

// The epilogue of both routes: a warpgroup's accumulators (register
// 4 j + 2 h + e of a thread holds row 16 warp + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + e of its 64 x 128 tile at rows r0w, columns o0),
// each column's scale multiplying its sum, into z_c (O, x's dtype) or
// into the fp32 partials of split s
template <typename O>
__device__ __forceinline__ void store_q(const QArgs& a, const QTc& q, int c,
                                        int g, int s, int r0w, int o0,
                                        const float (&acc)[64]) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const float* sc = a.s[c] + (long long)g * a.d_out;
  float* part = q.part ? q.part + (((long long)s * 2 + c) * a.n + g) *
                                      a.M * a.d_out
                       : nullptr;
  O* zc = static_cast<O*>(a.z[c]) + g * a.z_sg[c];
  const long long z_sb = a.z_sb[c], z_so = a.z_so[c];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0w + warp * 16 + lane / 4 + 8 * h;
    if (r >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int o = o0 + 8 * j + 2 * (lane % 4);
      if (o >= a.d_out) continue;
      const bool both = o + 1 < a.d_out;
      const float v0 = acc[4 * j + 2 * h] * __ldg(sc + o);
      const float v1 = both ? acc[4 * j + 2 * h + 1] * __ldg(sc + o + 1)
                            : 0.f;
      if (part) {
        float* d = part + (long long)r * a.d_out + o;
        const bool pair =
            both && (reinterpret_cast<unsigned long long>(d) & 7) == 0;
        tc::store2(d, pair, v0, v1);
        if (!pair) {
          d[0] = v0;
          if (both) d[1] = v1;
        }
      } else {
        O* d = zc + r * z_sb + o * z_so;
        const bool pair = both && z_so == 1 &&
                          (reinterpret_cast<unsigned long long>(d) &
                           (2 * sizeof(O) - 1)) == 0;
        tc::store2(d, pair, v0, v1);
        if (!pair) {
          d[0] = from_f32<O>(v0);
          if (both) d[z_so] = from_f32<O>(v1);
        }
      }
    }
  }
}

constexpr int kQStages = 6, kQAhead = kQStages - 2;
constexpr int kQRaw = qtc::raw_bytes<tc::kBN>();          // 8 KB
constexpr int kQStage = tc::kTileBytes + kQRaw;           // x, then raw
constexpr int kQSmem = kQStages * kQStage + 2 * tc::kTileBytes + 1024;
static_assert(kQStage % 1024 == 0, "swizzled tiles start on 1 KB");
static_assert(kQSmem <= 232448, "over the H100's 227 KB a block");

// the bf16-x route: a k step of 64, one bf16 wgmma product a pair
template <typename W>
__global__ void __launch_bounds__(tc::kThreads, 1)
    dyad_mm_q_tc_kernel(QArgs a, QTc q) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t conv = base + kQStages * kQStage;   // two bf16 tiles

  const int z = blockIdx.z;
  const int g = z % a.n, c = (z / a.n) % 2, s = z / (2 * a.n);
  const int r0 = blockIdx.y * tc::kBM, o0 = blockIdx.x * tc::kBN;
  const int k_begin = s * q.krows;
  const int k_end = min(a.d_in, k_begin + q.krows);
  const int T =
      k_end > k_begin ? (k_end - k_begin + tc::kBK - 1) / tc::kBK : 0;
  const int w = threadIdx.x / 128;
  const int mode = q.xload[c];
  const tc::Operand xo{
      static_cast<const unsigned short*>(a.x[c]) + g * a.x_sg[c],
      a.x_sb[c], a.x_sk[c], a.M};
  const qtc::Operand wo{static_cast<const uint8_t*>(a.w[c]) +
                            (long long)g * a.d_out * a.d_in,
                        a.d_in, a.d_out};
  auto slot = [&](int t) { return base + (t % kQStages) * kQStage; };

  // a gathered x tile's loads fly for one iteration before their stores
  uint4 raw[tc::kPairs];
  auto issue = [&](int t) {
    if (t < T) {
      const int k0 = k_begin + t * tc::kBK;
      if (mode == tc::kCopy)
        tc::copy_tile<true>(xo, r0, k0, k_end, slot(t));
      else
        tc::load_raw<true>(xo, mode, g, r0, k0, k_end, raw);
      qtc::copy_raw<tc::kBN>(wo, q.vec[c], o0, k0, k_end,
                             slot(t) + tc::kTileBytes);
    }
    tc::cp_async_commit();
  };
  auto store_gathered = [&](int t) {
    if (t < T && mode != tc::kCopy)
      tc::store_raw<true>(slot(t), mode, g, raw);
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  tc::fence_acc(acc);

  for (int t = 0; t < kQAhead; ++t) {
    if (t) store_gathered(t - 1);
    issue(t);
  }
  for (int t = 0; t < T; ++t) {
    // stage t has landed everywhere, and every warpgroup's products of
    // stage t - 2 are done: their converted tile takes stage t's
    tc::cp_async_wait<kQAhead - 1>();
    __syncthreads();
    const uint32_t cb = conv + (t & 1) * tc::kTileBytes;
    qtc::convert<W, tc::kBN>(slot(t) + tc::kTileBytes, cb);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < tc::kBK / 16; ++ks)
      tc::wgmma_m64n128k16<0, 0>(acc, tc::desc_a<true>(slot(t), w, ks),
                                 tc::desc_b<true>(cb, ks));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    store_gathered(t + kQAhead - 1);
    issue(t + kQAhead);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  tc::cp_async_wait<0>();
  tc::fence_acc(acc);
  store_q<__nv_bfloat16>(a, q, c, g, s, r0 + w * 64, o0, acc);
}

constexpr int kQ32Depth = 3;                               // the ring
constexpr int kQ32BK = qtc::kRawRow32;                     // k a stage
constexpr int kQ32Raw = qtc::raw_bytes<tc::kBN, kQ32BK>();   // 4 KB
constexpr int kQ32Stage = tc::kTileBytes + kQ32Raw;        // x, then raw
constexpr int kQ32Smem = kQ32Depth * kQ32Stage + 2 * tc::kTileBytes + 1024;
static_assert(kQ32Stage % 1024 == 0, "swizzled tiles start on 1 KB");
static_assert(tc::kBM * kQ32BK * 4 == tc::kTileBytes, "one 128-byte row");

// the fp32-x route: a k step of 32, x split into tf32 hi and lo in
// registers, the payload converted to fp32 (exact in tf32), two tf32
// wgmma products a pair into a partial of each stage's own
template <typename W>
__global__ void __launch_bounds__(tc::kThreads, 1)
    dyad_mm_q_tf32_kernel(QArgs a, QTc q) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t conv = base + kQ32Depth * kQ32Stage;   // two fp32 tiles

  const int z = blockIdx.z;
  const int g = z % a.n, c = (z / a.n) % 2, s = z / (2 * a.n);
  const int r0 = blockIdx.y * tc::kBM, o0 = blockIdx.x * tc::kBN;
  const int k_begin = s * q.krows;
  const int k_end = min(a.d_in, k_begin + q.krows);
  const int T =
      k_end > k_begin ? (k_end - k_begin + kQ32BK - 1) / kQ32BK : 0;
  const int w = threadIdx.x / 128;
  const bool copy_x = q.xload[c] == tc::kCopy;
  const tc::Operand32 xo{
      static_cast<const uint32_t*>(a.x[c]) + g * a.x_sg[c], a.x_sb[c],
      a.x_sk[c], a.M};
  const qtc::Operand wo{static_cast<const uint8_t*>(a.w[c]) +
                            (long long)g * a.d_out * a.d_in,
                        a.d_in, a.d_out};
  auto slot = [&](int t) { return base + (t % kQ32Depth) * kQ32Stage; };
  auto wtile = [&](int t) { return conv + (t & 1) * tc::kTileBytes; };

  // a gathered x tile (the stride-n x2) is loaded one iteration before it
  // is stored
  float raw[tc::kBM / 8];
  auto issue = [&](int t) {
    if (t < T) {
      const int k0 = k_begin + t * kQ32BK;
      if (copy_x)
        tc::copy_tile32<tc::kBM>(xo, r0, k0, k_end, slot(t));
      else
        tc::load_raw32<tc::kBM>(xo, r0, k0, k_end, raw);
      qtc::copy_raw<tc::kBN, kQ32BK>(wo, q.vec[c], o0, k0, k_end,
                                     slot(t) + tc::kTileBytes);
    }
    tc::cp_async_commit();
  };
  // this thread's part of stage t, once its copies have landed: its
  // gathered x stored, its payload chunk converted
  auto ready = [&](int t) {
    if (t < T) {
      if (!copy_x) tc::store_raw32<tc::kBM>(slot(t), raw);
      qtc::convert32<W, tc::kBN>(slot(t) + tc::kTileBytes, wtile(t));
    }
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  tc::fence_acc(part);
  issue(0);
  tc::cp_async_wait<0>();
  ready(0);
  issue(1);
  for (int t = 0; t < T; ++t) {
    // stage t stored and converted by every thread, and every warpgroup's
    // products of stage t - 1 done
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    uint32_t ah[16], al[16];
    tc::a_frags32(slot(t), w, ah, al);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // each k8 step: x_lo w, then x_hi w
#pragma unroll
    for (int ks = 0; ks < kQ32BK / 8; ++ks) {
      const uint32_t h4[4] = {ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2],
                              ah[4 * ks + 3]};
      const uint32_t l4[4] = {al[4 * ks], al[4 * ks + 1], al[4 * ks + 2],
                              al[4 * ks + 3]};
      const uint64_t b = tc::desc_b<true>(wtile(t), ks);
      tc::wgmma_m64n128k8_tf32_rs(part, l4, b, ks > 0);
      tc::wgmma_m64n128k8_tf32_rs(part, h4, b);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // under the products: stage t + 1 made ready (its copies and gathers
    // were issued an iteration ago) into the other fp32 tile, whose stage
    // t - 1 every warpgroup finished before the barrier above; stage t + 2
    // issued into the slot of stage t - 1
    tc::cp_async_wait<0>();
    ready(t + 1);
    issue(t + 2);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    tc::fence_acc(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  tc::cp_async_wait<0>();
  store_q<float>(a, q, c, g, s, r0 + w * 64, o0, acc);
}

// the second pass over the scaled partials, rounded once to x's dtype O:
// z_c = the sum over the splits (kTwo), or z = component 0's sum over the
// splits, then component 1's (the IT forward)
template <typename O, bool kTwo>
__global__ void dyad_mm_q_reduce(QArgs a, QTc q) {
  const long long per = (long long)a.n * a.M * a.d_out;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (kTwo ? 2 : 1) * per) return;
  const int c = kTwo ? (int)(e / per) : 0;
  const long long i = e % per;
  float sum = 0.f;
#pragma unroll 1
  for (int cc = c; cc < (kTwo ? c + 1 : 2); ++cc)
#pragma unroll 1
    for (int s = 0; s < q.split; ++s) sum += q.part[(2LL * s + cc) * per + i];
  const int o = (int)(i % a.d_out);
  const long long m = (i / a.d_out) % a.M;
  const int g = (int)(i / ((long long)a.M * a.d_out));
  static_cast<O*>(a.z[c])[m * a.z_sb[c] + g * a.z_sg[c] + o * a.z_so[c]] =
      from_f32<O>(sum);
}

// T: x's dtype (bf16, or fp32 on tf32); W: the payload's
template <typename T, typename W, bool kTwo>
cudaError_t launch_tc(const QArgs& a, QTc q, cudaStream_t stream) {
  constexpr bool kF32x = sizeof(T) == 4;
  constexpr int kDepth = kF32x ? kQ32BK : tc::kBK;   // k a stage
  // a split range starts on a stage (16-byte copies stay aligned); the
  // summed forward always goes through the partials
  if (q.split < 1 || q.krows < 1 || q.krows % kDepth ||
      (long long)q.split * q.krows < a.d_in ||
      ((q.split > 1 || !kTwo) && !q.part))
    return cudaErrorInvalidValue;
  if (kTwo && q.split == 1) q.part = nullptr;
  for (int c = 0; c < 2; ++c) {
    q.xload[c] = tc::load_of(a.x[c], a.x_sk[c], a.x_sb[c], a.x_sg[c], a.n,
                             16 / (int)sizeof(T));
    q.vec[c] = qtc::vec_ok(a.w[c], a.d_in);
  }
  auto kernel = kF32x ? dyad_mm_q_tf32_kernel<W> : dyad_mm_q_tc_kernel<W>;
  const int smem = kF32x ? kQ32Smem : kQSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.d_out + tc::kBN - 1) / tc::kBN, (a.M + tc::kBM - 1) / tc::kBM,
            2 * a.n * q.split);
  kernel<<<grid, tc::kThreads, smem, stream>>>(a, q);
  err = cudaGetLastError();
  if (err != cudaSuccess || !q.part) return err;
  const long long total = (kTwo ? 2LL : 1LL) * a.n * a.M * a.d_out;
  constexpr int kReduceThreads = 256;
  dyad_mm_q_reduce<T, kTwo><<<(unsigned)((total + kReduceThreads - 1) /
                                         kReduceThreads),
                              kReduceThreads, 0, stream>>>(a, q);
  return cudaGetLastError();
}

template <bool kTwo>
int dispatch(const QArgs& a, const QTc& q, int dtype, int wdtype, int tc,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.M == 0 || a.n == 0 || a.d_out == 0) return cudaSuccess;
  if (tc) {   // the tensor cores: bf16 products, or fp32 x on tf32
    if (dtype == kBF16 && wdtype == kInt8)
      return launch_tc<__nv_bfloat16, int8_t, kTwo>(a, q, s);
    if (dtype == kBF16 && wdtype == kE4M3)
      return launch_tc<__nv_bfloat16, __nv_fp8_e4m3, kTwo>(a, q, s);
    if (dtype == kF32 && wdtype == kInt8)
      return launch_tc<float, int8_t, kTwo>(a, q, s);
    if (dtype == kF32 && wdtype == kE4M3)
      return launch_tc<float, __nv_fp8_e4m3, kTwo>(a, q, s);
    return cudaErrorInvalidValue;
  }
  if (dtype == kF32 && wdtype == kInt8)
    return launch<float, int8_t, kTwo>(a, s);
  if (dtype == kF32 && wdtype == kE4M3)
    return launch<float, __nv_fp8_e4m3, kTwo>(a, s);
  if (dtype == kBF16 && wdtype == kInt8)
    return launch<__nv_bfloat16, int8_t, kTwo>(a, s);
  if (dtype == kBF16 && wdtype == kE4M3)
    return launch<__nv_bfloat16, __nv_fp8_e4m3, kTwo>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

// tc: the tensor-core route with the k split into `split` ranges of
// `krows` (a multiple of the route's stage: 64 for bf16 x, 32 for fp32)
// and the partials in `part` ((split, 2, n, M, d_out) fp32; always for the
// summed forward, else for split > 1); else the FMA decode kernel (M <= 8,
// both x views within 200 KB of shared memory; part, split, krows unused)
extern "C" int repro_dyad_mm_blocks_q(
    const void* x1, const void* x2, const void* w1, const void* w2,
    const float* s1, const float* s2, void* out, float* part, int M, int n,
    int d_in, int d_out, int split, int krows, long long x1_sb,
    long long x1_sg, long long x1_sk, long long x2_sb, long long x2_sg,
    long long x2_sk, long long o_sb, long long o_sg, long long o_so,
    int dtype, int wdtype, int tc, void* stream) {
  repro::QArgs a{{x1, x2},     {x1_sb, x2_sb}, {x1_sg, x2_sg},
                 {x1_sk, x2_sk}, {w1, w2},     {s1, s2},
                 {out, nullptr}, {o_sb, 0},    {o_sg, 0},
                 {o_so, 0},      M,            n,
                 d_in,           d_out};
  const repro::QTc q{part, split, krows, {0, 0}, {0, 0}};
  return repro::dispatch<false>(a, q, dtype, wdtype, tc, stream);
}

extern "C" int repro_dyad_mm_blocks_two_q(
    const void* x1, const void* x2, const void* w1, const void* w2,
    const float* s1, const float* s2, void* z1, void* z2, float* part,
    int M, int n, int d_in, int d_out, int split, int krows,
    long long x1_sb, long long x1_sg, long long x1_sk, long long x2_sb,
    long long x2_sg, long long x2_sk, long long z1_sb, long long z1_sg,
    long long z1_so, long long z2_sb, long long z2_sg, long long z2_so,
    int dtype, int wdtype, int tc, void* stream) {
  repro::QArgs a{{x1, x2},     {x1_sb, x2_sb}, {x1_sg, x2_sg},
                 {x1_sk, x2_sk}, {w1, w2},     {s1, s2},
                 {z1, z2},       {z1_sb, z2_sb}, {z1_sg, z2_sg},
                 {z1_so, z2_so}, M,            n,
                 d_in,           d_out};
  const repro::QTc q{part, split, krows, {0, 0}, {0, 0}};
  return repro::dispatch<true>(a, q, dtype, wdtype, tc, stream);
}
