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
// fp32, split TF32 (dyad_dgrad_tf32_kernel below): at OPT-125m's training
// shapes (d_in x d_out = 192 x 768 or 768 x 192, M 4096) a call does 9.7
// GFLOP on about 28 MB: 0.059 ms as three TF32 products at 495 TFLOP/s
// (0.144 ms at fp32 FMA's 67), operations.  tf32 wgmma reads its shared
// operands K-major only (k = o here), and w[g] lies o x i, i contiguous:
// as the B of dx = z w it is N-major.  Of the two ways round that, staging
// w's tile as it lies and transposing it into K-major hi and lo tiles in
// shared memory, or computing the transposed product
//
//   dx_c^T[i, r] = sum_o w_c[g][o, i] z_c[r, g, o]
//
// with w^T as wgmma's register A, read from w's tile as it lies, and z
// (o contiguous) as the K-major B, this takes the second: no transpose
// pass, no barrier between a stage's landing and its split, and w's copies
// coalesced along i (the mainloop's own instantiation for fp32 would
// gather w element by element at a stride of d_in).  The design, on the
// pieces of dyad_gemm_tc.cuh's split-TF32 mainloop:
//
// - A block is one warpgroup and owns 64 i x 128 rows of dx_c^T
//   (m64n128k8 tf32): 64 i tiles d_in 192 and 768 exactly (a 128-wide
//   tile would compute 256 columns for 192).  Grid (rows / 128 / tiles,
//   d_in / 64, 2 n).
// - A stage is 32 o: w's [32 o][64 i] tile as it lies (cp.async, 16 bytes
//   along i; rows padded to 72 floats, so that a warp's fragment loads, 8
//   i by 4 o, hit 32 banks), split in registers as each thread loads its
//   fragments; z's [128 rows][32 o] tile K-major, landing raw in its hi
//   tile and split in shared memory by the thread that copied each chunk
//   (a DT strided z2 gathered and split as it is stored, 8 elements a
//   thread at a time).  41 KB a stage, two stages: stage t + 1 issues
//   once every warp is done with stage t - 1 and lands under stage t's
//   products.  83 KB and at most 255 registers a thread let two blocks
//   share an SM, each running while the other waits (on the card this
//   beat a block of two warpgroups over 256 rows with three stages, one
//   block an SM).
// - A short d_out (the down projection's 192: 6 stages) would pay a
//   pipeline's start and end for every tile, so a block takes up to four
//   row tiles in turn through one pipeline (tiles_of), the next tile's
//   stages loading under the last ones of the tile before.
// - Each stage's 12 wgmma sum into a fresh partial, added into the fp32
//   accumulator with fp32 adds (the error model of dyad_gemm_tc.cuh's
//   header).
// - The epilogue writes the transposed accumulator into dx_c (i along a
//   quad's lanes: 32 contiguous bytes of a dx1 row a store; the permuted
//   dx2, column stride n, a 4-byte element each).
#include "dyad_gemm_tc.cuh"

namespace repro {
namespace dgrad32 {

constexpr int kI = 64;            // i (d_in) of a block
constexpr int kK = 32;            // o a stage
constexpr int kWP = kI + 8;       // floats a row of w's staged tile
constexpr int kWTile = kK * kWP * 4;        // 9 KB
static_assert(kWTile % 1024 == 0, "stage layout");

constexpr int kThreads = 128;     // one warpgroup
constexpr int kRows = 128;        // rows of a block
constexpr int kZTile = kRows * kK * 4;      // 16 KB: z's hi tile, then lo
constexpr int kStage = kWTile + 2 * kZTile;
constexpr int kDepth = 2;
constexpr int kSmem = kDepth * kStage + 1024;
static_assert(kSmem <= tc::kTwoPerSm, "two blocks an SM");

// A thread's tf32 A fragments of the stage, w^T (64 i x 32 o), split: k8
// step s in hi[4 s .. 4 s + 3] and lo[...], element e at i = 16 warp +
// lane / 4 + 8 (e & 1), o = 8 s + lane % 4 + 4 (e >> 1) of w's [32 o][kWP]
// tile
__device__ __forceinline__ void w_frags(uint32_t tile, uint32_t (&hi)[16],
                                        uint32_t (&lo)[16]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    const int s = x / 4, e = x % 4;
    const int o = 8 * s + lane % 4 + 4 * (e >> 1);
    const int i = 16 * warp + lane / 4 + 8 * (e & 1);
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(v)
                 : "r"(tile + 4 * (o * kWP + i)));
    tc::split_tf32(v, hi[x], lo[x]);
  }
}

// z's [kRows][32 o] tile, K-major: chunk e (16 bytes, o 4 (e % 8) .. + 3
// of row e / 8) is the thread's for e = tid + 128 x; copied raw into the
// hi tile (copy_z), then split by the same thread (split_z)
__device__ __forceinline__ void copy_z(const tc::Operand32& z, int r0,
                                       int k0, int k_end, uint32_t hi) {
#pragma unroll
  for (int x = 0; x < kRows * 8 / kThreads; ++x) {
    const int e = threadIdx.x + x * kThreads;
    const int gm = r0 + (e >> 3), gk = k0 + (e & 7) * 4;
    const int n = gm < z.ext ? min(max(k_end - gk, 0), 4) : 0;
    tc::cp_async16(hi + tc::tile_off<true>(e >> 3, 2 * ((e & 7) * 4)),
                   n ? z.p + gm * z.s_mn + gk : z.p, 4 * n);
  }
}
__device__ __forceinline__ void split_z(uint32_t hi) {
#pragma unroll
  for (int x = 0; x < kRows * 8 / kThreads; ++x) {
    const int e = threadIdx.x + x * kThreads;
    const uint32_t off = tc::tile_off<true>(e >> 3, 2 * ((e & 7) * 4));
    tc::split_chunk(hi + off, hi + kZTile + off);
  }
}

// z's tile gathered element by element (a DT strided z2) and split into
// its hi and lo tiles, 8 elements a thread at a time (32 at once, live
// beside acc, part and the fragments, made ptxas spill)
__device__ __forceinline__ void gather_z(const tc::Operand32& z, int r0,
                                         int k0, int k_end, uint32_t hi) {
#pragma unroll 1
  for (int x0 = 0; x0 < kRows * kK / kThreads; x0 += 8) {
    float v[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int q = threadIdx.x + (x0 + x) * kThreads;
      const int gm = r0 + (q >> 5), gk = k0 + (q & 31);
      v[x] = gm < z.ext && gk < k_end
                 ? __uint_as_float(__ldg(z.p + gm * z.s_mn + gk * z.s_k))
                 : 0.f;
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int q = threadIdx.x + (x0 + x) * kThreads;
      const uint32_t off = tc::tile_off<true>(q >> 5, 2 * (q & 31));
      uint32_t h, l;
      tc::split_tf32(v[x], h, l);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(hi + off), "r"(h));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(hi + kZTile + off),
                   "r"(l));
    }
  }
}

// C_c[g][r, i] = sum_o A_c[g][r, o] B_c[g][o, i] as DyadGemmArgs give it
// (A = z, B = w, C = dx; split 1), computed transposed; f.a the load of z
// (kCopy or kGather), f.b of w.  The block takes `tiles` tiles of kRows
// rows in turn through one pipeline of stages: tile u + 1's first stages
// load under tile u's last ones
__global__ void __launch_bounds__(kThreads, 2)
    dyad_dgrad_tf32_kernel(DyadGemmArgs a, tc::TcFlags f, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const int g = blockIdx.z % a.n, c = blockIdx.z / a.n;
  const int first = blockIdx.x * tiles, i0 = blockIdx.y * kI;
  // stages a tile (one of zeros where d_out is 0: dx is then written 0)
  const int T = max(1, (a.K + kK - 1) / kK);
  const int TT = T * min(tiles, (a.R + kRows - 1) / kRows - first);

  const tc::Operand32 z{static_cast<const uint32_t*>(a.A[c]) + g * a.a_sg[c],
                        a.a_sr[c], a.a_sk[c], a.R};
  const uint32_t* wp = static_cast<const uint32_t*>(a.B[c]) + g * a.b_sg[c];
  const long long w_so = a.b_sk[c], w_si = a.b_sj[c];
  const bool z_copy = f.a[c] == tc::kCopy, w_copy = f.b[c] == tc::kCopy;
  auto stage = [&](int t) { return base + (t % kDepth) * kStage; };

  auto issue = [&](int t) {
    if (t < TT) {
      const int u = t / T, k0 = (t - u * T) * kK, r0 = (first + u) * kRows;
      const uint32_t ws = stage(t), zs = ws + kWTile;
      if (w_copy) {
        // 16 chunks of 4 i a row of 32 o
#pragma unroll
        for (int x = 0; x < kK * kI / 4 / kThreads; ++x) {
          const int e = threadIdx.x + x * kThreads;
          const int o = e / (kI / 4), i = (e % (kI / 4)) * 4;
          const int go = k0 + o, gi = i0 + i;
          const int n = go < a.K ? min(max(a.N - gi, 0), 4) : 0;
          tc::cp_async16(ws + 4 * (o * kWP + i),
                         n ? wp + go * w_so + gi : wp, 4 * n);
        }
      } else {
#pragma unroll 4
        for (int x = 0; x < kK * kI / kThreads; ++x) {
          const int e = threadIdx.x + x * kThreads;
          const int o = e / kI, i = e % kI;
          const int go = k0 + o, gi = i0 + i;
          const uint32_t v =
              go < a.K && gi < a.N ? __ldg(wp + go * w_so + gi * w_si) : 0u;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           ws + 4 * (o * kWP + i)),
                       "r"(v));
        }
      }
      if (z_copy)
        copy_z(z, r0, k0, a.K, zs);
      else
        gather_z(z, r0, k0, a.K, zs);
    }
    tc::cp_async_commit();
  };
  // this thread's copied z chunks of stage t, once landed, split
  auto ready = [&](int t) {
    if (t < TT && z_copy) split_z(stage(t) + kWTile);
  };

  // as in the split-TF32 mainloop of dyad_gemm_tc.cuh: each stage's
  // products in a fresh partial, added into acc with fp32 adds once done
  float acc[64], part[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = part[x] = 0.f;
  tc::fence_acc(part);
  issue(0);
  tc::cp_async_wait<0>();
  ready(0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* C = static_cast<float*>(a.C[c]) + g * a.c_sg[c];
  const long long c_sr = a.c_sr[c], c_sj = a.c_sj[c];
  for (int t = 0; t < TT; ++t) {
    // stage t landed, split and stored by every thread
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // stage t + 1 issued into the slot of stage t - 1, whose products and
    // fragment loads every warp finished before the barrier above
    issue(t + 1);
    const uint32_t ws = stage(t), zs = ws + kWTile;
    uint32_t ah[16], al[16];
    w_frags(ws, ah, al);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kK / 8; ++ks) {
      const uint32_t h4[4] = {ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2],
                              ah[4 * ks + 3]};
      const uint32_t l4[4] = {al[4 * ks], al[4 * ks + 1], al[4 * ks + 2],
                              al[4 * ks + 3]};
      const uint64_t bh = tc::desc_b<true>(zs, ks),
                     bl = tc::desc_b<true>(zs + kZTile, ks);
      tc::wgmma_m64n128k8_tf32_rs(part, l4, bh, ks > 0);
      tc::wgmma_m64n128k8_tf32_rs(part, h4, bl);
      tc::wgmma_m64n128k8_tf32_rs(part, h4, bh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // under the products: stage t + 1 landed and made ready
    tc::cp_async_wait<0>();
    ready(t + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    tc::fence_acc(part);
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[x] += part[x];
    if ((t + 1) % T) continue;
    // tile t / T is summed: acc register 4 j + 2 hh + e holds i = i0 +
    // 16 warp + lane / 4 + 8 hh, row r0 + 8 j + 2 (lane % 4) + e
    const int r0 = (first + t / T) * kRows;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = i0 + 16 * warp + lane / 4 + 8 * hh;
      if (i >= a.N) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * j + 2 * (lane % 4) + e;
          if (r < a.R) C[r * c_sr + i * c_sj] = acc[4 * j + 2 * hh + e];
        }
    }
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  }
  tc::cp_async_wait<0>();
}

// the row tiles a block takes: enough for some 24 stages of o, at most
// four (a call whose d_out is short otherwise pays a whole pipeline's
// start and end for a few stages)
inline int tiles_of(int d_out) {
  const int T = (d_out + kK - 1) / kK;
  return T >= 24 ? 1 : min(4, (24 + T - 1) / T);
}

cudaError_t launch(const DyadGemmArgs& a, cudaStream_t stream) {
  if (a.split != 1 || a.part) return cudaErrorInvalidValue;
  if (a.n == 0 || a.R == 0 || a.N == 0) return cudaSuccess;
  tc::TcFlags f;
  for (int c = 0; c < 2; ++c) {
    f.a[c] = tc::load_of(a.A[c], a.a_sk[c], a.a_sr[c], a.a_sg[c], a.n, 4);
    f.b[c] = tc::load_of(a.B[c], a.b_sj[c], a.b_sk[c], a.b_sg[c], a.n, 4);
  }
  cudaError_t err = cudaFuncSetAttribute(
      dyad_dgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = tiles_of(a.K);
  const int row_tiles = (a.R + kRows - 1) / kRows;
  dim3 grid((row_tiles + tiles - 1) / tiles, (a.N + kI - 1) / kI, 2 * a.n);
  dyad_dgrad_tf32_kernel<<<grid, kThreads, kSmem, stream>>>(a, f, tiles);
  return cudaGetLastError();
}

}  // namespace dgrad32
}  // namespace repro

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
    case repro::kF32:   // split TF32, transposed: w^T register A, z B
      return repro::dgrad32::launch(a, s);
    case repro::kBF16:   // A = z (b x o) K-major, B = w[g] (o x i) N-major
      return repro::tc::launch<true, false, __nv_bfloat16>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}
