// The transposed split-TF32 GEMM of the DYAD backward: fp32
// dyad_mm_dgrad_two (dyad_dgrad.cu), dyad_mm_dgrad (dyad_dgrad_fused.cu,
// Fuse) and dyad_mm_wgrad (dyad_wgrad.cu) on the H100's tensor cores.  For
// two components c and n dyad blocks g it computes
//
//   D_c[g][m, j] = sum_k A_c[g][k, m] * B_c[g][j, k]
//
// with A read as it lies (contiguous along m, or gathered through its
// strides) and B staged K-major, each operand read through its own strides
// and D written through its own (or, with split > 1, into fp32 partials
// laid out as D, that gemm::dyad_gemm_reduce adds in split order).
//
// Why this shape: tf32 wgmma reads its shared-memory operands K-major only,
// and in the backward neither operand of the natural product lies so.
//  - dgrad, dx_c = z_c w_c: w[g] lies o x i (i contiguous), k = o.  The
//    product runs transposed, dx^T[i, r] = sum_o w[o, i] z[r, o]: A = w
//    (m = i), B = z (j = r; the cotangent is contiguous along o = k, so a
//    K-major copy; the stride-n DT z2 and OT z2bar are gathered).
//  - wgrad, dw_c[g][o, i] = sum_r z[r, g, o] x[r, g, i], k = r (the M rows):
//    both operands are contiguous along their m or j side, neither along
//    k.  One is A, read as it lies; B, the other, is transposed on its way
//    in (copy_bt, split_bt) by the same pass that splits it, so the
//    transpose costs no pass of its own.  D = dw or dw^T through dw's
//    strides.  Which is A (dyad_mm.wgrad_orient): the way with fewer tiles,
//    and on a tie the operand with a stride-n view, whose gather then runs
//    along A's m (at OPT-125m's 192 x 768 and 768 x 192 blocks both ways
//    take 3 x 8 or 12 x 2 tiles of 64 x 96, so A is x for the IT views and
//    z for the OT ones).
//
// The split-TF32 arithmetic and its error model are dyad_gemm_tc.cuh's:
// a = a_hi + a_lo, each cvt.rna.tf32, three tf32 products a pair (a_lo b_hi
// + a_hi b_lo + a_hi b_hi, small terms first), each stage's products into a
// fresh partial added into the fp32 accumulator with fp32 adds (one
// accumulator over all of k failed the float64 gate; two partials in turn
// made ptxas serialise every wgmma).
//
// A block is one warpgroup and owns 64 m x J j of D (m64nJk8 tf32, A from
// registers, B from shared memory; J 128 for dyad_mm_dgrad_two, 96 for
// dyad_mm_dgrad and dyad_mm_wgrad, which tile 192 and 768 exactly and
// leave registers for a deferred gather of B).  A stage is 32 k:
//  - A's [32 k][64 m] tile as it lies, rows padded to 72 floats (a warp's
//    fragment loads, 8 m by 4 k, hit 32 banks): cp.async 16 bytes along m,
//    or a gathered view (the stride-n x2 and z2bar) loaded element by
//    element, neighbouring lanes on neighbouring m; each thread reads its
//    fragments of it (a_frags) and splits them in registers.
//  - B's hi and lo tiles, [J j][32 k] each in wgmma's 128-byte-swizzled
//    K-major layout.  Contiguous along k (the dgrad z): copied raw into the
//    hi tile, split in place by the thread that copied each chunk
//    (split_bk).  Contiguous along j (the wgrad's B): each thread copies
//    blocks of 4 j x 4 k, the four 16-byte rows of a block landing where
//    the block's four K-major chunks will lie; once landed it reads the
//    four back, transposes them in registers, splits and stores hi in
//    place and lo beside (split_bt): no barrier, since a thread reads only
//    what it copied.  A phase of 8 lanes takes one j block over the 8 k
//    chunks of a 128-byte row, so the 16-byte shared accesses hit 32
//    banks, and the copies of a warp read 64 contiguous bytes from each of
//    8 rows of B.  Any other B is gathered element by element, a warp on
//    the 32 k of a row (load_b, store_b).
//  - Two stages (41 KB each at J 128, 33 KB at 96) and at most 255
//    registers a thread let two blocks share an SM, each running while the
//    other waits (on the card a third stage, or J 64 with four, was no
//    faster).  Stage t + 1's copies issue once every warp is done with
//    stage t - 1 and land under stage t's products.  The wgrad's gathered
//    A (16 elements a thread) and, at J 96, the dgrad's gathered B (24)
//    are loaded an iteration before they are stored: stage t + 2's under
//    stage t's products, stored under stage t + 1's (Defer).  Any other
//    gather (B's 32 at J 128 made ptxas spill) is loaded and stored at
//    once under the products, 8 elements at a time.
//  - dgrad: a block takes up to four j tiles (rows of dx) in turn through
//    one pipeline (tiles_of: a short d_out pays a pipeline's start and end
//    for few stages otherwise).  Fuse (dyad_mm_dgrad): a tile's stages run
//    over component 0's k range, then component 1's, into one accumulator
//    (grid z over g only).  wgrad: one tile a block; the M rows split into
//    fixed ranges (grid z over split, c, g; dyad_mm.wgrad_split) when the
//    tiles alone leave the card's block slots idle.
//  - The epilogue writes the accumulator through D's strides (dx: a quad's
//    lanes on 32 contiguous bytes of a row; the permuted dx2 4-byte
//    elements).
//
// Determinism: no atomics; fixed stage order and split reduction.
#pragma once

#include "dyad_gemm_tc.cuh"

namespace repro {
namespace tf32t {

constexpr int kM = 64;                 // m of a block: one warpgroup
constexpr int kK = 32;                 // k a stage: one 128-byte row
constexpr int kAP = kM + 8;            // floats a row of A's staged tile
constexpr int kATile = kK * kAP * 4;   // 9 KB
constexpr int kThreads = 128;
constexpr int kAGather = kK * kM / kThreads;   // A elements a thread gathers
// bytes of B's hi tile (then its lo) at a j of J
__host__ __device__ constexpr int b_tile(int J) { return J * kK * 4; }

constexpr int kDepth = 2;              // stages in the ring

// the tiles at J, the j of a block (wgmma's n: 96 or 128)
template <int J>
struct Cfg {
  static constexpr int kBTile = b_tile(J);
  static constexpr int kStage = kATile + 2 * kBTile;
  static constexpr int kSmem = kDepth * kStage + 1024;
  static constexpr int kBGather = J * kK / kThreads;   // B elements a thread
  static_assert(J == 96 || J == 128, "wgmma n");
  static_assert(kStage % 1024 == 0 && kATile % 1024 == 0, "stage layout");
  static_assert(kSmem <= tc::kTwoPerSm, "two blocks an SM");
};

// which gathered operand a kernel loads an iteration before it stores it
// (the others are loaded and stored at once, 8 elements at a time): the
// wgrad's A (16 registers a thread), the fused dgrad's B at J 96 (24; at J
// 128 its 32 made ptxas spill)
enum Defer : int { kDeferNone = 0, kDeferA = 1, kDeferB = 2 };

// how an operand of one component reaches shared memory
enum Load : int {
  kGather = 0,   // element by element through its strides
  kCopy = 1,     // cp.async along its staged axis (A: m; B: k, K-major)
  kCopyT = 2,    // B only: cp.async along j, transposed by split_bt
};
struct Flags {
  int a[2], b[2];   // Load, per component
};

struct Args {
  const void* A[2];                      // element (k, m) at
  long long a_sg[2], a_sk[2], a_sm[2];   //   A + g a_sg + k a_sk + m a_sm
  const void* B[2];                      // element (j, k)
  long long b_sg[2], b_sj[2], b_sk[2];
  void* C[2];                            // D's element (m, j)
  long long c_sg[2], c_sm[2], c_sj[2];
  float* part;        // split > 1: (split, 2, n) blocks of part_sg floats,
  long long part_sg;  //   each laid out as D (which is then contiguous)
  int n, Mx, Jx, K;   // extents of m, j and k
  int split, krows;   // k summed in split ranges of krows (a multiple of kK)
};

// A's [kK][kAP] tile as it lies: chunk e (4 m of row k) is the thread's for
// e = tid + 128 x
__device__ __forceinline__ void copy_a(const uint32_t* p, long long s_k,
                                       int m0, int Mx, int k0, int k_end,
                                       uint32_t as) {
#pragma unroll
  for (int x = 0; x < kK * kM / 4 / kThreads; ++x) {
    const int e = threadIdx.x + x * kThreads;
    const int k = e / (kM / 4), m = (e % (kM / 4)) * 4;
    const int gk = k0 + k, gm = m0 + m;
    const int n = gk < k_end ? min(max(Mx - gm, 0), 4) : 0;
    tc::cp_async16(as + 4 * (k * kAP + m), n ? p + gk * s_k + gm : p, 4 * n);
  }
}

// A's tile element by element (a stride-n view): element x of the thread
// is (k, m) = (e / 64, e % 64), e = tid + 128 x, neighbouring lanes on
// neighbouring m; load_a issues the loads of elements [x0, x0 + N), store_a
// stores them (an iteration later where deferred: the loads fly under a
// stage's products)
template <int N, int R>
__device__ __forceinline__ void load_a(const uint32_t* p, long long s_k,
                                       long long s_m, int m0, int Mx, int k0,
                                       int k_end, int x0, uint32_t (&v)[R]) {
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int e = threadIdx.x + (x0 + x) * kThreads;
    const int gk = k0 + e / kM, gm = m0 + e % kM;
    v[x] = gk < k_end && gm < Mx ? __ldg(p + gk * s_k + gm * s_m) : 0u;
  }
}
template <int N, int R>
__device__ __forceinline__ void store_a(uint32_t as, int x0,
                                        const uint32_t (&v)[R]) {
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int e = threadIdx.x + (x0 + x) * kThreads;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                     as + 4 * ((e / kM) * kAP + e % kM)),
                 "r"(v[x]));
  }
}

// A thread's tf32 A fragments of the stage, A^T (64 m x 32 k), split: k8
// step s in hi[4 s .. 4 s + 3] and lo[...], element e at m = 16 warp +
// lane / 4 + 8 (e & 1), k = 8 s + lane % 4 + 4 (e >> 1) of A's tile
__device__ __forceinline__ void a_frags(uint32_t as, uint32_t (&hi)[16],
                                        uint32_t (&lo)[16]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    const int s = x / 4, e = x % 4;
    const int k = 8 * s + lane % 4 + 4 * (e >> 1);
    const int m = 16 * warp + lane / 4 + 8 * (e & 1);
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(v)
                 : "r"(as + 4 * (k * kAP + m)));
    tc::split_tf32(v, hi[x], lo[x]);
  }
}

// B contiguous along k: chunk e (16 bytes, k 4 (e % 8) .. + 3 of row e / 8)
// is the thread's for e = tid + 128 x; copied raw into the hi tile
// (copy_bk), then split in place by the same thread (split_bk)
template <int J>
__device__ __forceinline__ void copy_bk(const uint32_t* p, long long s_j,
                                        int j0, int Jx, int k0, int k_end,
                                        uint32_t bs) {
#pragma unroll
  for (int x = 0; x < J * 8 / kThreads; ++x) {
    const int e = threadIdx.x + x * kThreads;
    const int gj = j0 + (e >> 3), gk = k0 + (e & 7) * 4;
    const int n = gj < Jx ? min(max(k_end - gk, 0), 4) : 0;
    tc::cp_async16(bs + tc::tile_off<true>(e >> 3, 2 * ((e & 7) * 4)),
                   n ? p + gj * s_j + gk : p, 4 * n);
  }
}
template <int J>
__device__ __forceinline__ void split_bk(uint32_t bs) {
#pragma unroll
  for (int x = 0; x < J * 8 / kThreads; ++x) {
    const int e = threadIdx.x + x * kThreads;
    const uint32_t off = tc::tile_off<true>(e >> 3, 2 * ((e & 7) * 4));
    tc::split_chunk(bs + off, bs + b_tile(J) + off);
  }
}

// B contiguous along j: the thread's blocks x of 4 j x 4 k, at k chunk rc
// = lane % 8 (k 4 rc .. + 3) and j 4 jb .. + 3, jb = lane / 8 + 4 (warp +
// 4 x) < J / 4.  Raw row k = 4 rc + q of a block (4 j, 16 bytes) lands in
// the hi tile where the K-major chunk rc of row j = 4 jb + q lies
template <int J>
__device__ __forceinline__ void copy_bt(const uint32_t* p, long long s_k,
                                        int j0, int Jx, int k0, int k_end,
                                        uint32_t bs) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rc = lane % 8;
#pragma unroll
  for (int x = 0; x < (J / 4 + 15) / 16; ++x) {
    const int jb = lane / 8 + 4 * (warp + 4 * x);
    if (jb >= J / 4) continue;
    const int gj = j0 + 4 * jb;
    const int nj = min(max(Jx - gj, 0), 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gk = k0 + 4 * rc + q;
      const int n = gk < k_end ? nj : 0;
      tc::cp_async16(bs + tc::tile_off<true>(4 * jb + q, 8 * rc),
                     n ? p + gk * s_k + gj : p, 4 * n);
    }
  }
}
// once copy_bt's rows have landed: each block's four rows read back,
// transposed in registers, split, hi stored over them and lo beside
template <int J>
__device__ __forceinline__ void split_bt(uint32_t bs) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rc = lane % 8;
#pragma unroll
  for (int x = 0; x < (J / 4 + 15) / 16; ++x) {
    const int jb = lane / 8 + 4 * (warp + 4 * x);
    if (jb >= J / 4) continue;
    float v[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[q][0]), "=f"(v[q][1]), "=f"(v[q][2]),
                     "=f"(v[q][3])
                   : "r"(bs + tc::tile_off<true>(4 * jb + q, 8 * rc)));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) tc::split_tf32(v[q][j], h[q], l[q]);
      const uint32_t at = bs + tc::tile_off<true>(4 * jb + j, 8 * rc);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                   "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3]));
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       at + b_tile(J)),
                   "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3]));
    }
  }
}

// B's tile element by element (a stride-n view: the dgrad's z2 and z2bar),
// split into its hi and lo tiles: element x of the thread is (j, k) = (q /
// 32, q % 32), q = tid + 128 x, a warp on the 32 k of one row (its stores
// hit 32 banks).  load_b issues the loads of elements [x0, x0 + N),
// store_b splits and stores them (an iteration later where deferred)
template <int N, int R>
__device__ __forceinline__ void load_b(const uint32_t* p, long long s_j,
                                       long long s_k, int j0, int Jx, int k0,
                                       int k_end, int x0, uint32_t (&v)[R]) {
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int q = threadIdx.x + (x0 + x) * kThreads;
    const int gj = j0 + (q >> 5), gk = k0 + (q & 31);
    v[x] = gj < Jx && gk < k_end ? __ldg(p + gj * s_j + gk * s_k) : 0u;
  }
}
template <int J, int N, int R>
__device__ __forceinline__ void store_b(uint32_t bs, int x0,
                                        const uint32_t (&v)[R]) {
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int q = threadIdx.x + (x0 + x) * kThreads;
    const uint32_t off = tc::tile_off<true>(q >> 5, 2 * (q & 31));
    uint32_t h, l;
    tc::split_tf32(__uint_as_float(v[x]), h, l);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(bs + off), "r"(h));
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(bs + b_tile(J) +
                                                   off),
                 "r"(l));
  }
}

// D (64 x J, fp32) (+)= A (64 x 8, tf32 in registers) B (8 x J, tf32
// K-major in shared memory); scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n96k8_tf32_rs(
    float (&d)[48], const uint32_t (&a)[4], uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <int J>
__device__ __forceinline__ void wgmma_tf32(float (&d)[J / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d = 1) {
  if constexpr (J == 96)
    wgmma_m64n96k8_tf32_rs(d, a, db, scale_d);
  else
    tc::wgmma_m64n128k8_tf32_rs(d, a, db, scale_d);
}

// The body of the kernels below, on Cfg<J>.  The block takes `tiles` j
// tiles in turn through one pipeline of stages (tile u + 1's first stages
// load under tile u's last ones); O is D's type; TransB: B's copies run
// along j (kCopyT, the wgrad's), else along k (kCopy, the dgrad's)
template <typename O, bool Fuse, int J, int Defer, bool TransB>
__device__ __forceinline__ void run(const Args& a, const Flags& f,
                                    int tiles) {
  using C = Cfg<J>;
  static_assert(Defer != kDeferB || J == 96, "a deferred B spills at 128");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const int g = blockIdx.z % a.n;
  const int c = Fuse ? 0 : (blockIdx.z / a.n) % 2;
  const int s = blockIdx.z / ((Fuse ? 1 : 2) * a.n);
  const int first = blockIdx.x * tiles, m0 = blockIdx.y * kM;
  const int k_begin = s * a.krows, k_end = min(a.K, k_begin + a.krows);
  // stages of one component's k range (one of zeros where it is empty: D
  // is then written 0); with Fuse component 0's, then component 1's
  const int per = max(1, (k_end - k_begin + kK - 1) / kK);
  const int T = Fuse ? 2 * per : per;
  const int TT = T * min(tiles, (a.Jx + J - 1) / J - first);
  auto slot = [&](int t) { return base + (t % kDepth) * C::kStage; };
  // stage t's component, first k and first j
  auto comp = [&](int t) { return Fuse ? (t % T) / per : c; };
  auto k0_of = [&](int t) {
    return k_begin + (Fuse ? (t % T) % per : t % T) * kK;
  };
  auto j0_of = [&](int t) { return (first + t / T) * J; };
  auto ap = [&](int cc) {
    return static_cast<const uint32_t*>(a.A[cc]) + g * a.a_sg[cc];
  };
  auto bp = [&](int cc) {
    return static_cast<const uint32_t*>(a.B[cc]) + g * a.b_sg[cc];
  };

  // stage t's copies (one cp.async group, maybe empty)
  auto copies = [&](int t) {
    if (t < TT) {
      const int cc = comp(t), k0 = k0_of(t), j0 = j0_of(t);
      const uint32_t as = slot(t), bs = as + kATile;
      if (f.a[cc] == kCopy)
        copy_a(ap(cc), a.a_sk[cc], m0, a.Mx, k0, k_end, as);
      if (f.b[cc] != kGather) {
        if constexpr (TransB)
          copy_bt<J>(bp(cc), a.b_sk[cc], j0, a.Jx, k0, k_end, bs);
        else
          copy_bk<J>(bp(cc), a.b_sj[cc], j0, a.Jx, k0, k_end, bs);
      }
    }
    tc::cp_async_commit();
  };
  // the deferred gather of stage t (Defer): its loads into raw (load),
  // stored an iteration later (store); a gathered operand that is not
  // deferred is loaded and stored at once by store, 8 elements at a time
  constexpr int kRaw = Defer == kDeferA   ? kAGather
                       : Defer == kDeferB ? C::kBGather
                                          : 1;
  uint32_t raw[kRaw];
  auto load = [&](int t) {
    if (t < TT) {
      const int cc = comp(t);
      if constexpr (Defer == kDeferA)
        if (f.a[cc] == kGather)
          load_a<kAGather>(ap(cc), a.a_sk[cc], a.a_sm[cc], m0, a.Mx,
                           k0_of(t), k_end, 0, raw);
      if constexpr (Defer == kDeferB)
        if (f.b[cc] == kGather)
          load_b<C::kBGather>(bp(cc), a.b_sj[cc], a.b_sk[cc], j0_of(t),
                              a.Jx, k0_of(t), k_end, 0, raw);
    }
  };
  auto store = [&](int t) {
    if (t < TT) {
      const int cc = comp(t);
      const uint32_t as = slot(t), bs = as + kATile;
      if (f.a[cc] == kGather) {
        if constexpr (Defer == kDeferA) {
          store_a<kAGather>(as, 0, raw);
        } else {
          const int k0 = k0_of(t);
#pragma unroll 1
          for (int x0 = 0; x0 < kAGather; x0 += 8) {
            uint32_t v[8];
            load_a<8>(ap(cc), a.a_sk[cc], a.a_sm[cc], m0, a.Mx, k0, k_end,
                      x0, v);
            store_a<8>(as, x0, v);
          }
        }
      }
      if (f.b[cc] == kGather) {
        if constexpr (Defer == kDeferB) {
          store_b<J, C::kBGather>(bs, 0, raw);
        } else {
          const int k0 = k0_of(t), j0 = j0_of(t);
#pragma unroll 1
          for (int x0 = 0; x0 < C::kBGather; x0 += 8) {
            uint32_t v[8];
            load_b<8>(bp(cc), a.b_sj[cc], a.b_sk[cc], j0, a.Jx, k0, k_end,
                      x0, v);
            store_b<J, 8>(bs, x0, v);
          }
        }
      }
    }
  };
  // this thread's copied B chunks of stage t, once landed, split
  auto ready = [&](int t) {
    if (t < TT) {
      const uint32_t bs = slot(t) + kATile;
      if (f.b[comp(t)] != kGather) {
        if constexpr (TransB)
          split_bt<J>(bs);
        else
          split_bk<J>(bs);
      }
    }
  };

  float acc[J / 2], part[J / 2];
#pragma unroll
  for (int x = 0; x < J / 2; ++x) acc[x] = part[x] = 0.f;
  tc::fence_acc(part);
  // stage 0 gathered, landed and split, stage 1's gather loading
  copies(0);
  load(0);
  store(0);
  load(1);
  tc::cp_async_wait<0>();
  ready(0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cd = Fuse ? 0 : c;   // D's component
  const long long c_sm = a.c_sm[cd], c_sj = a.c_sj[cd];
  for (int t = 0, tt = 0; t < TT; ++t) {
    // stage t landed, split and stored by every thread
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // stage t + 1 into the slot of stage t - 1, whose products and
    // fragment loads every warp finished before the barrier above
    copies(t + 1);
    const uint32_t as = slot(t), bs = as + kATile;
    uint32_t ah[16], al[16];
    a_frags(as, ah, al);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kK / 8; ++ks) {
      const uint32_t h4[4] = {ah[4 * ks], ah[4 * ks + 1], ah[4 * ks + 2],
                              ah[4 * ks + 3]};
      const uint32_t l4[4] = {al[4 * ks], al[4 * ks + 1], al[4 * ks + 2],
                              al[4 * ks + 3]};
      const uint64_t bh = tc::desc_b<true>(bs, ks),
                     bl = tc::desc_b<true>(bs + C::kBTile, ks);
      wgmma_tf32<J>(part, l4, bh, ks > 0);
      wgmma_tf32<J>(part, h4, bl);
      wgmma_tf32<J>(part, h4, bh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // under the products: stage t + 1's gather stored (its loads flew
    // through the last iteration) and stage t + 2's loaded; stage t + 1's
    // copies landed and split
    store(t + 1);
    load(t + 2);
    tc::cp_async_wait<0>();
    ready(t + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    tc::fence_acc(part);
#pragma unroll
    for (int x = 0; x < J / 2; ++x) acc[x] += part[x];
    if (++tt < T) continue;   // tt: the tile's stages summed
    tt = 0;
    // tile t / T is summed: acc register 4 jj + 2 hh + e holds m = m0 +
    // 16 warp + lane / 4 + 8 hh, j = j0 + 8 jj + 2 (lane % 4) + e
    const int j0 = j0_of(t);
    O* D = static_cast<O*>(a.C[cd]) + g * a.c_sg[cd];
    float* P = a.part ? a.part + ((long long)(s * 2 + cd) * a.n + g) *
                                     a.part_sg
                      : nullptr;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 16 * warp + lane / 4 + 8 * hh;
      if (m >= a.Mx) continue;
#pragma unroll
      for (int jj = 0; jj < J / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * jj + 2 * (lane % 4) + e;
          if (j >= a.Jx) continue;
          const long long at = m * c_sm + j * c_sj;
          const float v = acc[4 * jj + 2 * hh + e];
          if (P)
            P[at] = v;
          else
            D[at] = from_f32<O>(v);
        }
    }
#pragma unroll
    for (int x = 0; x < J / 2; ++x) acc[x] = 0.f;
  }
  tc::cp_async_wait<0>();
}

// the dgrad (dyad_dgrad.cu, Fuse in dyad_dgrad_fused.cu): D = dx^T, fp32;
// a gathered B (the DT z2, the OT z2bar) deferred at J 96
template <bool Fuse, int J>
__global__ void __launch_bounds__(kThreads, 2)
    dyad_dgrad_tf32_kernel(Args a, Flags f, int tiles) {
  run<float, Fuse, J, J == 96 ? kDeferB : kDeferNone, false>(a, f, tiles);
}

// the wgrad (dyad_wgrad.cu): D = dw or dw^T in O, or fp32 partials; a
// gathered A (the stride-n operand, wgrad_orient) deferred
template <typename O, int J>
__global__ void __launch_bounds__(kThreads, 2)
    dyad_wgrad_tf32_kernel(Args a, Flags f) {
  run<O, false, J, kDeferA, true>(a, f, 1);
}

// each component's loads: A copied where contiguous along m on 16-byte
// aligned rows; B copied where contiguous along k (the dgrad's, K-major)
// or, trans_b, along j (the wgrad's, transposed); else gathered
inline Flags flags_of(const Args& a, bool trans_b) {
  Flags f;
  for (int c = 0; c < 2; ++c) {
    f.a[c] = tc::load_of(a.A[c], a.a_sm[c], a.a_sk[c], a.a_sg[c], a.n, 4) ==
                     tc::kCopy
                 ? kCopy
                 : kGather;
    const bool copy =
        trans_b
            ? tc::load_of(a.B[c], a.b_sj[c], a.b_sk[c], a.b_sg[c], a.n, 4) ==
                  tc::kCopy
            : tc::load_of(a.B[c], a.b_sk[c], a.b_sj[c], a.b_sg[c], a.n, 4) ==
                  tc::kCopy;
    f.b[c] = copy ? (trans_b ? kCopyT : kCopy) : kGather;
  }
  return f;
}

// the j tiles a dgrad block takes: enough for some 24 stages, at most four
// (a call whose d_out is short otherwise pays a whole pipeline's start and
// end for a few stages); stages counts both components' with Fuse
inline int tiles_of(int stages) {
  return stages >= 24 ? 1 : min(4, (24 + stages - 1) / stages);
}

template <bool Fuse, int J>
cudaError_t launch_dgrad(const Args& a, cudaStream_t stream) {
  if (a.split != 1 || a.part) return cudaErrorInvalidValue;
  if (a.n == 0 || a.Jx == 0 || a.Mx == 0) return cudaSuccess;
  auto kernel = dyad_dgrad_tf32_kernel<Fuse, J>;
  constexpr int smem = Cfg<J>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int per = max(1, (a.K + kK - 1) / kK);
  const int tiles = tiles_of(Fuse ? 2 * per : per);
  const int j_tiles = (a.Jx + J - 1) / J;
  dim3 grid((j_tiles + tiles - 1) / tiles, (a.Mx + kM - 1) / kM,
            (Fuse ? 1 : 2) * a.n);
  kernel<<<grid, kThreads, smem, stream>>>(a, flags_of(a, false), tiles);
  return cudaGetLastError();
}

// r: the reduce's view of D for split > 1 (gemm::dyad_gemm_reduce: C, its
// strides, R x N per (c, g), part, split)
template <typename O, int J>
cudaError_t launch_wgrad(const Args& a, const DyadGemmArgs& r,
                         cudaStream_t stream) {
  if (a.split < 1 || a.krows % kK || (a.split > 1 && !a.part))
    return cudaErrorInvalidValue;
  if (a.n == 0 || a.Jx == 0 || a.Mx == 0) return cudaSuccess;
  auto kernel = dyad_wgrad_tf32_kernel<O, J>;
  constexpr int smem = Cfg<J>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Jx + J - 1) / J, (a.Mx + kM - 1) / kM, 2 * a.n * a.split);
  kernel<<<grid, kThreads, smem, stream>>>(a, flags_of(a, true));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return err;
  const long long total = 2LL * r.n * r.R * r.N;
  constexpr int kReduceThreads = 256;
  gemm::dyad_gemm_reduce<O><<<(unsigned)((total + kReduceThreads - 1) /
                                         kReduceThreads),
                              kReduceThreads, 0, stream>>>(r);
  return cudaGetLastError();
}

}  // namespace tf32t
}  // namespace repro
