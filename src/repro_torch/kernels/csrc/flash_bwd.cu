// flash_prefill_grads: the flash-attention backward over the layer layouts
//
//   q, do (B, S, K, G, h), k and v (B, T, K, h), lse and delta (B, K, S*G)
//   ->  dq (B, S, K, G, h), dk and dv (B, T, K, h)
//
// with p = exp(q.k * scale - lse) recomputed per tile from the forward's
// saved log-sum-exp (row r = s*G + g), delta = rowsum(do * o) (computed by
// the wrapper, as the reference computes it outside its kernels),
// ds = p * (do.v - delta) * scale, and
//   dq = ds . k;   dk = ds^T . q;   dv = p^T . do,
// dk and dv summing over the G query heads that share a KV head.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py:
// flash_prefill_grads (_dq_kernel in _dq_impl, _dkv_kernel in _dkv_impl).
// Same masking contract as flash_prefill: query s sits at q_off[b] + s, key
// t at k_off[b] + t; a pair is valid when t < T, (causal) k_pos <= q_pos and
// (window) q_pos - k_pos < window; p is zeroed explicitly where the pair is
// not valid, so a fully-masked row (lse about -1e30) gives zero gradients.
//
// Two routes, each two kernels launched one after the other on the
// caller's stream (dk/dv, then dq):
//  - bf16, any h <= 128: the tensor-core kernels of flash_bwd_tc.cuh
//    (wgmma, P and dS fed back from the accumulator registers); see the
//    note there.
//  - fp32: the kernels below, each a chain of small GEMMs through shared
//    memory with 4 x 4 (or 4 x h/16) fp32 FMA register tiles per thread,
//    256 threads per block:
//    - dk, dv: one block per (b, kv head, 64-key tile) keeps k and v (and
//      its dk, dv accumulators) and walks the 64-row tiles of q and do in
//      the causal/window band of its keys (the reference's _q_index_map):
//      S = q k^T and dP = do v^T, then p and ds, then dv += p^T do and
//      dk += ds^T q.
//    - dq: one block per (b, kv head, 64-row tile) keeps q and do and walks
//      the key tiles in the band of its rows (the reference's
//      _kv_index_map): S and dP again, then dq += ds k.
//    Operands are staged row-major or transposed so that every inner loop
//    reads float4s; q, k, v and do are read through their strides (head
//    dim contiguous): no GQA fold, transpose or padded copy in device
//    memory.
//
// Bound on the H100: at the OPT-125m training shape (B 8, S = T = 512,
// K 12, h 64, causal, fp32) the backward does about 8 GFLOP on a few tens
// of MB, so fp32 operations bound it; the FMA route recomputes S and dP in
// both kernels.  At Qwen3-0.6B's (bf16, K 8 x G 2, h 128) bytes bound it:
// about 101 MB, 0.030 ms.
//
// ptxas (sm_90a, -O3) on the tensor-core kernels, no spills: dk/dv 242
// registers at HD 128 (dK and dV 128 of them, S^T and dP^T 64), 182 at HD
// 64; dq 190 and 146 (chip_smoke.py phase 2 prints them).
#include "flash_bwd_tc.cuh"

namespace repro {
namespace {

constexpr int kTile = 64;              // rows (query rows or keys) per tile
constexpr int kThreads = 256;          // 16 x 16 threads, 4 rows each
constexpr int kPT = kTile + 4;         // pitch of a transposed [h][64] tile

__device__ __forceinline__ bool pair_valid(const BwdArgs& a, int rg, int tk,
                                           int qo, int ko) {
  if (rg >= a.S * a.G || tk >= a.T) return false;
  const int qpos = qo + rg / a.G, kpos = ko + tk;
  if (a.causal && kpos > qpos) return false;
  if (a.window >= 0 && qpos - kpos >= a.window) return false;
  return true;
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      v[i] = x.x; v[i + 1] = x.y;
    }
  }
}

// rows r0 .. r0+63 (r = s*G + g) of a (B, S, K, G, h) tensor into a
// row-major [64][HD + 4] tile, zero past S*G or h; loads issue before
// stores
template <int HD>
__device__ __forceinline__ void stage_rows(const float* src, long long sb,
                                           long long ss, long long sk,
                                           long long sg, const BwdArgs& a,
                                           int b, int kh, int r0,
                                           float* dst) {
  constexpr int kPer = kTile * HD / kThreads;
  const int SG = a.S * a.G;
  float val[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / HD, d = e % HD, rg = r0 + r;
    val[i] = 0.f;
    if (rg < SG && d < a.h) {
      const int s = rg / a.G, g = rg % a.G;
      val[i] = src[b * sb + s * ss + kh * sk + g * sg + d];
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    dst[(e / HD) * (HD + 4) + e % HD] = val[i];
  }
}

// keys t0 .. t0+63 of a (B, T, K, h) tensor, transposed into [HD][64 + 4]
// and, when `rows` is set, also row-major into [64][HD + 4]
template <int HD>
__device__ __forceinline__ void stage_keys(const float* src, long long sb,
                                           long long st, long long sk,
                                           const BwdArgs& a, int b, int kh,
                                           int t0, float* tr, float* rows) {
  constexpr int kPer = kTile * HD / kThreads;
  float val[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int t = e / HD, d = e % HD, tk = t0 + t;
    val[i] = (tk < a.T && d < a.h)
                 ? src[b * sb + tk * st + kh * sk + d]
                 : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    tr[(e % HD) * kPT + e / HD] = val[i];
    if (rows) rows[(e / HD) * (HD + 4) + e % HD] = val[i];
  }
}

// S = Q K^T and dP = dO V^T for the thread's 4 rows (ty) x 4 keys (tx),
// from row-major Q, dO tiles and transposed K, V tiles
template <int HD>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* kt, const float* vt,
                                       int ty, int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d0 = 0; d0 < HD; d0 += 4) {
    float qa[4][4], oa[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lds(qs + (ty * 4 + i) * (HD + 4) + d0, qa[i]);
      lds(dos + (ty * 4 + i) * (HD + 4) + d0, oa[i]);
    }
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float kb[4], vb[4];
      lds(kt + (d0 + dd) * kPT + tx * 4, kb);
      lds(vt + (d0 + dd) * kPT + tx * 4, vb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i][dd], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i][dd], vb[j], dp[i][j]);
        }
    }
  }
}

// s, dp -> p, ds in place (p explicitly zero off the mask)
__device__ __forceinline__ void probs(const BwdArgs& a, int r0, int t0,
                                      int ty, int tx, int qo, int ko,
                                      const float* lses, const float* deltas,
                                      float (&s)[4][4], float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float lse = lses[r], delta = deltas[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = pair_valid(a, r0 + r, t0 + tx * 4 + j, qo, ko);
      const float p = valid ? expf(s[i][j] * a.scale - lse) : 0.f;
      dp[i][j] = p * (dp[i][j] - delta) * a.scale;
      s[i][j] = p;
    }
  }
}

__device__ __forceinline__ void stage_row_stats(const BwdArgs& a, int b,
                                                int kh, int r0, float* lses,
                                                float* deltas) {
  if (threadIdx.x < kTile) {
    const int SG = a.S * a.G;
    const int rg = r0 + threadIdx.x;
    const long long base = ((long long)b * a.K + kh) * SG;
    lses[threadIdx.x] = rg < SG ? a.lse[base + rg] : 0.f;
    deltas[threadIdx.x] = rg < SG ? a.delta[base + rg] : 0.f;
  }
}

template <int HD>
constexpr int dkv_floats() {
  // kt, vt [HD][68]; qs, dos [64][HD+4]; ps, dss [64][68]; lse, delta
  return 2 * HD * kPT + 2 * kTile * (HD + 4) + 2 * kTile * kPT + 2 * kTile;
}

template <int HD>
constexpr int dq_floats() {
  // qs, dos [64][HD+4]; kt, vt [HD][68]; ks [64][HD+4]; dst [64][68];
  // lse, delta
  return 3 * kTile * (HD + 4) + 2 * HD * kPT + kTile * kPT + 2 * kTile;
}

// two blocks per SM where their shared memory fits (HD <= 64)
template <int HD>
constexpr int min_blocks() { return HD <= 64 ? 2 : 1; }

template <int HD>
__global__ void __launch_bounds__(kThreads, min_blocks<HD>())
flash_dkv_kernel(BwdArgs a) {
  constexpr int DT = HD / 16;   // head dims per thread in dk, dv
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                          // [HD][kPT]
  float* vt = kt + HD * kPT;                 // [HD][kPT]
  float* qs = vt + HD * kPT;                 // [64][HD + 4]
  float* dos = qs + kTile * (HD + 4);        // [64][HD + 4]
  float* ps = dos + kTile * (HD + 4);        // [64 rows][kPT]
  float* dss = ps + kTile * kPT;             // [64 rows][kPT]
  float* lses = dss + kTile * kPT;           // [64]
  float* deltas = lses + kTile;              // [64]

  const int b = blockIdx.z, kh = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qo = a.q_off_vec ? a.q_off_vec[b] : a.q_off;
  const int ko = a.k_off_vec ? a.k_off_vec[b] : a.k_off;

  stage_keys<HD>(static_cast<const float*>(a.k), a.k_sb, a.k_st, a.k_sk, a, b,
                 kh, t0, kt, nullptr);
  stage_keys<HD>(static_cast<const float*>(a.v), a.v_sb, a.v_st, a.v_sk, a, b,
                 kh, t0, vt, nullptr);

  // the thread's dk, dv: keys ty*4 + i, head dims tx*DT + j
  float dk[4][DT], dv[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) dk[i][j] = dv[i][j] = 0.f;

  // row range inside the (causal, window) band of this key tile
  const int kpos_lo = ko + t0;
  const int kpos_hi = ko + min(t0 + kTile, a.T) - 1;
  int s_lo = 0, s_hi = a.S;
  if (a.causal) s_lo = max(0, kpos_lo - qo);
  if (a.window >= 0) s_hi = max(0, min(a.S, kpos_hi + a.window - qo));
  const int row_lo = s_lo * a.G, row_hi = s_hi * a.G;

  for (int r0 = (row_lo / kTile) * kTile; r0 < row_hi; r0 += kTile) {
    __syncthreads();   // the previous row tile is consumed
    stage_rows<HD>(static_cast<const float*>(a.q), a.q_sb, a.q_ss, a.q_sk,
                   a.q_sg, a, b, kh, r0, qs);
    stage_rows<HD>(static_cast<const float*>(a.dout), a.do_sb, a.do_ss,
                   a.do_sk, a.do_sg, a, b, kh, r0, dos);
    stage_row_stats(a, b, kh, r0, lses, deltas);
    __syncthreads();

    // rows ty*4 + i, keys tx*4 + j
    float p[4][4], ds[4][4];
    scores<HD>(qs, dos, kt, vt, ty, tx, p, ds);
    probs(a, r0, t0, ty, tx, qo, ko, lses, deltas, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(ps + (ty * 4 + i) * kPT + tx * 4) =
          make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
      *reinterpret_cast<float4*>(dss + (ty * 4 + i) * kPT + tx * 4) =
          make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T q over the tile's rows
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pa[4], sa[4], ob[DT], qb[DT];
      lds(ps + r * kPT + ty * 4, pa);
      lds(dss + r * kPT + ty * 4, sa);
      lds(dos + r * (HD + 4) + tx * DT, ob);
      lds(qs + r * (HD + 4) + tx * DT, qb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
          dk[i][j] = fmaf(sa[i], qb[j], dk[i][j]);
        }
    }
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tk = t0 + ty * 4 + i;
    if (tk >= a.T) continue;
    const long long ob = (((long long)b * a.T + tk) * a.K + kh) * a.h;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = tx * DT + j;
      if (d < a.h) {
        dkp[ob + d] = dk[i][j];
        dvp[ob + d] = dv[i][j];
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, min_blocks<HD>())
flash_dq_kernel(BwdArgs a) {
  constexpr int DT = HD / 16;   // head dims per thread in dq
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [64][HD + 4]
  float* dos = qs + kTile * (HD + 4);        // [64][HD + 4]
  float* kt = dos + kTile * (HD + 4);        // [HD][kPT]
  float* vt = kt + HD * kPT;                 // [HD][kPT]
  float* ks = vt + HD * kPT;                 // [64 keys][HD + 4]
  float* dst = ks + kTile * (HD + 4);        // [64 keys][kPT]: ds^T
  float* lses = dst + kTile * kPT;           // [64]
  float* deltas = lses + kTile;              // [64]

  const int b = blockIdx.z, kh = blockIdx.y;
  const int r0 = blockIdx.x * kTile;
  const int SG = a.S * a.G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qo = a.q_off_vec ? a.q_off_vec[b] : a.q_off;
  const int ko = a.k_off_vec ? a.k_off_vec[b] : a.k_off;

  stage_rows<HD>(static_cast<const float*>(a.q), a.q_sb, a.q_ss, a.q_sk,
                 a.q_sg, a, b, kh, r0, qs);
  stage_rows<HD>(static_cast<const float*>(a.dout), a.do_sb, a.do_ss,
                 a.do_sk, a.do_sg, a, b, kh, r0, dos);
  stage_row_stats(a, b, kh, r0, lses, deltas);

  // the thread's dq: rows ty*4 + i, head dims tx*DT + j
  float dq[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) dq[i][j] = 0.f;

  // key-tile range inside the (causal, window) band of this row tile
  const int q_lo = qo + r0 / a.G;
  const int q_hi = qo + (min(r0 + kTile, SG) - 1) / a.G;
  const int n_tiles = (a.T + kTile - 1) / kTile;
  int t_end = n_tiles;
  if (a.causal) {
    const int last = q_hi - ko;
    t_end = last < 0 ? 0 : min(n_tiles, last / kTile + 1);
  }
  int t_begin = 0;
  if (a.window >= 0) {
    const int first = q_lo - a.window + 1 - ko;
    t_begin = first <= 0 ? 0 : first / kTile;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int t0 = t * kTile;
    __syncthreads();   // the previous key tile is consumed
    stage_keys<HD>(static_cast<const float*>(a.k), a.k_sb, a.k_st, a.k_sk,
                   a, b, kh, t0, kt, ks);
    stage_keys<HD>(static_cast<const float*>(a.v), a.v_sb, a.v_st, a.v_sk,
                   a, b, kh, t0, vt, nullptr);
    __syncthreads();

    float p[4][4], ds[4][4];
    scores<HD>(qs, dos, kt, vt, ty, tx, p, ds);
    probs(a, r0, t0, ty, tx, qo, ko, lses, deltas, p, ds);
    // ds^T: key tx*4 + j, rows ty*4 .. ty*4 + 3
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + (tx * 4 + j) * kPT + ty * 4) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();

    // dq += ds k over the tile's keys
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float sa[4], kb[DT];
      lds(dst + c * kPT + ty * 4, sa);
      lds(ks + c * (HD + 4) + tx * DT, kb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) dq[i][j] = fmaf(sa[i], kb[j], dq[i][j]);
    }
  }

  float* dqp = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rg = r0 + ty * 4 + i;
    if (rg >= SG) continue;
    const int s = rg / a.G, g = rg % a.G;
    const long long ob =
        ((((long long)b * a.S + s) * a.K + kh) * a.G + g) * a.h;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = tx * DT + j;
      if (d < a.h) dqp[ob + d] = dq[i][j];
    }
  }
}

template <int HD>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t dkv_bytes = sizeof(float) * dkv_floats<HD>();
  const size_t dq_bytes = sizeof(float) * dq_floats<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dkv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_bytes);
  if (err != cudaSuccess) return err;
  dim3 dkv_grid((a.T + kTile - 1) / kTile, a.K, a.B);
  flash_dkv_kernel<HD><<<dkv_grid, kThreads, dkv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 dq_grid((a.S * a.G + kTile - 1) / kTile, a.K, a.B);
  flash_dq_kernel<HD><<<dq_grid, kThreads, dq_bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_hd(const BwdArgs& a, cudaStream_t stream) {
  if (a.h <= 32) return launch<32>(a, stream);
  if (a.h <= 64) return launch<64>(a, stream);
  if (a.h <= 128) return launch<128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_prefill_grads(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    const int* q_off_vec, int q_off, const int* k_off_vec, int k_off, int B,
    int S, int T, int K, int G, int h, long long q_sb, long long q_ss,
    long long q_sk, long long q_sg, long long do_sb, long long do_ss,
    long long do_sk, long long do_sg, long long k_sb, long long k_st,
    long long k_sk, long long v_sb, long long v_st, long long v_sk,
    int causal, int window, float scale, int dtype, void* stream) {
  if (B == 0 || K == 0 || S == 0 || T == 0) return cudaSuccess;
  repro::BwdArgs a{q,     k,     v,     dout,  lse,   delta, dq,    dk,
                   dv,    q_off_vec, k_off_vec, q_off, k_off, B, S, T,
                   K,     G,     h,     q_sb,  q_ss,  q_sk,  q_sg,  do_sb,
                   do_ss, do_sk, do_sg, k_sb,  k_st,  k_sk,  v_sb,  v_st,
                   v_sk,  causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::launch_hd(a, s);
    case repro::kBF16:   // the tensor cores, any h <= 128
      if (h <= 64) return repro::fbwd::launch<64>(a, s);
      if (h <= 128) return repro::fbwd::launch<128>(a, s);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}
