"""Flash-attention kernels (CUDA): prefill, its backward, ring-cache decode.

* :func:`flash_prefill` (``csrc/flash_prefill.cu``) ports the TPU kernel
  ``repro.kernels.flash_attn.flash_prefill``: online-softmax attention of
  q ``(B, S, K, G, h)`` over k, v ``(B, T, K, h)`` with query ``s`` at
  ``q_off + s`` and key ``t`` at ``k_off + t`` (scalars or ``(B,)``
  vectors), causal and/or windowed, optionally returning the fp32
  log-sum-exp ``(B, K, S*G)``; both dtypes on the tensor cores
  (``csrc/flash_fwd_tc.cuh``): bf16 products, and fp32 in split TF32
  (three tf32 products a pair, each good to about 2^-21 relative, fp32
  sums).
* :func:`flash_prefill_grads` (``csrc/flash_bwd.cu``) ports
  ``repro.kernels.flash_attn.flash_prefill_grads``: dq, dk and dv from
  q, k, v, the output, its lse and the output cotangent, with the
  probabilities recomputed from lse; both dtypes on the tensor cores
  (``csrc/flash_bwd_tc.cuh``) at any head dim up to 128: bf16 products,
  and fp32 in split TF32 (the products that sum over a tile's rows or
  keys run transposed, since tf32 ``wgmma`` reads its shared operands
  K-major only).
* :func:`flash_decode` (``csrc/flash_decode.cu``) ports
  ``repro.kernels.flash_attn.flash_decode``: one query token against the
  ``(B, L, K, h)`` ring cache, slot ``j`` holding position
  ``idx - ((idx - j) mod L)``; split over blocks of :data:`RING_SPAN`
  ring slots and merged in the launch, as the paged decode is (the two
  share ``csrc/flash_decode_split.cuh``).
* :func:`flash_decode_paged` (``csrc/flash_decode_paged.cu``) ports
  ``repro.kernels.flash_attn.flash_decode_paged``: one query token against
  ``(NP, P, K, h)`` page pools, slot b's position ``j`` in page
  ``block_table[b, j // P]`` at row ``j % P``.  Its int8-pool variant,
  :func:`flash_decode_paged_int8` (the same source, ported from
  ``_decode_paged_kernel_q``), reads int8 pools with per-row fp32 scales;
  ``flash_decode_paged`` routes there when it is given the scales.  Both
  split each slot's keys over blocks of :data:`PAGED_SPAN` keys and merge
  the partial softmax states in the same launch, in a fixed order, so a
  row's bits do not depend on the rest of the batch.

The decode kernels take q and the cache in their own dtypes (fp32 or bf16
each) and convert both as they are used, so no cast runs around them.

All keep the TPU kernels' masking contract: masked scores are -1e30,
masked probabilities are zeroed, the denominator is ``max(l, 1e-30)``, so
a fully-masked row gives 0.  Each wrapper takes its plain version only for
a CPU tensor; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_TINY = 1e-30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_MAX_GQA_DECODE = 8


def _offsets(off, B: int, device) -> torch.Tensor:
    """A scalar or (B,) offset as a (B,) int64 vector."""
    return torch.as_tensor(off, device=device).to(torch.int64).reshape(
        -1).expand(B)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation dtype: fp32, or fp64 for fp64
    inputs (``torch.autograd.gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def _softmax_av(s, mask, v_dtype, v, eq: str):
    """Masked softmax of fp32 scores and the P.V product, with the
    kernels' zeroing and denominator guard.  Returns (out, m, l) in the
    scores' dtype."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum(eq, e.to(v_dtype).to(s.dtype), v.to(s.dtype))
    return o, m, l


def _positions_mask(q_off, k_off, B: int, S: int, T: int, causal: bool,
                    window, device):
    """(B, S, T) validity of each (query, key) pair from the offsets."""
    qpos = _offsets(q_off, B, device)[:, None] + torch.arange(S, device=device)
    kpos = _offsets(k_off, B, device)[:, None] + torch.arange(T, device=device)
    mask = torch.ones(B, S, T, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[:, None, :] <= qpos[:, :, None]
    if window is not None:
        mask &= qpos[:, :, None] - kpos[:, None, :] < window
    return mask


def flash_prefill_plain(q, k, v, q_off=0, k_off=0, *, causal: bool = True,
                        window: Optional[int] = None, save_lse: bool = False):
    """The prefill kernel's function in plain torch (fp32 scores)."""
    B, S, K, G, h = q.shape
    T = k.shape[1]
    mask = _positions_mask(q_off, k_off, B, S, T, causal, window,
                           q.device)[:, :, None, None, :]  # (B,S,1,1,T)
    ct = torch.promote_types(q.dtype, k.dtype)
    f = _acc(ct)
    s = torch.einsum("bskgh,btkh->bskgt", q.to(ct).to(f),
                     k.to(ct).to(f)) * (1.0 / math.sqrt(h))
    o, m, l = _softmax_av(s, mask, v.dtype, v, "bskgt,btkh->bskgh")
    l = l.clamp_min(_TINY)
    out = (o / l).to(q.dtype)
    if not save_lse:
        return out, None
    lse = (m + torch.log(l))[..., 0]                        # (B,S,K,G)
    return out, lse.permute(0, 2, 1, 3).reshape(B, K, S * G)


def _delta(o, do):
    """rowsum(do * o) in fp32, in the lse layout (B, K, S*G)."""
    B, S, K, G, _ = o.shape
    f = _acc(o.dtype)
    d = (do.to(f) * o.to(f)).sum(dim=-1)                     # (B,S,K,G)
    return d.permute(0, 2, 1, 3).reshape(B, K, S * G)


def flash_prefill_grads_plain(q, k, v, o, lse, do, q_off=0, k_off=0, *,
                              causal: bool = True,
                              window: Optional[int] = None):
    """The backward kernels' function in plain torch: the recomputed
    probability dataflow (``p = exp(s - lse)`` zeroed off the mask, fp32
    sums) as direct contractions; the port of the reference's direct
    lowering ``kernels.ops._flash_bwd_direct``.  Returns (dq, dk, dv) in
    the dtypes of q, k and v."""
    f = _acc(q.dtype)
    B, S, K, G, h = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(h)
    qf, kf, vf, dof = q.to(f), k.to(f), v.to(f), do.to(f)
    s = torch.einsum("bskgh,btkh->bskgt", qf, kf) * scale
    mask = _positions_mask(q_off, k_off, B, S, T, causal, window,
                           q.device)[:, :, None, None, :]
    lse = lse.reshape(B, K, S, G).permute(0, 2, 1, 3)       # (B,S,K,G)
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros((), dtype=f, device=q.device))
    delta = _delta(o, do).reshape(B, K, S, G).permute(0, 2, 1, 3)
    dv = torch.einsum("bskgt,bskgh->btkh", p, dof)
    dp = torch.einsum("bskgh,btkh->bskgt", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bskgt,btkh->bskgh", ds, kf)
    dk = torch.einsum("bskgt,bskgh->btkh", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_prefill_grads(q, k, v, o, lse, do, q_off=0, k_off=0, *,
                        causal: bool = True, window: Optional[int] = None):
    """Flash attention backward.  q, o, do: (B, S, K, G, h); k, v:
    (B, T, K, h); lse: the forward's (B, K, S*G) fp32 log-sum-exp.  Returns
    (dq, dk, dv) at those layouts, dk and dv summed over the G query heads
    of each KV head.  One call launches the dq and the dk/dv kernels."""
    if q.device.type == "cpu":
        return flash_prefill_grads_plain(q, k, v, o, lse, do, q_off, k_off,
                                         causal=causal, window=window)
    _check_cuda("flash_prefill_grads", q, k, v)
    B, S, K, G, h = q.shape
    T = k.shape[1]
    if (k.shape != (B, T, K, h) or v.shape != k.shape
            or do.shape != q.shape or o.shape != q.shape
            or lse.shape != (B, K, S * G)):
        raise ValueError(f"flash_prefill_grads: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, do "
                         f"{tuple(do.shape)}, o {tuple(o.shape)}, lse "
                         f"{tuple(lse.shape)}")
    if do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError("flash_prefill_grads: do must have q's dtype and a "
                         "contiguous head dim")
    if lse.dtype != torch.float32:
        raise TypeError("flash_prefill_grads: lse must be fp32")
    lse = lse.contiguous()
    if S == 0 or T == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    # every element is written by the kernels
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    delta = _delta(o, do).contiguous()
    qo_vec, qo = _int_arg(q_off, B, q.device)
    ko_vec, ko = _int_arg(k_off, B, q.device)
    err = build.entry("flash_bwd")(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(do),
        build.ptr(lse), build.ptr(delta), build.ptr(dq), build.ptr(dk),
        build.ptr(dv), build.ptr(qo_vec), qo, build.ptr(ko_vec), ko,
        B, S, T, K, G, h, *q.stride()[:4], *do.stride()[:4],
        *k.stride()[:3], *v.stride()[:3], int(causal),
        -1 if window is None else int(window), 1.0 / math.sqrt(h),
        _DTYPES[q.dtype], build.stream(q.device))
    build.check(err, "flash_prefill_grads")
    flash_prefill_grads.launches += 1
    return dq, dk, dv


flash_prefill_grads.launches = 0


def _int_arg(off, B: int, device):
    """(vector tensor or None, scalar) for an offset/index kernel argument."""
    if isinstance(off, int):
        return None, off
    vec = torch.as_tensor(off, device=device).to(torch.int32).reshape(-1)
    return vec.expand(B).contiguous(), 0


def _promoted(q, k, v):
    """q, k, v in their promoted dtype.  The cache may hold another dtype
    than the queries (an fp32 cache under bf16 compute); the TPU kernels
    promote each tile (``jnp.promote_types``), and casting the narrower
    operands up before the launch (in practice the queries) computes the
    same product.  The caller casts the output back to q's dtype."""
    ct = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    return q.to(ct), k.to(ct), v.to(ct)


def _check_cuda(name: str, q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "want one of fp32, bf16 for q, k and v alike")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")
    if q.shape[-1] > _MAX_HEAD_DIM:
        raise NotImplementedError(
            f"{name}: head dim {q.shape[-1]} > {_MAX_HEAD_DIM}")


def flash_prefill(q, k, v, q_off=0, k_off=0, *, causal: bool = True,
                  window: Optional[int] = None, save_lse: bool = False):
    """Flash attention forward.  Returns ``(out (B,S,K,G,h), lse)`` with
    ``lse`` the (B, K, S*G) fp32 log-sum-exp when ``save_lse``, else None."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_off, k_off, causal=causal,
                                   window=window, save_lse=save_lse)
    q_dtype = q.dtype
    q, k, v = _promoted(q, k, v)
    _check_cuda("flash_prefill", q, k, v)
    B, S, K, G, h = q.shape
    T = k.shape[1]
    if k.shape != (B, T, K, h) or v.shape != k.shape:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    qo_vec, qo = _int_arg(q_off, B, q.device)
    ko_vec, ko = _int_arg(k_off, B, q.device)
    out = torch.empty(B, S, K, G, h, dtype=q.dtype, device=q.device)
    lse = (torch.empty(B, K, S * G, dtype=torch.float32, device=q.device)
           if save_lse else None)
    err = build.entry("flash_prefill")(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        build.ptr(lse), build.ptr(qo_vec), qo, build.ptr(ko_vec), ko,
        B, S, T, K, G, h, *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
        int(causal), -1 if window is None else int(window),
        1.0 / math.sqrt(h), _DTYPES[q.dtype], build.stream(q.device))
    build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out.to(q_dtype), lse


flash_prefill.launches = 0


def flash_decode_plain(q, k, v, idx, *, window: Optional[int] = None):
    """The decode kernel's function in plain torch (fp32 scores)."""
    squeeze = q.dim() == 5
    if squeeze:
        q = q[:, 0]
    B, K, G, h = q.shape
    L = k.shape[1]
    dev = q.device
    iv = _offsets(idx, B, dev)[:, None]                     # (B, 1)
    j = torch.arange(L, device=dev)[None, :]
    pos = iv - torch.remainder(iv - j, L)                   # (B, L)
    mask = pos >= 0
    if window is not None:
        mask &= iv - pos < window
    mask = mask[:, None, None, :]                           # (B,1,1,L)
    ct = torch.promote_types(q.dtype, k.dtype)
    f = _acc(ct)
    s = torch.einsum("bkgh,btkh->bkgt", q.to(ct).to(f),
                     k.to(ct).to(f)) * (1.0 / math.sqrt(h))
    o, _, l = _softmax_av(s, mask, v.dtype, v, "bkgt,btkh->bkgh")
    out = (o / l.clamp_min(_TINY)).to(q.dtype)
    return out[:, None] if squeeze else out


def _check_ring(q4, k, v):
    B, K, G, h = q4.shape
    L = k.shape[1]
    if k.device != q4.device or v.device != q4.device:
        raise ValueError(f"flash_decode: tensors on {k.device}/{v.device} "
                         f"and {q4.device}")
    if q4.dtype not in _DTYPES or k.dtype not in _DTYPES \
            or v.dtype != k.dtype:
        raise TypeError(f"flash_decode: q {q4.dtype}, cache {k.dtype}/"
                        f"{v.dtype}: want fp32 or bf16 q over an fp32 or "
                        "bf16 cache")
    if k.shape != (B, L, K, h) or v.shape != k.shape or L < 1:
        raise ValueError(f"flash_decode: q {tuple(q4.shape)} vs cache "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if q4.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_decode: the head dim must be contiguous")
    if h > _MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash_decode: head dim {h} > {_MAX_HEAD_DIM}")
    if G > _MAX_GQA_DECODE:
        raise NotImplementedError(
            f"flash_decode: {G} query heads per KV head > {_MAX_GQA_DECODE}")


def flash_decode(q, k, v, idx, *, window: Optional[int] = None):
    """One-token decode over the ring cache.  q: (B, 1, K, G, h) or
    (B, K, G, h); k, v: the (B, L, K, h) post-write cache; ``idx``: the
    current token's write index (int, or a (B,) tensor).  Returns o in
    q's rank and dtype.  q and the cache may differ in dtype (fp32 or bf16
    each); the cache is read in place through its strides, never cast.  On
    the card one launch splits each slot's ring over blocks of
    :data:`RING_SPAN` slots, and the last block of a slot merges its
    partials in split order, so a row's bits depend on its own inputs
    alone."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, idx, window=window)
    squeeze = q.dim() == 5
    q4 = q[:, 0] if squeeze else q
    _check_ring(q4, k, v)
    B, K, G, h = q4.shape
    L = k.shape[1]
    splits = paged_splits(1, L, None, RING_SPAN)
    idx_vec, idx_s = _int_arg(idx, B, q.device)
    out = torch.empty(B, K, G, h, dtype=q4.dtype, device=q.device)
    # every partial a merge reads is written in the same launch; the C entry
    # refuses a grid whose splits do not fit
    ws = (torch.empty(B * K * splits * G * (h + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    # rows of h 64 and 128 go by bulk copies where every row starts on 16
    # bytes, else element by element
    rows16 = all(t.data_ptr() % 16 == 0
                 and all(st * t.element_size() % 16 == 0
                         for st in t.stride()[:3]) for t in (k, v))
    err = build.entry("flash_decode")(
        build.ptr(q4), build.ptr(k), build.ptr(v), build.ptr(out),
        build.ptr(idx_vec), idx_s, build.ptr(ws),
        build.ptr(_counters(q.device, B * K)), B, L, K, G, h, RING_SPAN,
        0 if ws is None else ws.numel(), *q4.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], -1 if window is None else int(window),
        1.0 / math.sqrt(h), _DTYPES[q4.dtype], _DTYPES[k.dtype], int(rows16),
        build.stream(q.device))
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out[:, None] if squeeze else out


flash_decode.launches = 0


def _check_paged(q, pages_k, pages_v, block_table, idx, scales_k, scales_v):
    if (scales_k is None) != (scales_v is None):
        raise ValueError("scales_k and scales_v must be passed together")
    B = q.shape[0]
    NP, P, K, h = pages_k.shape
    if (q.shape[1:] != (K, q.shape[2], h) or pages_v.shape != pages_k.shape
            or block_table.dim() != 2 or block_table.shape[0] != B):
        raise ValueError(f"flash_decode_paged: q {tuple(q.shape)}, pools "
                         f"{tuple(pages_k.shape)} / {tuple(pages_v.shape)}, "
                         f"block table {tuple(block_table.shape)}")
    if scales_k is not None and (scales_k.shape != (NP, P, K)
                                 or scales_v.shape != (NP, P, K)):
        raise ValueError(f"flash_decode_paged: scales {tuple(scales_k.shape)}"
                         f" / {tuple(scales_v.shape)}, want {(NP, P, K)}")


def flash_decode_paged_plain(q, pages_k, pages_v, block_table, idx, *,
                             l_real: Optional[int] = None,
                             window: Optional[int] = None, scales_k=None,
                             scales_v=None):
    """The paged decode kernel's function in plain torch: gather each
    slot's pages into a dense ``(B, NB * P, K, h)`` view, then the masked
    softmax with fp32 scores.  int8 pools: the gathered payload and scales,
    each score column scaled by its key's K scale and each probability by
    its V scale, as the kernel does."""
    squeeze = q.dim() == 5
    if squeeze:
        q = q[:, 0]
    _check_paged(q, pages_k, pages_v, block_table, idx, scales_k, scales_v)
    B, K, G, h = q.shape
    P, NB = pages_k.shape[1], block_table.shape[1]
    cap = NB * P
    dev = q.device
    bt = block_table.to(torch.int64)
    kd = pages_k[bt].reshape(B, cap, K, h)
    vd = pages_v[bt].reshape(B, cap, K, h)
    iv = _offsets(idx, B, dev)[:, None]
    j = torch.arange(cap, device=dev)[None, :]
    mask = (j <= iv) & (j < (cap if l_real is None else l_real))
    if window is not None:
        mask &= iv - j < window
    mask = mask[:, None, None, :]                           # (B,1,1,cap)
    scale = 1.0 / math.sqrt(h)
    if scales_k is None:
        ct = torch.promote_types(q.dtype, pages_k.dtype)
        f = _acc(ct)
        s = torch.einsum("bkgh,btkh->bkgt", q.to(ct).to(f),
                         kd.to(ct).to(f)) * scale
        o, _, l = _softmax_av(s, mask, pages_v.dtype, vd, "bkgt,btkh->bkgh")
    else:
        f = _acc(q.dtype)
        sk = scales_k[bt].reshape(B, cap, K).permute(0, 2, 1)[:, :, None]
        sv = scales_v[bt].reshape(B, cap, K).permute(0, 2, 1)[:, :, None]
        s = torch.einsum("bkgh,btkh->bkgt", q.to(f), kd.to(f)) * sk * scale
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        e = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                        torch.zeros_like(s))
        l = e.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgt,btkh->bkgh", e * sv.to(f), vd.to(f))
    out = (o / l.clamp_min(_TINY)).to(q.dtype)
    return out[:, None] if squeeze else out


_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# keys of one block of the paged decode kernel (a split), by pool dtype: a
# whole number of 32-key tiles, one a warp, at most 8 (spans 64/128/256
# timed once at Qwen3's decode shape on an H100, PERF.md)
PAGED_SPAN = {torch.float32: 128, torch.bfloat16: 128, torch.int8: 256}
# ring slots of one block of the ring decode kernel, fp32 and bf16 caches
# alike (spans 64/128/256 timed once at Qwen3's and OPT's decode shapes on
# an H100, PERF.md: 256 fastest at each, a 160-slot ring in one split)
RING_SPAN = 256
# the (slot, KV head) counters of both decode kernels, by device
_paged_counters: dict = {}


def paged_splits(NB: int, P: int, l_real: Optional[int], span: int) -> int:
    """Blocks along the key axis of a paged decode launch (of a ring
    decode: NB 1, P L): the span's splits of ``min(NB * P, l_real)`` keys,
    at least one.  A slot takes those of them that hold its live keys, so
    its split depends on its own write index alone."""
    cap = NB * P if l_real is None else min(NB * P, int(l_real))
    return max(1, -(-cap // span))


def _counters(device, n: int) -> torch.Tensor:
    """The decode kernels' (slot, KV head) counters on ``device``: zeroed
    once and left at zero by every launch (the block that merges a slot's
    splits resets its counter), so launches on one device must not
    overlap; the port launches on one stream."""
    c = _paged_counters.get(device)
    if c is None or c.numel() < n:
        c = _paged_counters[device] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=device)
    return c


def flash_decode_paged(q, pages_k, pages_v, block_table, idx, *,
                       l_real: Optional[int] = None,
                       window: Optional[int] = None, scales_k=None,
                       scales_v=None):
    """One-token decode over a paged KV cache.  q: (B, 1, K, G, h) or
    (B, K, G, h); pages_k, pages_v: the (NP, P, K, h) post-write pools;
    ``block_table`` (B, NB) int page ids (unallocated entries must name a
    valid page: the engine's scratch page 0); ``idx`` (B,) write index of
    the current token; ``l_real`` bounds the logical length when
    ``NB * P`` overshoots it.  ``scales_k``/``scales_v`` (together) mark
    int8 pools with (NP, P, K) fp32 per-row scales and route to
    :func:`flash_decode_paged_int8`.  Returns o in q's rank and dtype.  The
    pools are read in place, never cast.  On the card each slot's keys are
    split over blocks of :data:`PAGED_SPAN` keys, every block's copies in
    flight at once, and the last block of a slot merges its partials in
    split order: bytes and memory latency bound the kernel, and a row's bits
    depend on its own inputs alone, not on the batch."""
    if q.device.type == "cpu":
        return flash_decode_paged_plain(
            q, pages_k, pages_v, block_table, idx, l_real=l_real,
            window=window, scales_k=scales_k, scales_v=scales_v)
    if scales_k is not None or scales_v is not None:
        return flash_decode_paged_int8(
            q, pages_k, pages_v, scales_k, scales_v, block_table, idx,
            l_real=l_real, window=window)
    out = _paged_launch(q, pages_k, pages_v, None, None, block_table, idx,
                        l_real, window)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


def flash_decode_paged_int8(q, pages_k, pages_v, scales_k, scales_v,
                            block_table, idx, *,
                            l_real: Optional[int] = None,
                            window: Optional[int] = None):
    """:func:`flash_decode_paged` over int8 pools with their (NP, P, K)
    fp32 per-row scales: scores scaled per key column, probabilities per
    value row, the payload converted in registers."""
    if q.device.type == "cpu":
        return flash_decode_paged_plain(
            q, pages_k, pages_v, block_table, idx, l_real=l_real,
            window=window, scales_k=scales_k, scales_v=scales_v)
    out = _paged_launch(q, pages_k, pages_v, scales_k, scales_v,
                        block_table, idx, l_real, window)
    flash_decode_paged_int8.launches += 1
    return out


flash_decode_paged_int8.launches = 0


def _paged_launch(q, pages_k, pages_v, scales_k, scales_v, block_table, idx,
                  l_real, window):
    """Check the operands and launch ``csrc/flash_decode_paged.cu``, with
    :data:`PAGED_SPAN` keys of the pool dtype a block."""
    squeeze = q.dim() == 5
    q4 = q[:, 0] if squeeze else q
    _check_paged(q4, pages_k, pages_v, block_table, idx, scales_k, scales_v)
    B, K, G, h = q4.shape
    P, NB = pages_k.shape[1], block_table.shape[1]
    quant = scales_k is not None
    for t in (pages_k, pages_v, block_table, scales_k, scales_v):
        if t is not None and t.device != q.device:
            raise ValueError(f"flash_decode_paged: tensors on {t.device} "
                             f"and {q.device}")
    if q4.dtype not in _DTYPES or pages_k.dtype not in _POOL_DTYPES \
            or pages_v.dtype != pages_k.dtype \
            or (pages_k.dtype == torch.int8) != quant:
        raise TypeError(f"flash_decode_paged: q {q4.dtype}, pools "
                        f"{pages_k.dtype}/{pages_v.dtype}, scales "
                        f"{'given' if quant else 'none'}: want fp32 or bf16 q "
                        "over fp32/bf16 pools, or int8 pools with scales")
    if h > _MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash_decode_paged: head dim {h} > {_MAX_HEAD_DIM}")
    if G > _MAX_GQA_DECODE:
        raise NotImplementedError(
            f"flash_decode_paged: {G} query heads per KV head > "
            f"{_MAX_GQA_DECODE}")
    pools = [pages_k, pages_v] + ([scales_k, scales_v] if quant else [])
    if quant and (scales_k.dtype != torch.float32
                  or scales_v.dtype != torch.float32):
        raise TypeError("flash_decode_paged: scales must be fp32")
    if (q4.stride(-1) != 1 or not all(t.is_contiguous() for t in pools)
            or any(t.data_ptr() % 16 for t in pools)):
        raise ValueError("flash_decode_paged: the pools must be contiguous "
                         "and 16-byte aligned, q's head dim contiguous")
    if pages_k.shape[0] * P * K >= 2 ** 31:
        raise NotImplementedError("flash_decode_paged: 2^31 pool rows or "
                                  "more")
    span = PAGED_SPAN[pages_k.dtype]
    splits = paged_splits(NB, P, l_real, span)
    bt = block_table.to(torch.int32).contiguous()
    iv = _int_arg(idx, B, q.device)[0]
    if iv is None:
        iv = torch.full((B,), int(idx), dtype=torch.int32, device=q.device)
    out = torch.empty(B, K, G, h, dtype=q4.dtype, device=q.device)
    # every partial a merge reads is written in the same launch; the C entry
    # refuses a grid whose splits do not fit
    ws = (torch.empty(B * K * splits * G * (h + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    err = build.entry("flash_decode_paged")(
        build.ptr(q4), build.ptr(pages_k), build.ptr(pages_v),
        build.ptr(scales_k), build.ptr(scales_v), build.ptr(bt),
        build.ptr(iv), build.ptr(out), build.ptr(ws),
        build.ptr(_counters(q.device, B * K)), B, K, G, h, P, NB,
        NB * P if l_real is None else int(l_real), span,
        0 if ws is None else ws.numel(), *q4.stride()[:3],
        -1 if window is None else int(window), 1.0 / math.sqrt(h),
        _DTYPES[q4.dtype], _POOL_DTYPES[pages_k.dtype],
        build.stream(q.device))
    build.check(err, "flash_decode_paged")
    return out[:, None] if squeeze else out
