"""Flash-attention kernels (CUDA): prefill, its backward, ring-cache decode.

* :func:`flash_prefill` (``csrc/flash_prefill.cu``) ports the TPU kernel
  ``repro.kernels.flash_attn.flash_prefill``: online-softmax attention of
  q ``(B, S, K, G, h)`` over k, v ``(B, T, K, h)`` with query ``s`` at
  ``q_off + s`` and key ``t`` at ``k_off + t`` (scalars or ``(B,)``
  vectors), causal and/or windowed, optionally returning the fp32
  log-sum-exp ``(B, K, S*G)``.
* :func:`flash_prefill_grads` (``csrc/flash_bwd.cu``) ports
  ``repro.kernels.flash_attn.flash_prefill_grads``: dq, dk and dv from
  q, k, v, the output, its lse and the output cotangent, with the
  probabilities recomputed from lse.
* :func:`flash_decode` (``csrc/flash_decode.cu``) ports
  ``repro.kernels.flash_attn.flash_decode``: one query token against the
  ``(B, L, K, h)`` ring cache, slot ``j`` holding position
  ``idx - ((idx - j) mod L)``.

Both keep the TPU kernels' masking contract: masked scores are -1e30,
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


def flash_decode(q, k, v, idx, *, window: Optional[int] = None):
    """One-token decode over the ring cache.  q: (B, 1, K, G, h) or
    (B, K, G, h); k, v: the (B, L, K, h) post-write cache; ``idx``: the
    current token's write index (int, or a (B,) tensor).  Returns o in
    q's rank."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, idx, window=window)
    q_dtype = q.dtype
    q, k, v = _promoted(q, k, v)
    _check_cuda("flash_decode", q, k, v)
    squeeze = q.dim() == 5
    q4 = q[:, 0] if squeeze else q
    B, K, G, h = q4.shape
    L = k.shape[1]
    if k.shape != (B, L, K, h) or v.shape != k.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} vs cache "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if G > _MAX_GQA_DECODE:
        raise NotImplementedError(
            f"flash_decode: {G} query heads per KV head > {_MAX_GQA_DECODE}")
    idx_vec, idx_s = _int_arg(idx, B, q.device)
    out = torch.empty(B, K, G, h, dtype=q.dtype, device=q.device)
    err = build.entry("flash_decode")(
        build.ptr(q4), build.ptr(k), build.ptr(v), build.ptr(out),
        build.ptr(idx_vec), idx_s, B, L, K, G, h, *q4.stride()[:3],
        *k.stride()[:3], *v.stride()[:3],
        -1 if window is None else int(window), 1.0 / math.sqrt(h),
        _DTYPES[q.dtype], build.stream(q.device))
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    out = out.to(q_dtype)
    return out[:, None] if squeeze else out


flash_decode.launches = 0
