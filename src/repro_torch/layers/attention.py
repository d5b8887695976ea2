"""Multi-head / grouped-query attention with a dense ring KV cache (port of
``repro.layers.attention`` for the ``lm`` serving path).

Ported: RoPE, qk-norm (RMSNorm of each query and key head before RoPE),
the no-cache forward (the training path; on the flash route
differentiable through the flash backward kernel) and the dense-ring cache
with a scalar write index, in both the S == 1 (decode) and the S < L
(prefill) branches, each on the flash route (``kernels.ops``) and the
plain route (:func:`_naive_sdpa`).  ``chunk`` is consulted where the
reference consults it, on the plain route only; the chunked einsum paths
it selects there (``S > chunk``, or keys beyond ``chunk``), cross-
attention, per-slot (vector) indices, paged pools and the S >= L
windowed-ring prefill raise ``NotImplementedError``.

The cache is a dict ``{"k", "v": (B, L, K, h) tensors, "idx": int}``; the
write index lives on the host (the batch engine knows every position).
Unlike the reference's functional update, the new K/V rows are written into
the cache tensors in place: the returned cache shares them, which saves a
copy of every layer's cache per step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import factory
from repro_torch.kernels import ops as kops
from repro_torch.layers import norms
from repro_torch.layers.rotary import apply_rope

NEG_INF = -1e30
_DEAD = -(10 ** 9)      # key position of an empty ring slot


def init_attention(generator, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, lin_cfg: factory.LinearCfg, *,
                   qkv_bias: bool = False, qk_norm: bool = False,
                   out_bias: bool = False, dtype=torch.float32, device=None):
    def lin(f_in, f_out, bias):
        return factory.init(generator, f_in, f_out, lin_cfg, site="attn",
                            bias=bias, dtype=dtype, device=device)

    p = {
        "wq": lin(d_model, n_heads * head_dim, qkv_bias),
        "wk": lin(d_model, n_kv * head_dim, qkv_bias),
        "wv": lin(d_model, n_kv * head_dim, qkv_bias),
        "wo": lin(n_heads * head_dim, d_model, out_bias),
    }
    if qk_norm:
        p["q_norm"] = norms.init_rmsnorm(head_dim, dtype, device)
        p["k_norm"] = norms.init_rmsnorm(head_dim, dtype, device)
    return p


def _mask(qpos, kpos, causal: bool, window: Optional[int]):
    """Boolean (..., S, T) validity mask from absolute positions."""
    m = kpos[..., None, :] >= 0
    if causal:
        m = m & (kpos[..., None, :] <= qpos[..., :, None])
    if window is not None:
        m = m & (qpos[..., :, None] - kpos[..., None, :] < window)
    return m


def _naive_sdpa(q, k, v, qpos, kpos, causal, window):
    """q: (B,S,K,G,h); k, v: (B,T,K,h) -> (B,S,K,G,h).

    Scores and softmax in fp32; probabilities cast back to v's dtype for
    the AV product.  Masked probabilities are zeroed and the denominator
    guarded (``max(l, 1e-30)``): a fully-masked row yields 0."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bskgh,btkh->bskgt", q.float(), k.float()) * scale
    m = _mask(qpos, kpos, causal, window)
    m = m[:, :, None, None, :] if m.dim() == 3 else m[None, :, None, None, :]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    e = torch.where(m, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros_like(s))
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bskgt,btkh->bskgh", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def attention(params, x, *, n_heads: int, n_kv: int, head_dim: int,
              lin_cfg: factory.LinearCfg,
              rope_theta: Optional[float] = None, positions=None,
              causal: bool = True, window: Optional[int] = None,
              chunk: Optional[int] = None, flash: bool = False,
              kv_input=None, cache=None):
    """Returns (out, new_cache)."""
    if kv_input is not None:
        raise NotImplementedError(
            "cross-attention is not ported yet (ROADMAP A.13)")
    B, S, _ = x.shape
    K, G = n_kv, n_heads // n_kv
    q = factory.apply(params["wq"], x, lin_cfg, site="attn")
    k = factory.apply(params["wk"], x, lin_cfg, site="attn")
    v = factory.apply(params["wv"], x, lin_cfg, site="attn")
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, K, head_dim)
    v = v.reshape(B, S, K, head_dim)
    if "q_norm" in params:
        q = norms.rmsnorm(params["q_norm"], q)
        k = norms.rmsnorm(params["k_norm"], k)
    use_flash = flash and kops.attn_route(x.device) == "flash"
    dev = x.device

    if positions is not None and positions.dim() != 1:
        raise NotImplementedError(
            "per-batch positions are not ported yet (ROADMAP A.9)")
    if rope_theta is not None:
        # roped before the cache write, so cached keys never re-rotate
        rp = positions
        if rp is None:
            start = cache["idx"] if cache is not None else 0
            rp = start + torch.arange(S, device=dev)
        q = apply_rope(q, rp, rope_theta)
        k = apply_rope(k, rp, rope_theta)
    qg = q.reshape(B, S, K, G, head_dim)

    new_cache, idx = None, 0
    if cache is not None:
        if "block_table" in cache:
            raise NotImplementedError(
                "the paged KV cache is not ported yet (ROADMAP A.9)")
        idx = cache["idx"]
        if not isinstance(idx, int):
            raise NotImplementedError(
                "per-slot cache indices are not ported yet (ROADMAP A.9)")
        ck, cv = cache["k"], cache["v"]
        L = ck.shape[1]
        if S == 1:
            # ring-buffer write: slot = idx % L (plain write while idx < L)
            ck[:, idx % L] = k[:, 0].to(ck.dtype)
            cv[:, idx % L] = v[:, 0].to(cv.dtype)
        elif S < L:
            if idx + S > L:
                raise ValueError(f"prefill of {S} tokens at {idx} overflows "
                                 f"the {L}-slot cache")
            ck[:, idx:idx + S] = k.to(ck.dtype)
            cv[:, idx:idx + S] = v.to(cv.dtype)
        else:
            raise NotImplementedError(
                "the S >= L windowed-ring prefill is not ported yet "
                "(ROADMAP A.8)")
        new_cache = {"k": ck, "v": cv, "idx": idx + S}
        k, v = ck, cv

    if use_flash and cache is not None and S == 1:
        # ring-cache decode: slot positions derive from idx in-kernel
        o = kops.flash_decode(qg, k, v, idx, window=window)
    elif use_flash and cache is None:
        # plain forward: contiguous positions q_off + arange(S), keys at
        # arange(T)
        q_off = 0 if positions is None else int(positions[0])
        o = kops.flash_attention(qg, k, v, q_off, 0, causal=causal,
                                 window=window,
                                 use_kernel_bwd=lin_cfg.use_kernel_bwd)
    elif use_flash and causal:
        # S < L cache prefill over the post-write cache: slot j holds
        # position j, queries sit at idx + arange(S); tail slots past
        # idx + S - 1 fall outside the causal band
        o = kops.flash_attention(qg, k, v, idx, 0, causal=True,
                                 window=window)
    elif chunk is not None and cache is None and S > chunk and \
            S % chunk == 0:
        raise NotImplementedError(
            "the q-blocked chunked attention (_q_block_sdpa) is not ported "
            "yet (ROADMAP A.4)")
    elif chunk is not None and k.shape[1] > chunk:
        raise NotImplementedError(
            "the key-chunked attention (_chunked_sdpa) is not ported yet "
            "(ROADMAP A.4)")
    else:
        qpos = (positions if positions is not None
                else idx + torch.arange(S, device=dev))
        o = _naive_sdpa(qg, k, v, qpos, _key_positions(cache, idx, S, k),
                        causal, window)
    o = o.reshape(B, S, n_heads * head_dim)
    return factory.apply(params["wo"], o, lin_cfg, site="attn"), new_cache


def _key_positions(cache, idx: int, S: int, k):
    """Absolute position held by each key slot (``_DEAD`` when empty)."""
    j = torch.arange(k.shape[1], device=k.device)
    if cache is None:
        return j
    if S == 1:
        kpos = idx - torch.remainder(idx - j, k.shape[1])
        return torch.where(kpos >= 0, kpos, torch.full_like(kpos, _DEAD))
    return torch.where(j < idx + S, j, torch.full_like(j, _DEAD))


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.float32, device=None):
    """Dense ring KV cache for one layer, write index 0."""
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": 0}
