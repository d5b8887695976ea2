"""Multi-head / grouped-query attention with KV caches (port of
``repro.layers.attention`` for the ``lm`` serving paths).

Ported: RoPE, qk-norm (RMSNorm of each query and key head before RoPE),
the no-cache forward (the training path; on the flash route
differentiable through the flash backward kernel), and the reference's
three cache branches, each on the flash route (``kernels.ops``) and the
plain route (:func:`_naive_sdpa`):

* a dense ring with a host-int write index (the batch ``Engine``);
* per-slot dense rings, ``idx`` a ``(B,)`` tensor (the continuous
  engine's dense mode): decode writes row b at ``idx[b] % L``, prefill at
  ``idx[b]``, and key positions become ``(B, L)``;
* the paged pool (the continuous engine's paged mode): slot b's position
  j lives in page ``block_table[b, j // P]`` at row ``j % P``; int8 pools
  quantize each new row with ``quant.quantize_kv_rows`` (a ``kv_quant``
  route event each call).  S == 1 on the
  flash route runs ``flash_decode_paged`` over the pools; every other
  case attends a per-slot dense view gathered over ``NB * P`` rows
  (dequantized for int8).

``chunk`` is consulted where the reference consults it, on the plain route
only; the chunked einsum paths it selects there (``S > chunk``, or keys
beyond ``chunk``), cross-attention and the S >= L windowed-ring prefill
raise ``NotImplementedError``.  On the flash route the ``kernel_nan``
fault site (route ``attn_flash``) poisons the attention output; the
reference's ``attn_tp`` route events wait for tensor parallelism (A.11).

A cache is a dict: ``{"k", "v": (B, L, K, h), "idx"}`` (dense) or
``{"pages_k", "pages_v": (NP, P, K, h), ["scales_k", "scales_v":
(NP, P, K)], "block_table": (B, NB), "idx": (B,)}`` (paged).  Unlike the
reference's functional update, the new K/V rows are written into the
cache tensors in place: the returned cache shares them, which saves a
copy of every layer's cache per step.  Writing the same rows again (a
retried step) leaves the same state.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import faults, obs
from repro_torch import quant as quant_lib
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
              kv_input=None, cache=None, shared: Optional[dict] = None):
    """Returns (out, new_cache).  ``positions``: ``(S,)`` or per-slot
    ``(B, S)`` absolute positions of the queries; derived from the cache's
    write index when None.  ``shared``: a dict the model hands every layer
    of one step, in which the first layer leaves the cache's index tensors
    (write rows, gather indices, key positions) for the others: every
    layer reads the same write index and block table."""
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

    idx = cache["idx"] if cache is not None else 0
    if positions is None and cache is not None:
        positions = offset_positions(idx, S, dev)
    if rope_theta is not None:
        # roped before the cache write, so cached keys never re-rotate
        rp = (positions if positions is not None
              else torch.arange(S, device=dev))
        q = apply_rope(q, rp, rope_theta)
        k = apply_rope(k, rp, rope_theta)
    qg = q.reshape(B, S, K, G, head_dim)

    def once(name, make):
        """``make()``, computed by the first layer of the step only (a
        cache whose layers hold their own index tensors builds its own)."""
        if shared is None:
            return make()
        key = (name, idx if isinstance(idx, int) else id(idx))
        if key not in shared:
            shared[key] = make()
        return shared[key]

    new_cache = None
    paged = cache is not None and "block_table" in cache
    if paged:
        new_cache, k, v = _paged_write(cache, k, v, S, once,
                                       gather=not (use_flash and S == 1))
    elif cache is not None:
        new_cache, k, v = _dense_write(cache, k, v, S, once)

    if use_flash and paged and S == 1:
        # paged decode: K/V rows are gathered through the block table
        # inside the kernel; int8 pools ship their scale pools alongside
        o = kops.flash_decode_paged(
            qg, k, v, cache["block_table"], idx, window=window,
            scales_k=new_cache.get("scales_k"),
            scales_v=new_cache.get("scales_v"))
    elif use_flash and cache is not None and S == 1:
        # ring-cache decode: slot positions derive from idx in-kernel
        o = kops.flash_decode(qg, k, v, idx, window=window)
    elif use_flash and cache is None and (positions is None
                                          or positions.dim() == 1):
        # plain forward: contiguous positions q_off + arange(S), keys at
        # arange(T)
        q_off = 0 if positions is None else int(positions[0])
        o = kops.flash_attention(qg, k, v, q_off, 0, causal=causal,
                                 window=window,
                                 use_kernel_bwd=lin_cfg.use_kernel_bwd)
    elif use_flash and cache is None:
        raise NotImplementedError(
            "per-batch (B, S) positions without a cache: the reference "
            "takes its einsum path here, which the flash route does not "
            "(ROADMAP A.9)")
    elif use_flash and cache is not None and causal:
        # S < L cache prefill over the post-write cache (or the gathered
        # paged view): slot j holds position j, queries sit at
        # idx + arange(S); slots past idx + S - 1 fall outside the causal
        # band
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
                else torch.arange(S, device=dev))
        T = k.shape[1]
        if cache is None:
            kpos = torch.arange(T, device=dev)
        else:
            kpos = once("kpos", lambda: _key_positions(idx, S, T, dev,
                                                       ring=not paged))
        o = _naive_sdpa(qg, k, v, qpos, kpos, causal, window)
    if use_flash:
        # the kernel_nan fault site: a broken flash kernel (the port has
        # no attn rung to demote to, ROADMAP C.5)
        o = faults.poison(o, "kernel_nan", route="attn_flash")
    o = o.reshape(B, S, n_heads * head_dim)
    return factory.apply(params["wo"], o, lin_cfg, site="attn"), new_cache


def offset_positions(idx, S: int, device):
    """Absolute positions of S new tokens from a write index: ``(S,)`` for
    a host int, ``(B, S)`` for a per-slot ``(B,)`` tensor."""
    ar = torch.arange(S, device=device)
    if isinstance(idx, int):
        return idx + ar
    return idx.to(torch.int64)[:, None] + ar


def _key_positions(idx, S: int, T: int, device, ring: bool):
    """Positions of the T keys the attention reads after a write of S rows
    at ``idx`` (a host int, or a per-slot ``(B,)`` tensor, giving
    ``(B, T)``), ``_DEAD`` where a row holds no key.  A ring's decode
    (``ring`` and S == 1) reads row j as position ``idx - (idx - j) mod
    T``; otherwise row j holds position j up to ``idx + S - 1``."""
    j = torch.arange(T, device=device)
    iv = idx if isinstance(idx, int) else idx.to(torch.int64)[:, None]
    if ring and S == 1:
        kpos = iv - torch.remainder(iv - j, T)
        return torch.where(kpos >= 0, kpos, torch.full_like(kpos, _DEAD))
    return torch.where(j < iv + S, j, torch.full_like(j, _DEAD))


def _dense_write(cache, k, v, S: int, once):
    """Write the new rows into a dense ring.  Returns (new cache, keys,
    values): the post-write ring."""
    idx = cache["idx"]
    ck, cv = cache["k"], cache["v"]
    B, L = ck.shape[0], ck.shape[1]
    dev = ck.device
    if S >= L:
        raise NotImplementedError(
            "the S >= L windowed-ring prefill is not ported yet "
            "(ROADMAP A.8)")
    if isinstance(idx, int):
        # one write offset for the whole batch (the batch Engine)
        if S == 1:
            # ring-buffer write: slot = idx % L (plain write while idx < L)
            ck[:, idx % L] = k[:, 0].to(ck.dtype)
            cv[:, idx % L] = v[:, 0].to(cv.dtype)
        else:
            if idx + S > L:
                raise ValueError(f"prefill of {S} tokens at {idx} overflows "
                                 f"the {L}-slot cache")
            ck[:, idx:idx + S] = k.to(ck.dtype)
            cv[:, idx:idx + S] = v.to(cv.dtype)
    else:
        # per-slot write offsets (the continuous engine's dense rings):
        # decode wraps row b at idx[b] % L, prefill writes at idx[b]
        rows, cols = once("write", lambda: _ring_rows(idx, S, B, L, dev))
        ck[rows, cols] = k.to(ck.dtype)
        cv[rows, cols] = v.to(cv.dtype)
    return {"k": ck, "v": cv, "idx": idx + S}, ck, cv


def _ring_rows(idx, S: int, B: int, L: int, device):
    """(rows (B, 1), columns (B, S)) of the per-slot ring write at ``idx``
    (B,): decode wraps at ``idx[b] % L``, prefill writes from ``idx[b]``."""
    iv = idx.to(torch.int64)[:, None]
    cols = iv % L if S == 1 else iv + torch.arange(S, device=device)
    return torch.arange(B, device=device)[:, None], cols


def _page_rows(idx, bt, S: int, P: int):
    """(page ids, rows in the page) ``(B, S)`` of slot b's positions
    ``idx[b] + arange(S)`` through the block table ``bt`` (B, NB), or with
    ``idx`` None of positions ``arange(S)`` (the gathered view)."""
    j = torch.arange(S, device=bt.device)
    if idx is None:
        return bt.to(torch.int64)[:, j // P], j % P
    j = idx.to(torch.int64)[:, None] + j
    pid = torch.gather(bt.to(torch.int64), 1,
                       (j // P).clamp(0, bt.shape[1] - 1))
    return pid, j % P


def _paged_write(cache, k, v, S: int, once, gather: bool):
    """Write the new rows through the block table: slot b's position j
    lives in page ``bt[b, j // P]`` at row ``j % P``.  Positions never
    wrap (the engine hands out fresh pages), and the engine points free
    and mid-prefill lanes at the scratch page 0.  Returns (new cache,
    keys, values): the pools themselves (the paged decode kernel reads
    them through the block table), or with ``gather`` a per-slot dense
    view ``(B, NB * P, K, h)`` of them, dequantized to the new rows' dtype
    for int8 pools."""
    idx, bt = cache["idx"], cache["block_table"]
    pk, pv = cache["pages_k"], cache["pages_v"]
    P, NB = pk.shape[1], bt.shape[1]
    pid, row = once("write", lambda: _page_rows(idx, bt, S, P))
    quant_kv = "scales_k" in cache
    if quant_kv:
        obs.route_event("kv_quant", "int8")
        kq, ksc = quant_lib.quantize_kv_rows(k)
        vq, vsc = quant_lib.quantize_kv_rows(v)
        pk[pid, row] = kq
        pv[pid, row] = vq
        cache["scales_k"][pid, row] = ksc
        cache["scales_v"][pid, row] = vsc
    else:
        pk[pid, row] = k.to(pk.dtype)
        pv[pid, row] = v.to(pv.dtype)
    new_cache = dict(cache, idx=idx + S)
    if not gather:
        return new_cache, pk, pv

    gpid, gj = once("gather", lambda: _page_rows(None, bt, NB * P, P))
    kd, vd = pk[gpid, gj], pv[gpid, gj]
    if quant_kv:
        kd = (kd.to(torch.float32)
              * cache["scales_k"][gpid, gj][..., None]).to(k.dtype)
        vd = (vd.to(torch.float32)
              * cache["scales_v"][gpid, gj][..., None]).to(v.dtype)
    return new_cache, kd, vd


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.float32, device=None, *,
                  per_slot: bool = False):
    """Dense ring KV cache for one layer, write index 0: a host int, or
    with ``per_slot`` a ``(batch,)`` int32 tensor so each row (a
    continuous-batching slot) advances on its own."""
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": (torch.zeros(batch, dtype=torch.int32, device=device)
                    if per_slot else 0)}


def init_paged_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                        dtype=torch.bfloat16, device=None, *, page_size: int,
                        n_pages: int, quant: Optional[str] = None):
    """Paged KV cache for one layer: one shared ``(n_pages, page_size, K,
    h)`` pool per K and V, a per-slot ``(batch, ceil(max_len /
    page_size))`` int32 block table and per-slot int32 write indices.
    Page 0 is the reserved scratch page: block tables start at it, so
    unallocated entries (and the writes of the lanes the engine points at
    it) land off the live pages.

    ``quant="int8"`` stores int8 payloads plus per-token-row fp32 scale
    pools ``scales_k``/``scales_v`` ``(n_pages, page_size, K)``."""
    n_blocks = -(-max_len // page_size)
    pool = (n_pages, page_size, n_kv, head_dim)
    cache = {"block_table": torch.zeros(batch, n_blocks, dtype=torch.int32,
                                        device=device),
             "idx": torch.zeros(batch, dtype=torch.int32, device=device)}
    if quant is not None:
        if quant != "int8":
            raise ValueError(f"kv_quant supports 'int8' only, got {quant!r}")
        cache["pages_k"] = torch.zeros(pool, dtype=torch.int8, device=device)
        cache["pages_v"] = torch.zeros(pool, dtype=torch.int8, device=device)
        cache["scales_k"] = torch.zeros(pool[:3], dtype=torch.float32,
                                        device=device)
        cache["scales_v"] = torch.zeros(pool[:3], dtype=torch.float32,
                                        device=device)
    else:
        cache["pages_k"] = torch.zeros(pool, dtype=dtype, device=device)
        cache["pages_v"] = torch.zeros(pool, dtype=dtype, device=device)
    return cache
