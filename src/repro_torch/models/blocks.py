"""Per-layer blocks (port of ``repro.models.blocks``): the kinds ``lm``,
``moe``, ``ssm``, ``hybrid``, ``enc`` (the encoder's non-causal block)
and ``dec_cross`` (the decoder's block: self-attention, then
cross-attention over the encoder's output, then the ff).

Layers are a list of per-layer parameter dicts, not a stacked leading
axis: there is no ``scan`` to feed (``checkpoint.bridge`` unstacks the
reference's layout)."""
from __future__ import annotations

import torch

from repro_torch import quant as quant_lib
from repro_torch.core import factory
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers import norms
from repro_torch.layers import ssm as ssm_lib
from repro_torch.models.config import ModelCfg

def _init_norm(cfg: ModelCfg, dtype, device):
    if cfg.norm == "layernorm":
        return norms.init_layernorm(cfg.d_model, dtype, device)
    return norms.init_rmsnorm(cfg.d_model, dtype, device)


def apply_norm(cfg: ModelCfg, p, x):
    if cfg.norm == "layernorm":
        return norms.layernorm(p, x)
    return norms.rmsnorm(p, x)


def _ssm_kw(cfg: ModelCfg) -> dict:
    return dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                n_groups=cfg.ssm_groups)


def init_block(generator, cfg: ModelCfg, kind: str, device=None):
    """kind: lm | moe | ssm | hybrid | enc | dec_cross."""
    dtype = cfg.pdtype
    p = {"norm1": _init_norm(cfg, dtype, device)}
    if kind != "ssm":
        p["attn"] = attn_lib.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.linear, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
            dtype=dtype, device=device)
    if kind == "dec_cross":
        # cross-attention has no qk-norm
        p["xnorm"] = _init_norm(cfg, dtype, device)
        p["xattn"] = attn_lib.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.linear, qkv_bias=cfg.qkv_bias, dtype=dtype, device=device)
    if kind in ("ssm", "hybrid"):
        p["ssm"] = ssm_lib.init_ssm(
            generator, cfg.d_model, cfg.linear, d_state=cfg.ssm_state,
            head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
            n_groups=cfg.ssm_groups, conv_width=cfg.conv_width, dtype=dtype,
            device=device)
    if kind == "hybrid":
        p["bnorm_a"] = norms.init_rmsnorm(cfg.d_model, dtype, device)
        p["bnorm_s"] = norms.init_rmsnorm(cfg.d_model, dtype, device)
    if kind == "ssm":
        return p
    p["norm2"] = _init_norm(cfg, dtype, device)
    if kind == "moe":
        p["moe"] = moe_lib.init_moe(
            generator, cfg.d_model, cfg.expert_d_ff, cfg.n_experts,
            cfg.top_k, cfg.linear, n_shared=cfg.n_shared, act=cfg.act,
            n_experts_padded=cfg.e_pad, dtype=dtype, device=device)
    else:
        p["mlp"] = mlp_lib.init_mlp(
            generator, cfg.d_model, cfg.d_ff, cfg.linear, act=cfg.act,
            bias=cfg.mlp_bias, dtype=dtype, device=device)
    return p


def _ssm(params, cfg: ModelCfg, h, cache, prefill: bool):
    """The SSM mixer without a cache, or through it: the chunked prefill,
    or the one-token recurrent step.  Returns (y, new SSM cache or
    None)."""
    if cache is None:
        return ssm_lib.apply_ssm(params, h, cfg.linear, chunk=cfg.ssd_chunk,
                                 **_ssm_kw(cfg)), None
    if prefill:
        return ssm_lib.ssm_prefill(params, h, cache["ssm"], cfg.linear,
                                   chunk=cfg.ssd_chunk, **_ssm_kw(cfg))
    return ssm_lib.ssm_decode_step(params, h, cache["ssm"], cfg.linear,
                                   **_ssm_kw(cfg))


def apply_block(params, x, cfg: ModelCfg, kind: str, *, cache=None,
                enc_out=None, positions=None, shared=None,
                prefill: bool = False):
    """Returns (x, new_cache, aux): ``cache`` is this layer's dict
    (``{"kv": ...}``, ``{"ssm": ...}`` or both; a ``dec_cross`` layer's
    also holds the cross K/V ``xk`` and ``xv``), ``enc_out`` the
    encoder's output a ``dec_cross`` layer attends when its cache holds
    no cross K/V, ``positions`` the tokens' ``(S,)`` or per-slot ``(B,
    S)`` positions, ``shared`` the step's index work shared across layers
    (see ``layers.attention.attention``); ``aux`` the MoE router's
    load-balance term, None for the other kinds.  ``prefill`` marks a
    cached pass of the prompt: the SSM mixer runs its chunked form and
    hands on the state, instead of one recurrent step.

    The attention cache is written in place; the SSM cache is not (the
    new one is returned), so a step can be taken again from the same
    state."""
    new_cache = {} if cache is not None else None
    aux = None
    h = apply_norm(cfg, params["norm1"], x)
    if kind != "ssm":
        a, kv = attn_lib.attention(
            params["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, lin_cfg=cfg.linear,
            rope_theta=cfg.rope_theta if cfg.pos_embed == "rope" else None,
            positions=positions, causal=kind != "enc", window=cfg.window,
            chunk=cfg.attn_chunk, flash=cfg.flash_attn,
            cache=cache["kv"] if cache else None, shared=shared)
        if cache is not None:
            new_cache["kv"] = kv
    if kind in ("ssm", "hybrid"):
        s, sc = _ssm(params["ssm"], cfg, h, cache, prefill)
        if cache is not None:
            new_cache["ssm"] = sc
        if kind == "ssm":
            return x + s, new_cache, aux
        # parallel heads, each branch normed, averaged (Hymba)
        x = x + 0.5 * (norms.rmsnorm(params["bnorm_a"], a)
                       + norms.rmsnorm(params["bnorm_s"], s))
    else:
        x = x + a
    if kind == "dec_cross":
        h = apply_norm(cfg, params["xnorm"], x)
        if cache is not None and "xk" in cache:
            # the cross K/V were filled at prefill (model.prefill_cross)
            xa = _cross_from_cache(params["xattn"], cfg, h, cache)
            new_cache["xk"], new_cache["xv"] = cache["xk"], cache["xv"]
        else:
            xa, _ = attn_lib.attention(
                params["xattn"], h, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, head_dim=cfg.hd, lin_cfg=cfg.linear,
                causal=False, kv_input=enc_out)
        x = x + xa
    h = apply_norm(cfg, params["norm2"], x)
    if kind == "moe":
        m, aux = moe_lib.apply_moe(
            params["moe"], h, cfg.linear, n_experts=cfg.n_experts,
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            act=cfg.act, chunk=cfg.moe_chunk)
    else:
        m = mlp_lib.apply_mlp(params["mlp"], h, cfg.linear, act=cfg.act)
    return x + m, new_cache, aux


def _cross_from_cache(p, cfg: ModelCfg, q_in, cache):
    """Cross-attention of the queries ``q_in`` over the cross K/V a
    prefill left in ``cache`` (``xk``, ``xv``: (B, n_frames, K, h))."""
    B, S, _ = q_in.shape
    K, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q = factory.apply(p["wq"], q_in, cfg.linear, site="attn").reshape(
        B, S, cfg.n_heads, cfg.hd)
    if "q_norm" in p:
        q = norms.rmsnorm(p["q_norm"], q)
    o = attn_lib._cross_sdpa(q.reshape(B, S, K, G, cfg.hd), cache["xk"],
                             cache["xv"])
    o = o.reshape(B, S, cfg.n_heads * cfg.hd)
    return factory.apply(p["wo"], o, cfg.linear, site="attn")


def init_block_cache(cfg: ModelCfg, kind: str, batch: int, max_len: int,
                     dtype, device=None, *, per_slot: bool = False,
                     page_size: int = None, n_pages: int = None):
    """The cache of one block: for attention a dense ring (bounded to the
    window when there is one; a per-slot write index with ``per_slot``),
    or with ``page_size`` a paged pool (``layers.attention.
    init_paged_kv_cache``, int8 when ``cfg.kv_quant`` says so and
    ``REPRO_KERNEL_QUANT`` is not off); for the SSM mixer its conv tail
    (in the compute dtype) and fp32 state; for a ``dec_cross`` block the
    cross K/V ``xk`` and ``xv``, (batch, n_frames, K, h) zeros in
    ``dtype``, which ``model.prefill_cross`` fills."""
    c = {}
    if kind in ("lm", "moe", "hybrid", "dec_cross"):
        if page_size is not None:
            kvq = cfg.kv_quant if quant_lib.enabled() else None
            c["kv"] = attn_lib.init_paged_kv_cache(
                batch, max_len, cfg.n_kv_heads, cfg.hd, dtype, device,
                page_size=page_size, n_pages=n_pages, quant=kvq)
        else:
            L = min(max_len, cfg.window) if cfg.window else max_len
            c["kv"] = attn_lib.init_kv_cache(batch, L, cfg.n_kv_heads,
                                             cfg.hd, dtype, device,
                                             per_slot=per_slot)
    if kind in ("ssm", "hybrid"):
        c["ssm"] = ssm_lib.init_ssm_cache(
            batch, cfg.d_model, d_state=cfg.ssm_state,
            head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
            n_groups=cfg.ssm_groups, conv_width=cfg.conv_width,
            dtype=cfg.cdtype, device=device)
    if kind == "dec_cross":
        shape = (batch, cfg.n_frames, cfg.n_kv_heads, cfg.hd)
        c["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c
