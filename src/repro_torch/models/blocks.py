"""Per-layer blocks (port of ``repro.models.blocks`` for kind ``lm``).

Layers are a list of per-layer parameter dicts, not a stacked leading
axis: there is no ``scan`` to feed (``checkpoint.bridge`` unstacks the
reference's layout)."""
from __future__ import annotations

from repro_torch.layers import attention as attn_lib
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import norms
from repro_torch.models.config import ModelCfg


def _require_lm(kind: str) -> None:
    if kind != "lm":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP A.13)")


def _init_norm(cfg: ModelCfg, dtype, device):
    if cfg.norm == "layernorm":
        return norms.init_layernorm(cfg.d_model, dtype, device)
    return norms.init_rmsnorm(cfg.d_model, dtype, device)


def apply_norm(cfg: ModelCfg, p, x):
    if cfg.norm == "layernorm":
        return norms.layernorm(p, x)
    return norms.rmsnorm(p, x)


def init_block(generator, cfg: ModelCfg, kind: str, device=None):
    _require_lm(kind)
    dtype = cfg.pdtype
    return {
        "norm1": _init_norm(cfg, dtype, device),
        "attn": attn_lib.init_attention(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.linear, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
            dtype=dtype, device=device),
        "norm2": _init_norm(cfg, dtype, device),
        "mlp": mlp_lib.init_mlp(
            generator, cfg.d_model, cfg.d_ff, cfg.linear, act=cfg.act,
            bias=cfg.mlp_bias, dtype=dtype, device=device),
    }


def apply_block(params, x, cfg: ModelCfg, kind: str, *, cache=None):
    """Returns (x, new_cache); ``cache`` is this layer's ``{"kv": ...}``."""
    _require_lm(kind)
    h = apply_norm(cfg, params["norm1"], x)
    a, kv = attn_lib.attention(
        params["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd, lin_cfg=cfg.linear,
        rope_theta=cfg.rope_theta if cfg.pos_embed == "rope" else None,
        causal=True, window=cfg.window, chunk=cfg.attn_chunk,
        flash=cfg.flash_attn, cache=cache["kv"] if cache else None)
    x = x + a
    h = apply_norm(cfg, params["norm2"], x)
    x = x + mlp_lib.apply_mlp(params["mlp"], h, cfg.linear, act=cfg.act)
    return x, ({"kv": kv} if cache is not None else None)


def init_block_cache(cfg: ModelCfg, kind: str, batch: int, max_len: int,
                     dtype, device=None):
    """Dense KV ring of one block (bounded to the window when there is one)."""
    _require_lm(kind)
    L = min(max_len, cfg.window) if cfg.window else max_len
    return {"kv": attn_lib.init_kv_cache(batch, L, cfg.n_kv_heads, cfg.hd,
                                         dtype, device)}
