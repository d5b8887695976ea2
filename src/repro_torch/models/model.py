"""The ``lm`` model: init / forward / loss / cache / prefill / decode_step
(port of ``repro.models.model``).  Parameters are nested dicts of tensors
with ``layers`` a list of per-layer dicts; the cache is a list of per-layer
dicts.  ``cfg.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
``nothing_saveable``)."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch.layers import embed as embed_lib
from repro_torch.models import blocks
from repro_torch.models.config import ModelCfg


def _kind(cfg: ModelCfg) -> str:
    if cfg.family != "lm":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A.13)")
    return "lm"


def init_params(cfg: ModelCfg, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``; ``None`` means cuda)."""
    kind = _kind(cfg)
    device = device_lib.resolve(device)
    dtype = cfg.pdtype
    p = {
        "embed": embed_lib.init_embedding(generator, cfg.vocab_size,
                                          cfg.d_model, dtype, device),
        "layers": [blocks.init_block(generator, cfg, kind, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": blocks._init_norm(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = embed_lib.init_embedding(generator, cfg.vocab_size,
                                             cfg.d_model, dtype, device)
    if cfg.pos_embed == "learned":
        p["pos"] = embed_lib.init_embedding(generator, cfg.max_position,
                                            cfg.d_model, dtype, device)
    return p


def _embed_inputs(cfg: ModelCfg, params, tokens, offset: int = 0):
    x = embed_lib.embed(params["embed"], tokens, iota=cfg.iota_embed)
    if cfg.pos_embed == "learned":
        positions = offset + torch.arange(tokens.shape[1],
                                          device=tokens.device)
        x = x + embed_lib.embed(params["pos"], positions)
    return x.to(cfg.cdtype)


def _logits(cfg: ModelCfg, params, x):
    x = blocks.apply_norm(cfg, params["final_norm"], x)
    return embed_lib.unembed(params.get("head", params["embed"]), x)


def forward(cfg: ModelCfg, params, tokens, *, last_only: bool = False):
    """Full-sequence forward without a cache.  tokens: (B, S) int.
    Returns fp32 logits (B, S, V), or (B, 1, V) with ``last_only``."""
    kind = _kind(cfg)
    x = _embed_inputs(cfg, params, tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:
            x = checkpoint(lambda h, lp=lp: blocks.apply_block(
                lp, h, cfg, kind)[0], x, use_reentrant=False)
        else:
            x, _ = blocks.apply_block(lp, x, cfg, kind)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x)


def loss_fn(cfg: ModelCfg, params, batch):
    """Next-token cross-entropy over ``batch = {"tokens", "labels"}``
    (labels < 0 are masked), in the reference's logsumexp - gold form.
    Returns (loss, metrics) with detached 0-dim ``loss``, ``aux`` (0 for
    the ``lm`` family, which has no router) and ``ppl_proxy``."""
    logits = forward(cfg, params, batch["tokens"])
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    ld = loss.detach()
    return loss, {"loss": ld, "aux": torch.zeros_like(ld),
                  "ppl_proxy": torch.exp(ld.clamp_max(20.0))}


def init_cache(cfg: ModelCfg, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> list:
    kind = _kind(cfg)
    device = device_lib.resolve(device)
    return [blocks.init_block_cache(cfg, kind, batch, max_len, dtype, device)
            for _ in range(cfg.n_layers)]


def _run_cached(cfg: ModelCfg, params, cache, tokens):
    kind = _kind(cfg)
    x = _embed_inputs(cfg, params, tokens, offset=cache_pos(cache))
    new_cache = []
    for lp, lc in zip(params["layers"], cache):
        x, nc = blocks.apply_block(lp, x, cfg, kind, cache=lc)
        new_cache.append(nc)
    return x, new_cache


def prefill(cfg: ModelCfg, params, cache, tokens, *, last_only: bool = True):
    """Single-pass prefill: one full-sequence forward with cache writes.
    Returns (fp32 logits (B, 1, V) or (B, S, V), cache positioned at S)."""
    x, new_cache = _run_cached(cfg, params, cache, tokens)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x), new_cache


def decode_step(cfg: ModelCfg, params, cache, tokens):
    """One-token decode.  tokens: (B, 1).  Returns (logits, new_cache)."""
    x, new_cache = _run_cached(cfg, params, cache, tokens)
    return _logits(cfg, params, x), new_cache


def cache_pos(cache) -> int:
    return cache[0]["kv"]["idx"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))
