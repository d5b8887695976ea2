"""The decoder-only model: init / forward / loss / cache / prefill /
decode_step (port of ``repro.models.model`` for the families ``lm``,
``moe``, ``ssm`` and ``hybrid``).  Parameters are nested dicts of tensors
with ``layers`` a list of per-layer dicts; the cache is a list of per-layer
dicts.  ``cfg.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
``nothing_saveable``).  The families ``encdec`` and ``vlm`` wait for
ROADMAP A.13."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import embed as embed_lib
from repro_torch.models import blocks
from repro_torch.models.config import ModelCfg


def _kind(cfg: ModelCfg) -> str:
    """The block kind of a ported family: the family's own name."""
    if cfg.family not in blocks.KINDS:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP A.13)")
    return cfg.family


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


def _embed_inputs(cfg: ModelCfg, params, tokens, offset=0):
    """Embedded tokens in the compute dtype, and their positions: ``(S,)``
    from a host-int offset, ``(B, S)`` from a per-slot ``(B,)`` offset
    (each slot's own rows of a learned position table)."""
    x = embed_lib.embed(params["embed"], tokens, iota=cfg.iota_embed)
    positions = attn_lib.offset_positions(offset, tokens.shape[1],
                                          tokens.device)
    if cfg.pos_embed == "learned":
        x = x + embed_lib.embed(params["pos"], positions)
    return x.to(cfg.cdtype), positions


def _logits(cfg: ModelCfg, params, x):
    x = blocks.apply_norm(cfg, params["final_norm"], x)
    return embed_lib.unembed(params.get("head", params["embed"]), x)


def forward(cfg: ModelCfg, params, tokens, *, last_only: bool = False,
            with_aux: bool = False):
    """Full-sequence forward without a cache.  tokens: (B, S) int.
    Returns fp32 logits (B, S, V), or (B, 1, V) with ``last_only``; with
    ``with_aux`` (logits, aux): the MoE layers' load-balance terms summed
    (a 0-dim fp32 tensor, 0 for a model without a router)."""
    kind = _kind(cfg)
    x, _ = _embed_inputs(cfg, params, tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = None
    for lp in params["layers"]:
        if remat:
            x, a = checkpoint(lambda h, lp=lp: blocks.apply_block(
                lp, h, cfg, kind)[::2], x, use_reentrant=False)
        else:
            x, _, a = blocks.apply_block(lp, x, cfg, kind)
        if a is not None:                 # the MoE router's term
            aux = a if aux is None else aux + a
    if last_only:
        x = x[:, -1:]
    logits = _logits(cfg, params, x)
    if not with_aux:
        return logits
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux


def loss_fn(cfg: ModelCfg, params, batch):
    """Next-token cross-entropy over ``batch = {"tokens", "labels"}``
    (labels < 0 are masked), in the reference's logsumexp - gold form,
    plus ``cfg.router_aux_coef`` times the router's aux term.  Returns
    (total, metrics) with detached 0-dim ``loss`` (the cross-entropy),
    ``aux`` (0 for a model without a router) and ``ppl_proxy``."""
    logits, aux = forward(cfg, params, batch["tokens"], with_aux=True)
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    total = loss + cfg.router_aux_coef * aux if cfg.family == "moe" else loss
    ld = loss.detach()
    return total, {"loss": ld, "aux": aux.detach(),
                   "ppl_proxy": torch.exp(ld.clamp_max(20.0))}


def init_cache(cfg: ModelCfg, batch: int, max_len: int,
               dtype=torch.float32, device=None, *, per_slot: bool = False,
               page_size: int = None, n_pages: int = None) -> list:
    """One cache dict per layer.  ``per_slot`` gives each batch row (a
    continuous-batching slot) its own write index; ``page_size`` and
    ``n_pages`` swap the dense rings for per-layer page pools addressed
    through per-slot block tables (one page id names the same logical
    page in every layer).  The per-slot write index and the block table
    are one tensor each, shared by every layer, so a host update of them
    is one copy, not one per layer."""
    kind = _kind(cfg)
    device = device_lib.resolve(device)
    cache = [blocks.init_block_cache(cfg, kind, batch, max_len, dtype, device,
                                     per_slot=per_slot, page_size=page_size,
                                     n_pages=n_pages)
             for _ in range(cfg.n_layers)]
    if "kv" in cache[0]:
        for name in ("block_table", "idx"):
            first = cache[0]["kv"].get(name)
            if torch.is_tensor(first):
                for lc in cache[1:]:
                    lc["kv"][name] = first
    return cache


def _run_cached(cfg: ModelCfg, params, cache, tokens, prefill: bool):
    kind = _kind(cfg)
    x, positions = _embed_inputs(cfg, params, tokens, offset=cache_pos(cache))
    # the cache's index tensors, built by the first layer for all of them
    shared = {}
    new_cache = []
    for lp, lc in zip(params["layers"], cache):
        x, nc, _ = blocks.apply_block(lp, x, cfg, kind, cache=lc,
                                      positions=positions, shared=shared,
                                      prefill=prefill)
        new_cache.append(nc)
    return x, new_cache


def prefill(cfg: ModelCfg, params, cache, tokens, *, last_only: bool = True):
    """Single-pass prefill: one full-sequence forward with cache writes
    (the SSM layers' chunked form hands on their state).  Returns (fp32
    logits (B, 1, V) or (B, S, V), cache positioned at S)."""
    x, new_cache = _run_cached(cfg, params, cache, tokens, prefill=True)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x), new_cache


def decode_step(cfg: ModelCfg, params, cache, tokens):
    """One-token decode.  tokens: (B, 1).  Returns (logits, new_cache)."""
    x, new_cache = _run_cached(cfg, params, cache, tokens, prefill=False)
    return _logits(cfg, params, x), new_cache


def cache_pos(cache):
    """The write index: a host int, or a per-slot ``(B,)`` tensor; 0 for
    a cache without attention (Mamba2 has no position embedding)."""
    kv = cache[0].get("kv")
    return 0 if kv is None else kv["idx"]


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
