"""The model: init / forward / loss / cache / prefill / decode_step (port
of ``repro.models.model`` for every family: ``lm``, ``moe``, ``ssm``,
``hybrid``, ``encdec`` and ``vlm``).  Parameters are nested dicts of
tensors with ``layers`` (and an encoder-decoder's ``enc_layers``) a list
of per-layer dicts; the cache is a list of per-layer dicts.
``cfg.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
``nothing_saveable``).

An ``encdec`` model (Whisper) encodes precomputed ``frames`` (B,
n_frames, frontend_dim) through the frontend and a non-causal encoder
stack; its decoder blocks cross-attend the encoder's output, or in
serving the cross K/V :func:`prefill_cross` leaves in the cache.  A
``vlm`` model (Phi-3-vision) prepends its projected ``patches`` (B,
n_patches, frontend_dim) to the text, the positions covering both, and
returns logits over the text positions only; it serves text only, as
the reference's ``prefill`` takes no patches."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch.core import factory
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import embed as embed_lib
from repro_torch.layers import frontend as frontend_lib
from repro_torch.models import blocks
from repro_torch.models.config import ModelCfg

# the block kind of each family's (decoder) layers
_KIND = {"lm": "lm", "moe": "moe", "ssm": "ssm", "vlm": "lm",
         "hybrid": "hybrid", "encdec": "dec_cross"}


def block_kind(cfg: ModelCfg) -> str:
    return _KIND[cfg.family]


def init_params(cfg: ModelCfg, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``; ``None`` means cuda)."""
    kind = block_kind(cfg)
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
    if cfg.family == "encdec":
        p["enc_layers"] = [blocks.init_block(generator, cfg, "enc", device)
                           for _ in range(cfg.n_enc_layers)]
        p["enc_norm"] = blocks._init_norm(cfg, dtype, device)
    if cfg.family in ("encdec", "vlm"):
        p["frontend"] = frontend_lib.init_frontend(
            generator, cfg.frontend_dim, cfg.d_model, dtype, device)
    return p


def _run_layers(cfg: ModelCfg, layers, x, kind: str, *, enc_out=None):
    """The no-cache pass of ``x`` through ``layers`` (recomputed in the
    backward under ``cfg.remat``).  Returns (x, the MoE layers' aux terms
    summed, or None)."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = None
    for lp in layers:
        if remat:
            x, a = checkpoint(lambda h, lp=lp: blocks.apply_block(
                lp, h, cfg, kind, enc_out=enc_out)[::2], x,
                use_reentrant=False)
        else:
            x, _, a = blocks.apply_block(lp, x, cfg, kind, enc_out=enc_out)
        if a is not None:                 # the MoE router's term
            aux = a if aux is None else aux + a
    return x, aux


def encode(cfg: ModelCfg, params, frames):
    """The encoder (``encdec``): frames (B, n_frames, frontend_dim) through
    the frontend (with sinusoidal positions), the non-causal encoder
    stack and its norm.  Returns (B, n_frames, d_model) in the compute
    dtype."""
    x = frontend_lib.apply_frontend(params["frontend"], frames)
    x, _ = _run_layers(cfg, params["enc_layers"], x.to(cfg.cdtype), "enc")
    return blocks.apply_norm(cfg, params["enc_norm"], x)


def _embed_inputs(cfg: ModelCfg, params, tokens, offset=0, patches=None):
    """Embedded tokens in the compute dtype, and their positions: ``(S,)``
    from a host-int offset, ``(B, S)`` from a per-slot ``(B,)`` offset
    (each slot's own rows of a learned position table).  A ``vlm``
    model's ``patches`` are projected and prepended, the positions
    covering them."""
    x = embed_lib.embed(params["embed"], tokens, iota=cfg.iota_embed)
    if cfg.family == "vlm" and patches is not None:
        pe = frontend_lib.apply_frontend(params["frontend"], patches,
                                         add_positions=False)
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    positions = attn_lib.offset_positions(offset, x.shape[1], tokens.device)
    if cfg.pos_embed == "learned":
        x = x + embed_lib.embed(params["pos"], positions)
    return x.to(cfg.cdtype), positions


def _logits(cfg: ModelCfg, params, x):
    x = blocks.apply_norm(cfg, params["final_norm"], x)
    return embed_lib.unembed(params.get("head", params["embed"]), x)


def forward(cfg: ModelCfg, params, tokens, *, frames=None, patches=None,
            last_only: bool = False, with_aux: bool = False):
    """Full-sequence forward without a cache.  tokens: (B, S) int;
    ``frames`` (B, n_frames, frontend_dim), which an ``encdec`` model
    needs, and ``patches`` (B, n_patches, frontend_dim), which a ``vlm``
    model prepends to the text, as the reference's ``batch`` carries
    them.  Returns fp32 logits (B, S, V) over the text positions, or (B,
    1, V) with ``last_only``; with ``with_aux`` (logits, aux): the MoE
    layers' load-balance terms summed (a 0-dim fp32 tensor, 0 for a
    model without a router)."""
    kind = block_kind(cfg)
    x, _ = _embed_inputs(cfg, params, tokens, patches=patches)
    enc_out = None
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError("an encdec model's forward needs frames")
        enc_out = encode(cfg, params, frames)
    x, aux = _run_layers(cfg, params["layers"], x, kind, enc_out=enc_out)
    if cfg.family == "vlm" and patches is not None:
        x = x[:, patches.shape[1]:]       # logits over the text positions
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
    (labels < 0 are masked; ``frames`` or ``patches`` as :func:`forward`
    takes them), in the reference's logsumexp - gold form, plus
    ``cfg.router_aux_coef`` times the router's aux term.  Returns (total,
    metrics) with detached 0-dim ``loss`` (the cross-entropy), ``aux`` (0
    for a model without a router) and ``ppl_proxy``."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          frames=batch.get("frames"),
                          patches=batch.get("patches"), with_aux=True)
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
    kind = block_kind(cfg)
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


def prefill_cross(cfg: ModelCfg, params, cache, frames):
    """``encdec``: encode ``frames`` and fill each decoder layer's cross
    K/V (``xk``, ``xv``, cast to the cache's dtype) from the encoder's
    output.  Returns the cache."""
    enc_out = encode(cfg, params, frames)
    B, T, _ = enc_out.shape
    for lp, lc in zip(params["layers"], cache):
        for name, w in (("xk", "wk"), ("xv", "wv")):
            kv = factory.apply(lp["xattn"][w], enc_out, cfg.linear,
                               site="attn")
            lc[name] = kv.reshape(B, T, cfg.n_kv_heads, cfg.hd).to(
                lc[name].dtype)
    return cache


def _run_cached(cfg: ModelCfg, params, cache, tokens, prefill: bool):
    kind = block_kind(cfg)
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


def prefill(cfg: ModelCfg, params, cache, tokens, *, frames=None,
            last_only: bool = True):
    """Single-pass prefill: one full-sequence forward with cache writes
    (the SSM layers' chunked form hands on their state); an ``encdec``
    model's ``frames`` fill the cross K/V first.  Returns (fp32 logits
    (B, 1, V) or (B, S, V), cache positioned at S)."""
    if cfg.family == "encdec" and frames is not None:
        cache = prefill_cross(cfg, params, cache, frames)
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


def non_embedding_param_count(params) -> int:
    """The parameters but the token, head and learned position tables."""
    return param_count(params) - sum(
        params[k]["table"].numel() for k in ("embed", "head", "pos")
        if k in params)
