"""Batched serving engine (port of ``repro.serve.engine``: ``prefill``,
``sample_token`` and the homogeneous-batch :class:`Engine`).

``Engine.generate`` runs one single-pass prefill for the whole prompt
batch, then a Python decode loop.  Token semantics follow the reference:
the first emitted token is sampled from the prefill logits and each decode
step feeds the previous token, so ``generate`` returns ``(B, num_new)``.
The continuous-batching engine waits for a later slice (ROADMAP A.9).
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch import device as device_lib
from repro_torch.models import model
from repro_torch.models.config import ModelCfg


def prefill(cfg: ModelCfg, params, cache, tokens):
    """Single-pass prefill.  Returns (last logits (B,1,V) fp32, cache at S)."""
    return model.prefill(cfg, params, cache, tokens)


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature <= 0 or no generator) or temperature sampling
    from the last position of ``logits (B, S, V)``.  Returns (B, 1) int64.
    Greedy ties go to the first index, as ``jnp.argmax``."""
    last = logits[:, -1]
    if temperature <= 0.0 or generator is None:
        return torch.argmax(last, dim=-1, keepdim=True)
    probs = torch.softmax(last / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Greedy/temperature batched generation over a persistent cache.

    After each ``generate``, ``timings`` holds ``prefill_s`` (prompt in to
    first token out) and ``decode_s`` (the decode loop), each measured on
    the host clock after a device synchronisation.
    """

    def __init__(self, cfg: ModelCfg, params, max_len: int,
                 cache_dtype: torch.dtype = torch.float32, device=None):
        self.cfg, self.params, self.max_len = cfg, params, max_len
        self.cache_dtype = cache_dtype
        self.device = device_lib.resolve(device)
        self.timings: dict = {}

    @torch.no_grad()
    def generate(self, prompt_tokens: torch.Tensor, num_new: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """prompt_tokens: (B, S) int -> (B, num_new) int64 generated tokens.

        Requires S + num_new - 1 <= max_len (the cache length)."""
        B, S = prompt_tokens.shape
        if num_new < 1:
            raise ValueError(f"num_new must be >= 1, got {num_new}")
        if S + num_new - 1 > self.max_len:
            raise ValueError(
                f"prompt {S} + {num_new} new tokens exceeds max_len "
                f"{self.max_len}")
        tokens = prompt_tokens.to(self.device)
        t0 = time.perf_counter()
        cache = model.init_cache(self.cfg, B, self.max_len, self.cache_dtype,
                                 self.device)
        logits, cache = prefill(self.cfg, self.params, cache, tokens)
        tok = sample_token(logits, temperature, generator)
        _sync(self.device)
        t1 = time.perf_counter()
        out = [tok]
        # the reference's scan also runs a last step whose token it drops
        for _ in range(num_new - 1):
            logits, cache = model.decode_step(self.cfg, self.params, cache,
                                              tok)
            tok = sample_token(logits, temperature, generator)
            out.append(tok)
        toks = torch.cat(out, dim=1)
        _sync(self.device)
        self.timings = {"prefill_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1}
        return toks
