"""Token embedding / unembedding (port of ``repro.layers.embed``)."""
from __future__ import annotations

import math

import torch


def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32, device=None):
    t = torch.empty(vocab, d_model, dtype=dtype, device=device)
    return {"table": t.normal_(generator=generator) / math.sqrt(d_model)}


def embed(params, tokens: torch.Tensor, *, iota: bool = False):
    """Row lookup.  The reference's ``iota`` route is a one-hot matmul,
    chosen there so the vocab-sharded gradient stays a matmul; in fp32 the
    one-hot product adds exact zeros to one row, so it is the same function
    as this index lookup, which the port uses for both routes."""
    del iota
    return params["table"][tokens]


def unembed(params, x: torch.Tensor, *, tied_table=None):
    """Logits in fp32."""
    table = tied_table if tied_table is not None else params["table"]
    return x.float() @ table.float().T
