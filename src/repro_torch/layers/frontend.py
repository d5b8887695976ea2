"""Modality frontend stubs (port of ``repro.layers.frontend``).

The ``encdec`` (audio) and ``vlm`` configs describe the transformer
backbone only: their inputs are precomputed frame or patch embeddings,
which a trainable projector with bias (and, for the encoder, a sinusoidal
position signal) hands to the backbone.  A real conv or CLIP frontend
would replace only this file.
"""
from __future__ import annotations

import torch

from repro_torch.core import linear


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) fp32: sin on the even columns, cos on the odd, at the angles
    ``pos / 10000^(2i / d)``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.zeros(n, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : d // 2])
    return pe


def init_frontend(generator: torch.Generator, d_in: int, d_model: int,
                  dtype=torch.float32, device=None):
    """The projector from precomputed modality embeddings into the
    backbone's width: a dense linear with bias."""
    return {"proj": linear.init(generator, d_in, d_model, bias=True,
                                dtype=dtype, device=device)}


def apply_frontend(params, feats: torch.Tensor, *,
                   add_positions: bool = True) -> torch.Tensor:
    """feats: (B, T, d_in) frame or patch embeddings -> (B, T, d_model) in
    feats' dtype, the sinusoidal positions added with ``add_positions``."""
    x = linear.apply(params["proj"], feats)
    if add_positions:
        x = x + sinusoidal_positions(x.shape[1], x.shape[2],
                                     x.device).to(x.dtype)
    return x
