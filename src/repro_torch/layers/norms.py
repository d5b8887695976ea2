"""Normalization layers (port of ``repro.layers.norms``): the row
statistics reduce in fp32, the (B, S, D) elementwise math stays in the
activation dtype."""
from __future__ import annotations

import torch


def init_rmsnorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def init_layernorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mu.to(x.dtype)) * inv
    return y * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)
