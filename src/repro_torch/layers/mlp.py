"""Transformer ff module — the site the paper targets with DYAD (port of
``repro.layers.mlp``, plain tier: each projection through
``factory.apply``).  The ``fuse_mlp`` einsum tier and the
``fuse_ff_kernel`` megakernel tier are not ported yet (ROADMAP B.8)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import factory

# the reference's activation table (jax.nn.gelu defaults to the tanh form)
ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def init_mlp(generator, d_model: int, d_ff: int, lin_cfg: factory.LinearCfg,
             *, act: str = "swiglu", bias: bool = False, dtype=torch.float32,
             device=None):
    def lin(f_in, f_out):
        return factory.init(generator, f_in, f_out, lin_cfg, site="ff",
                            bias=bias, dtype=dtype, device=device)

    if act == "swiglu":
        return {"gate": lin(d_model, d_ff), "up": lin(d_model, d_ff),
                "down": lin(d_ff, d_model)}
    return {"up": lin(d_model, d_ff), "down": lin(d_ff, d_model)}


def apply_mlp(params, x, lin_cfg: factory.LinearCfg, *, act: str = "swiglu"):
    if lin_cfg.fuse_mlp or lin_cfg.fuse_ff_kernel:
        raise NotImplementedError(
            "the fused ff tiers (fuse_mlp, fuse_ff_kernel) are not ported "
            "yet (ROADMAP B.8)")
    if act == "swiglu":
        g = factory.apply(params["gate"], x, lin_cfg, site="ff")
        u = factory.apply(params["up"], x, lin_cfg, site="ff")
        h = F.silu(g) * u
    else:
        h = ACTS[act](factory.apply(params["up"], x, lin_cfg, site="ff"))
    return factory.apply(params["down"], h, lin_cfg, site="ff")
