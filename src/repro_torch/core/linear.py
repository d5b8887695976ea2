"""DENSE baseline linear layer (port of ``repro.core.linear``)."""
from __future__ import annotations

import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def init(generator: torch.Generator, f_in: int, f_out: int, *,
         bias: bool = True, dtype: torch.dtype = torch.float32,
         device=None) -> Params:
    """uniform(-k, k) with k = 1/sqrt(f_in) (the paper's DENSE baseline)."""
    k = 1.0 / math.sqrt(f_in)

    def u(*shape):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.uniform_(-k, k, generator=generator)

    p: Params = {"w": u(f_out, f_in)}
    if bias:
        p["b"] = u(f_out)
    return p


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype).T
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def param_count(f_in: int, f_out: int, bias: bool = True) -> int:
    return f_out * f_in + (f_out if bias else 0)


def flops(batch: int, f_in: int, f_out: int) -> int:
    return 2 * batch * f_out * f_in
