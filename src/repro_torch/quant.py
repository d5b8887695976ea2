"""Symmetric quantization, the KV-page part (port of ``repro.quant``).

KV pages quantize per token row: one fp32 scale per ``(..., K)`` row,
reduced over the head dim the attention dot contracts, so the paged decode
kernel dequantizes exactly by scaling each score column and each
probability.  A page's rows are written one decode step at a time, so a
scale per page would depend on future tokens; per-row scales in
page-shaped ``(n_pages, P, K)`` fp32 pools stay exact under incremental
writes.

The DYAD weight sidecars (``quantize_dyad_weight``, ``quantize_params``)
wait for ROADMAP A.10.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch

_EPS = 1e-12

# dtype name -> (torch dtype, symmetric max representable value)
_QDTYPES = {"int8": (torch.int8, 127.0)}


def enabled() -> bool:
    """``REPRO_KERNEL_QUANT=off`` disables every quantized route."""
    return os.environ.get("REPRO_KERNEL_QUANT", "").lower() != "off"


def resolve_dtype(name: str) -> Tuple[torch.dtype, float]:
    """``(torch dtype, qmax)`` for a quantization dtype name."""
    if name not in _QDTYPES:
        raise ValueError(f"unknown quantization dtype {name!r} "
                         f"(the port knows {sorted(_QDTYPES)}; fp8 waits "
                         "for ROADMAP A.10)")
    return _QDTYPES[name]


def quant_symmetric(g: torch.Tensor, axis=None, dtype: str = "int8"):
    """``scale = max|g| / qmax + eps`` reduced over ``axis`` (None: one
    scalar), ``q = round(g / scale)`` (half to even, as ``jnp.round``)
    clipped to +-qmax and cast.  Returns ``(q, scale)`` with the reduced
    axis squeezed out of ``scale``."""
    qd, qmax = resolve_dtype(dtype)
    a = g.abs()
    m = a.amax() if axis is None else a.amax(dim=axis)
    scale = m.to(torch.float32) / qmax + _EPS
    s_full = scale if axis is None else scale.unsqueeze(axis)
    q = torch.clamp(torch.round(g.to(torch.float32) / s_full), -qmax, qmax)
    return q.to(qd), scale


def dequant(q: torch.Tensor, scale: torch.Tensor, axis=None) -> torch.Tensor:
    """Inverse of :func:`quant_symmetric`, in fp32."""
    s = scale if axis is None else scale.unsqueeze(axis)
    return q.to(torch.float32) * s


def quantize_kv_rows(x: torch.Tensor, dtype: str = "int8"):
    """K/V token rows ``(..., K, h)`` -> ``(q, scales (..., K) fp32)``,
    one scale per row over the head dim."""
    return quant_symmetric(x, axis=-1, dtype=dtype)
