"""Symmetric quantization: one codec for DYAD weights, KV pages and
gradients (port of ``repro.quant``).

DYAD weights quantize per ``(block, out_row)``: a DYAD component
``(n, d_out, d_in)`` contracts ``d_in`` per block, so one fp32 scale per
output row, reduced over the contracted axis only, is constant along k and

    sum_k x[k] * (q[o, k] * s[o])  ==  (sum_k x[k] * q[o, k]) * s[o]

The quantized kernels (``kernels.dyad_mm.dyad_mm_blocks_q``,
``dyad_mm_blocks_two_q``, ``dyad_ff_fused_q``) read the int8/fp8 payload
as bytes, convert it in registers and multiply the scale into the fp32
sums; no dequantized weight exists in device memory.  ``quantize_params``
adds the sidecars ``w1_q``/``w1_s``/``w2_q``/``w2_s`` beside each DYAD
module's retained ``w1``/``w2``; the dispatch sites check
:func:`enabled` and the sidecars' presence, and with
``REPRO_KERNEL_QUANT=off`` (or inside :func:`disabled`) every route is
the unquantized one, bit for bit.

KV pages quantize per token row: one fp32 scale per ``(..., K)`` row,
reduced over the head dim the attention dot contracts, so the paged decode
kernel dequantizes exactly by scaling each score column and each
probability.  A page's rows are written one decode step at a time, so a
scale per page would depend on future tokens; per-row scales in
page-shaped ``(n_pages, P, K)`` fp32 pools stay exact under incremental
writes.

The per-tensor helpers at the bottom are the codec of the gradient
compressor (``optim.compress``).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Tuple

import torch

_EPS = 1e-12

# dtype name -> (torch dtype, symmetric max representable value)
_QDTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
    "float8_e4m3fn": (torch.float8_e4m3fn, 448.0),
}

_OFF = contextvars.ContextVar("quant_forced_off", default=False)


def enabled() -> bool:
    """False under ``REPRO_KERNEL_QUANT=off`` or inside :func:`disabled`:
    the sidecars are then ignored."""
    return (not _OFF.get()
            and os.environ.get("REPRO_KERNEL_QUANT", "").lower() != "off")


@contextlib.contextmanager
def disabled(off: bool = True):
    """Ignore the sidecars for the calls inside the block (``off=False``
    changes nothing).  The override holds for the calling context only,
    so an engine's ``quant`` demotion reaches no other engine or trainer
    in the process."""
    token = _OFF.set(bool(off) or _OFF.get())
    try:
        yield
    finally:
        _OFF.reset(token)


def supports_fp8() -> bool:
    """Does this torch build ship ``float8_e4m3fn``?  (Every torch the port
    runs on does: the fp8 payloads need it.)"""
    return hasattr(torch, "float8_e4m3fn")


def resolve_dtype(name: str) -> Tuple[torch.dtype, float]:
    """``(torch dtype, qmax)`` for a quantization dtype name."""
    if name not in _QDTYPES:
        raise ValueError(f"unknown quantization dtype {name!r} "
                         f"(know {sorted(_QDTYPES)})")
    return _QDTYPES[name]


def quant_symmetric(g: torch.Tensor, axis=None, dtype: str = "int8"):
    """``scale = max|g| / qmax + eps`` reduced over ``axis`` (None: one
    scalar), ``q = round(g / scale)`` (half to even, as ``jnp.round``)
    clipped to +-qmax and cast (fp8: the integer is then rounded to e4m3,
    as the reference's cast does).  Returns ``(q, scale)`` with the
    reduced axis squeezed out of ``scale``."""
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


# -- DYAD weight sidecars -----------------------------------------------------


def quantize_dyad_weight(w: torch.Tensor, dtype: str = "int8"):
    """One DYAD component ``(n, d_out, d_in)`` (or a layer-stacked
    ``(n_layers, n, d_out, d_in)``) -> ``(q, scales)`` with one scale per
    (block, out_row), reduced over the contracted ``d_in``."""
    if w.dim() not in (3, 4):
        raise ValueError(f"expected a [stacked] (n, d_out, d_in) DYAD "
                         f"tensor, got shape {tuple(w.shape)}")
    return quant_symmetric(w, axis=-1, dtype=dtype)


def _is_dyad_module(node) -> bool:
    return (isinstance(node, dict) and "w1" in node and "w2" in node
            and getattr(node["w1"], "dim", lambda: 0)() in (3, 4))


@torch.no_grad()
def quantize_params(params, dtype: str = "int8"):
    """Walk the param tree (dicts, and ``layers`` as a list of per-layer
    dicts) and add the sidecars ``w1_q``/``w1_s``/``w2_q``/``w2_s`` beside
    every DYAD module's retained ``w1``/``w2``.  Returns a new tree; the
    tensors it shares with ``params`` are not copied."""
    resolve_dtype(dtype)       # validate before touching the tree

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(v) for k, v in node.items()}
            if _is_dyad_module(node):
                for nm in ("w1", "w2"):
                    out[nm + "_q"], out[nm + "_s"] = quantize_dyad_weight(
                        node[nm], dtype)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def module_quantized(params) -> bool:
    """Does this DYAD module dict carry the full sidecar set?"""
    return (isinstance(params, dict)
            and all(k in params for k in ("w1_q", "w1_s", "w2_q", "w2_s")))


def ff_quantized(params) -> bool:
    """Does an ff module tree (``up``/``down`` and maybe ``gate``) carry
    sidecars on every projection?"""
    if not isinstance(params, dict):
        return False
    names = [n for n in ("gate", "up", "down") if n in params]
    return (len(names) >= 2
            and all(module_quantized(params[n]) for n in names))


# -- KV page quantization -----------------------------------------------------


def quantize_kv_rows(x: torch.Tensor, dtype: str = "int8"):
    """K/V token rows ``(..., K, h)`` -> ``(q, scales (..., K) fp32)``,
    one scale per row over the head dim."""
    return quant_symmetric(x, axis=-1, dtype=dtype)


# -- per-tensor codec (the gradient compressor's) -----------------------------


def quant_int8(g: torch.Tensor):
    """Per-tensor symmetric int8: ``scale = max|g| / 127 + eps``."""
    return quant_symmetric(g, axis=None, dtype="int8")


def dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
