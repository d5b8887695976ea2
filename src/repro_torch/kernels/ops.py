"""Kernel routing for the layers (port of ``repro.kernels.ops``).

* :func:`dyad_mm` — one DYAD linear without bias, forward only.  The IT
  variant runs the hand-written ``dyad_mm_blocks`` kernel on CUDA; the
  OT/DT forward kernel (``dyad_mm_blocks_two``, ROADMAP B.6) and the
  backward (``torch.autograd.Function`` over the dgrad/wgrad kernels,
  ROADMAP A.6) are not ported yet and raise on CUDA.
* :func:`attn_route` — ``flash`` (the CUDA flash kernels) on CUDA, ``xla``
  (the plain torch attention of ``layers.attention``) on the CPU;
  ``REPRO_KERNEL_ATTN=flash|xla`` forces either, as in the reference.
* :func:`flash_attention` / :func:`flash_decode` — the flash kernels.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import flash_attn, ref
from repro_torch.kernels.dyad_mm import dyad_mm_blocks


def _forward_only(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the backward kernels are not ported yet (ROADMAP A.6); "
            "run under torch.no_grad()")


def dyad_mm(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
            variant: str = "it") -> torch.Tensor:
    """Fused DYAD matmul: (..., f_in) -> (..., f_out), no bias."""
    n, d_out, _ = w1.shape
    lead = x.shape[:-1]
    w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
    if x.device.type == "cuda":
        _forward_only("dyad_mm", x, w1, w2)
        if variant != "it":
            raise NotImplementedError(
                f"dyad_mm: the {variant!r} forward kernel "
                "(dyad_mm_blocks_two) is not ported yet (ROADMAP B.6)")
    if variant != "it":
        return ref.dyad_mm_ref(x, w1c, w2c, variant=variant)
    # IT: both components share the block-contiguous output layout, so
    # one accumulator holds the sum; the stride-n view is read in-kernel.
    x2d = x.reshape(-1, x.shape[-1])
    z = dyad_mm_blocks(x2d, w1c.contiguous(), w2c.contiguous(), variant)
    return z.reshape(*lead, n * d_out)


def attn_route(device: torch.device) -> str:
    """Which route attention takes when the config opts into flash
    (``cfg.flash_attn``) for tensors on ``device``."""
    forced = os.environ.get("REPRO_KERNEL_ATTN", "").lower()
    if forced in ("flash", "xla"):
        return forced
    return "flash" if device.type == "cuda" else "xla"


def flash_attention(q, k, v, q_off=0, k_off=0, *, causal: bool = True,
                    window=None):
    """Flash attention forward: (B,S,K,G,h) x (B,T,K,h) -> (B,S,K,G,h)."""
    if q.device.type == "cuda":
        _forward_only("flash_attention", q, k, v)
    out, _ = flash_attn.flash_prefill(q, k, v, q_off, k_off, causal=causal,
                                      window=window)
    return out


def flash_decode(q, k, v, idx, *, window=None):
    """One-token ring-cache decode attention (inference only)."""
    return flash_attn.flash_decode(q, k, v, idx, window=window)
