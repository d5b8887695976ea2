"""Kernel routing for the layers (port of ``repro.kernels.ops``).

* :func:`dyad_mm` — one DYAD linear without bias, a
  ``torch.autograd.Function``.  Forward: the IT variant runs the
  hand-written ``dyad_mm_blocks`` kernel on CUDA; the OT/DT forward kernel
  (``dyad_mm_blocks_two``, ROADMAP B.6) is not ported yet and raises on
  CUDA.  Backward, saving ``(x, w1, w2)``, three routes:

  - ``kernel`` (the default on CUDA): ``dyad_mm_dgrad_two`` plus
    ``ref.unview`` for dx, ``dyad_mm_wgrad`` with the param dtype for dw;
  - ``plain`` (the default on the CPU): :func:`_bwd_direct`, the
    reference's direct-layout lowering with fp32 sums;
  - ``use_kernel_bwd=False`` (spec token ``einsumbwd``): the einsum VJP
    oracle ``ref.dyad_mm_bwd_ref``, on either device.

* :func:`flash_attention` — the flash forward kernel with its backward,
  ``flash_prefill_grads`` on CUDA, the same dataflow in plain torch on the
  CPU, autograd of ``ref.sdpa_ref`` for ``use_kernel_bwd=False``.
* :func:`attn_route` — ``flash`` (the CUDA flash kernels) on CUDA, ``xla``
  (the plain torch attention of ``layers.attention``) on the CPU.
* :func:`flash_decode` — the decode kernel (inference only).

Environment switches, with the reference's names and values:

* ``REPRO_KERNEL_ATTN=flash|xla`` forces the attention route;
* ``REPRO_KERNEL_BWD=pallas|xla`` forces the backward route of both ops.
  On the card ``pallas`` means the hand-written CUDA backward kernels (the
  default there) and ``xla`` the plain torch lowering; forcing ``pallas``
  for CPU tensors raises.  There is no silent fallback: a kernel that
  fails to build or launch raises.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import flash_attn, ref
from repro_torch.kernels.dyad_mm import (dyad_mm_blocks, dyad_mm_dgrad_two,
                                         dyad_mm_wgrad)


def bwd_route(device: torch.device) -> str:
    """``kernel`` or ``plain``: which backward the ops take for tensors on
    ``device`` (``REPRO_KERNEL_BWD=pallas|xla`` forces either)."""
    forced = os.environ.get("REPRO_KERNEL_BWD", "").lower()
    if forced == "pallas":
        if device.type != "cuda":
            raise RuntimeError(
                f"REPRO_KERNEL_BWD=pallas forces the CUDA backward kernels, "
                f"but the tensors are on {device}")
        return "kernel"
    if forced == "xla":
        return "plain"
    return "kernel" if device.type == "cuda" else "plain"


def _bwd_direct(x2d, w1, w2, g2d, variant: str):
    """The reference's non-TPU lowering of the kernel backward
    (``ops._bwd_direct``): fp32 sums, the BLOCKTRANS operand read through
    the free ``(B, d, n)`` reshape and component 2's dx produced in the
    permuted layout, so no strided view or un-view is materialised."""
    B, f_in = x2d.shape
    n, d_out, d_in = w1.shape
    f = torch.promote_types(x2d.dtype, torch.float32)   # fp64 stays fp64
    x1 = x2d.reshape(B, n, d_in).to(f)
    xr = x2d.reshape(B, d_in, n).to(f)          # x2[b,g,i] == xr[b,i,g]
    z1 = g2d.reshape(B, n, d_out).to(f)
    gr = g2d.reshape(B, d_out, n).to(f)         # z2bar[b,g,o] == gr[b,o,g]
    w1f, w2f = w1.to(f), w2.to(f)

    dw1 = torch.einsum("bgi,bgo->goi", x1, z1)
    dx1 = torch.einsum("bgo,goi->bgi", z1, w1f)
    if variant == "it":
        dw2 = torch.einsum("big,bgo->goi", xr, z1)
        dx2r = torch.einsum("bgo,goi->big", z1, w2f)
        dx = dx1.reshape(B, f_in) + dx2r.reshape(B, f_in)
    elif variant == "ot":
        dw2 = torch.einsum("bgi,bog->goi", x1, gr)
        dx2 = torch.einsum("bog,goi->bgi", gr, w2f)
        dx = (dx1 + dx2).reshape(B, f_in)
    else:  # "dt"
        dw2 = torch.einsum("big,bog->goi", xr, gr)
        dx2r = torch.einsum("bog,goi->big", gr, w2f)
        dx = dx1.reshape(B, f_in) + dx2r.reshape(B, f_in)
    return dx, dw1, dw2


def _dyad_forward(x, w1, w2, variant: str):
    n, d_out, _ = w1.shape
    lead = x.shape[:-1]
    w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
    if x.device.type == "cuda" and variant != "it":
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


class _DyadMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, variant, use_kernel_bwd):
        ctx.save_for_backward(x, w1, w2)
        ctx.variant, ctx.use_kernel_bwd = variant, use_kernel_bwd
        return _dyad_forward(x, w1, w2, variant)

    @staticmethod
    def backward(ctx, g):
        x, w1, w2 = ctx.saved_tensors
        variant = ctx.variant
        # autograd may hand over an expanded (stride-0) or transposed
        # cotangent; the kernels take row-major views of it
        g = g.contiguous()
        if not ctx.use_kernel_bwd:
            dx, dw1, dw2 = ref.dyad_mm_bwd_ref(x, w1, w2, g, variant=variant)
            return dx, dw1, dw2, None, None
        n = w1.shape[0]
        lead, f_in = x.shape[:-1], x.shape[-1]
        x2d = x.reshape(-1, f_in)
        g2d = g.reshape(-1, g.shape[-1]).to(x.dtype)
        w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
        if bwd_route(x.device) == "plain":
            dx, dw1, dw2 = _bwd_direct(x2d, w1c, w2c, g2d, variant)
            return (dx.reshape(*lead, f_in).to(x.dtype), dw1.to(w1.dtype),
                    dw2.to(w2.dtype), None, None)
        # CUDA runs only IT (the OT/DT forward raises), whose dx1 and dx2
        # live in different layouts: dgrad_two emits them apart
        x1, x2 = ref.block_views(x2d, n, variant)
        z1bar, z2bar = ref.split_cotangent(g2d, n, variant)
        dx1, dx2 = dyad_mm_dgrad_two(z1bar, z2bar, w1c.contiguous(),
                                     w2c.contiguous())
        dx = ref.unview(dx1, dx2, variant)
        dw1, dw2 = dyad_mm_wgrad(x1, x2, z1bar, z2bar, out_dtype=w1.dtype)
        return (dx.reshape(*lead, f_in).to(x.dtype), dw1, dw2.to(w2.dtype),
                None, None)


def dyad_mm(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
            variant: str = "it", use_kernel_bwd: bool = True) -> torch.Tensor:
    """Fused DYAD matmul: (..., f_in) -> (..., f_out), no bias.
    ``use_kernel_bwd=False`` swaps the backward to the einsum VJP oracle."""
    return _DyadMM.apply(x, w1, w2, variant, use_kernel_bwd)


def attn_route(device: torch.device) -> str:
    """Which route attention takes when the config opts into flash
    (``cfg.flash_attn``) for tensors on ``device``."""
    forced = os.environ.get("REPRO_KERNEL_ATTN", "").lower()
    if forced in ("flash", "xla"):
        return forced
    return "flash" if device.type == "cuda" else "xla"


def _attn_positions(q_off, k_off, S: int, T: int, device):
    """(qpos, kpos): (S,) / (T,) for scalar offsets, (B, S) / (B, T) for
    per-batch ones, as ``ref.sdpa_ref`` takes them."""
    def pos(off, n):
        off = torch.as_tensor(off, device=device).to(torch.int64)
        return (off[:, None] if off.dim() else off) + torch.arange(
            n, device=device)
    return pos(q_off, S), pos(k_off, T)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, causal, window, use_kernel_bwd):
        out, lse = flash_attn.flash_prefill(q, k, v, q_off, k_off,
                                            causal=causal, window=window,
                                            save_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.offsets = (q_off, k_off)
        ctx.causal, ctx.window = causal, window
        ctx.use_kernel_bwd = use_kernel_bwd
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        q_off, k_off = ctx.offsets
        do = g.contiguous().to(q.dtype)
        kw = dict(causal=ctx.causal, window=ctx.window)
        if not ctx.use_kernel_bwd:
            # einsum-VJP oracle: autograd of the reference forward
            qp, kp = _attn_positions(q_off, k_off, q.shape[1], k.shape[1],
                                     q.device)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                out = ref.sdpa_ref(*leaves, qp, kp, **kw)
                dq, dk, dv = torch.autograd.grad(out, leaves, do)
        elif bwd_route(q.device) == "kernel":
            dq, dk, dv = flash_attn.flash_prefill_grads(
                q, k, v, o, lse, do, q_off, k_off, **kw)
        else:
            dq, dk, dv = flash_attn.flash_prefill_grads_plain(
                q, k, v, o, lse, do, q_off, k_off, **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, q_off=0, k_off=0, *, causal: bool = True,
                    window=None, use_kernel_bwd: bool = True):
    """Flash attention: (B,S,K,G,h) x (B,T,K,h) -> (B,S,K,G,h), queries at
    ``q_off + arange(S)`` and keys at ``k_off + arange(T)`` (scalar or (B,)
    offsets).  ``use_kernel_bwd=False`` swaps the backward to autograd of
    the einsum oracle ``ref.sdpa_ref``.  Without a gradient to take (the
    serving paths) the forward skips the log-sum-exp it would save."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_off, k_off, causal, window,
                                     use_kernel_bwd)
    return flash_attn.flash_prefill(q, k, v, q_off, k_off, causal=causal,
                                    window=window)[0]


def flash_decode(q, k, v, idx, *, window=None):
    """One-token ring-cache decode attention (inference only)."""
    return flash_attn.flash_decode(q, k, v, idx, window=window)
