"""Kernel routing for the layers (port of ``repro.kernels.ops``).

* :func:`dyad_mm` — one DYAD linear without bias, a
  ``torch.autograd.Function``.  Forward: the IT variant runs
  ``dyad_mm_blocks`` (one accumulator: both components share the output
  layout); OT and DT run ``dyad_mm_blocks_two`` and ``ref.combine``.
  Backward, saving ``(x, w1, w2)``, three routes:

  - ``kernel`` (the default on CUDA): dx from ``dyad_mm_dgrad`` for OT
    (one accumulator) and from ``dyad_mm_dgrad_two`` plus ``ref.unview``
    for IT and DT; dw from ``dyad_mm_wgrad`` with the param dtype;
  - ``plain`` (the default on the CPU): :func:`_bwd_direct`, the
    reference's direct-layout lowering with fp32 sums;
  - ``use_kernel_bwd=False`` (spec token ``einsumbwd``): the einsum VJP
    oracle ``ref.dyad_mm_bwd_ref``, on either device.

* :func:`dyad_ff` — the whole bias-free ff module (up and gate IT, the
  activation, down OT) as one ``torch.autograd.Function``.  Forward
  (:func:`ff_route`): ``fused`` runs the ``dyad_ff_fused`` megakernel,
  ``split`` runs ``dyad_mm_blocks`` for up (and gate), the activation in
  torch, and ``dyad_mm_blocks_two``.  Backward, with the same three
  routes: ``kernel`` (:func:`_ff_bwd_kernel`: the hidden rematerialised
  with ``dyad_mm_blocks``, then ``dyad_mm_wgrad`` and ``dyad_mm_dgrad``
  for the down projection, the activation's VJP in torch, then
  ``dyad_mm_wgrad`` and ``dyad_mm_dgrad_two`` for up and gate);
  ``plain`` (:func:`_ff_bwd_direct`); the oracle (autograd of
  ``ref.dyad_ff_ref``).

* :func:`flash_attention` — the flash forward kernel with its backward,
  ``flash_prefill_grads`` on CUDA, the same dataflow in plain torch on the
  CPU, autograd of ``ref.sdpa_ref`` for ``use_kernel_bwd=False``.
* :func:`dyad_mm_quant` and :func:`dyad_ff_quant` — forward-only DYAD
  linear and ff over the quantized weight sidecars (``w*_q``/``w*_s`` from
  ``repro_torch.quant.quantize_params``): ``dyad_mm_blocks_q`` (IT) or
  ``dyad_mm_blocks_two_q`` and ``ref.combine`` (OT/DT); the ff on the
  route of :func:`ff_route`, ``fused`` through ``dyad_ff_fused_q``,
  ``split`` through ``dyad_mm_blocks_q`` for up (and gate), the activation
  in torch and ``dyad_mm_blocks_two_q`` for down.  The quantized weights
  are a frozen snapshot, so these are plain functions, not autograd ones,
  and they never read the retained fp weights or cast a payload.
* :func:`attn_route` — ``flash`` (the CUDA flash kernels) on CUDA, ``xla``
  (the plain torch attention of ``layers.attention``) on the CPU.
* :func:`flash_decode` — the ring-cache decode kernel (inference only).
* :func:`flash_decode_paged` — the paged-cache decode kernel, fp and int8
  pools (inference only).

Environment switches, with the reference's names and values:

* ``REPRO_KERNEL_ATTN=flash|xla`` forces the attention route;
* ``REPRO_KERNEL_FF=fused|split`` forces the ff forward route
  (:func:`force_ff_route` overrides it within one context);
* ``REPRO_KERNEL_BWD=pallas|xla`` forces the backward route of both ops.
  On the card ``pallas`` means the hand-written CUDA backward kernels (the
  default there) and ``xla`` the plain torch lowering; forcing ``pallas``
  for CPU tensors raises.  There is no silent fallback: a kernel that
  fails to build or launch raises.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attn, ref
from repro_torch.kernels.dyad_mm import (dyad_ff_fused, dyad_ff_fused_q,
                                         dyad_mm_blocks, dyad_mm_blocks_q,
                                         dyad_mm_blocks_two,
                                         dyad_mm_blocks_two_q, dyad_mm_dgrad,
                                         dyad_mm_dgrad_two, dyad_mm_wgrad)


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
    w1c = w1.to(x.dtype).contiguous()
    w2c = w2.to(x.dtype).contiguous()
    x2d = x.reshape(-1, x.shape[-1])
    if variant == "it":
        # IT: both components share the block-contiguous output layout, so
        # one accumulator holds the sum; the stride-n view is read in-kernel
        y = dyad_mm_blocks(x2d, w1c, w2c, variant)
    else:
        # OT/DT: component 2 lands in the strided output layout; the
        # kernel emits both products and combine re-views and adds
        x1, x2 = ref.block_views(x2d, n, variant)
        y = ref.combine(*dyad_mm_blocks_two(x1, x2, w1c, w2c), variant)
    return y.reshape(*lead, n * d_out)


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
        x1, x2 = ref.block_views(x2d, n, variant)
        z1bar, z2bar = ref.split_cotangent(g2d, n, variant)
        w1c, w2c = w1c.contiguous(), w2c.contiguous()
        if variant == "ot":
            # both dx components are block-contiguous: one accumulator
            dx = dyad_mm_dgrad(z1bar, z2bar, w1c, w2c)
        else:
            # IT/DT: dx2 lives in the permuted layout; emitted apart
            dx = ref.unview(*dyad_mm_dgrad_two(z1bar, z2bar, w1c, w2c),
                            variant)
        dw1, dw2 = dyad_mm_wgrad(x1, x2, z1bar, z2bar, out_dtype=w1.dtype)
        return (dx.reshape(*lead, f_in).to(x.dtype), dw1, dw2.to(w2.dtype),
                None, None)


def dyad_mm(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
            variant: str = "it", use_kernel_bwd: bool = True) -> torch.Tensor:
    """Fused DYAD matmul: (..., f_in) -> (..., f_out), no bias.
    ``use_kernel_bwd=False`` swaps the backward to the einsum VJP oracle."""
    return _DyadMM.apply(x, w1, w2, variant, use_kernel_bwd)


# -- the ff megakernel op --------------------------------------------------------


_FF_FORCED = contextvars.ContextVar("ff_route_forced", default=None)


def ff_route() -> str:
    """Which forward route ``dyad_ff`` takes: ``fused`` (the default, the
    one-kernel megakernel) or ``split`` (up and gate through
    ``dyad_mm_blocks``, the activation in torch, down through
    ``dyad_mm_blocks_two``: the hidden goes through device memory).
    ``REPRO_KERNEL_FF=fused|split`` forces either; :func:`force_ff_route`
    overrides both for the calls inside it."""
    forced = _FF_FORCED.get() or os.environ.get("REPRO_KERNEL_FF",
                                                "").lower()
    return forced if forced in ("fused", "split") else "fused"


@contextlib.contextmanager
def force_ff_route(route: Optional[str]):
    """Run the block's ``dyad_ff`` calls on ``route`` (``fused`` or
    ``split``; None changes nothing).  The override holds for the calling
    context only, so a continuous engine's ff demotion reaches no other
    engine or trainer in the process."""
    token = _FF_FORCED.set(route or _FF_FORCED.get())
    try:
        yield
    finally:
        _FF_FORCED.reset(token)


def _ff_weights(ws, act: str):
    """(wg, wu, wd) pairs from the flat weight tuple; wg None ungated."""
    if act == "swiglu":
        return ws[0:2], ws[2:4], ws[4:6]
    return None, ws[0:2], ws[2:4]


def _cast(pair, dt):
    return tuple(w.to(dt).contiguous() for w in pair)


def _ff_act_fwd(act: str, g_pre, u_pre):
    """(h, vjp) of the activation epilogue on the block-layout pre-
    activations; ``vjp(dh)`` returns ``(dg_pre, du_pre)`` gated, else
    ``(du_pre,)``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in ((g_pre, u_pre) if act == "swiglu" else (u_pre,))]
        h = (F.silu(leaves[0]) * leaves[1] if act == "swiglu"
             else ref.ACTS[act](leaves[0]))

    def vjp(dh):
        return torch.autograd.grad(h, leaves, dh)

    return h.detach(), vjp


def _ff_forward(x, wg, wu, wd, act: str):
    """The ff forward on the route of :func:`ff_route`: (..., f_in) ->
    (..., f_out)."""
    n = wu[0].shape[0]
    d_out = wd[0].shape[1]
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    dt = x.dtype
    if ff_route() == "fused":
        # the weights go in as they are: for bf16 x the kernel rounds fp32
        # weights to bf16 as it loads them (a cast here would copy each)
        x1, x2 = ref.block_views(x2d, n, "it")
        z1, z2 = dyad_ff_fused(x1, x2, *wu, *wd, *(wg or (None, None)),
                               act=act)
    else:
        u = dyad_mm_blocks(x2d, *_cast(wu, dt), "it")
        if wg is not None:
            h = F.silu(dyad_mm_blocks(x2d, *_cast(wg, dt), "it")) * u
        else:
            h = ref.ACTS[act](u)
        z1, z2 = dyad_mm_blocks_two(h, h, *_cast(wd, dt))
    return ref.combine(z1, z2, "ot").reshape(*lead, n * d_out)


def _ff_bwd_kernel(x, wg, wu, wd, g, act: str):
    """The kernel backward: the hidden rematerialised, then the fused
    dgrad/wgrad kernels (the reference's ``ops._ff_bwd_kernel``).  Returns
    (dx, *dwg, dwu1, dwu2, dwd1, dwd2)."""
    n = wu[0].shape[0]
    lead, f_in = x.shape[:-1], x.shape[-1]
    dt = x.dtype
    x2d = x.reshape(-1, f_in)
    g2d = g.reshape(-1, g.shape[-1]).to(dt)
    x1, x2 = ref.block_views(x2d, n, "it")
    wu1, wu2 = _cast(wu, dt)
    wd1, wd2 = _cast(wd, dt)

    u_pre = dyad_mm_blocks(x2d, wu1, wu2, "it")
    if wg is not None:
        wg1, wg2 = _cast(wg, dt)
        h, act_vjp = _ff_act_fwd(act, dyad_mm_blocks(x2d, wg1, wg2, "it"),
                                 u_pre)
    else:
        h, act_vjp = _ff_act_fwd(act, None, u_pre)

    z1bar, z2bar = ref.split_cotangent(g2d, n, "ot")
    dwd1, dwd2 = dyad_mm_wgrad(h, h, z1bar, z2bar, out_dtype=wd[0].dtype)
    # OT down: both dh components share the block layout, one accumulator
    dh = dyad_mm_dgrad(z1bar, z2bar, wd1, wd2)
    pre_grads = [t.to(dt) for t in act_vjp(dh)]
    du_pre = pre_grads[-1]

    dwu1, dwu2 = dyad_mm_wgrad(x1, x2, du_pre, du_pre,
                               out_dtype=wu[0].dtype)
    dx = ref.unview(*dyad_mm_dgrad_two(du_pre, du_pre, wu1, wu2), "it")
    dgs = ()
    if wg is not None:
        dg_pre = pre_grads[0]
        dwg1, dwg2 = dyad_mm_wgrad(x1, x2, dg_pre, dg_pre,
                                   out_dtype=wg[0].dtype)
        dx = dx + ref.unview(*dyad_mm_dgrad_two(dg_pre, dg_pre, wg1, wg2),
                             "it")
        dgs = (dwg1, dwg2.to(wg[1].dtype))
    return (dx.reshape(*lead, f_in).to(x.dtype), *dgs, dwu1,
            dwu2.to(wu[1].dtype), dwd1, dwd2.to(wd[1].dtype))


def _ff_bwd_direct(x, wg, wu, wd, g, act: str):
    """The reference's non-TPU lowering of the megakernel backward
    (``ops._ff_bwd_direct``): direct-layout contractions with fp32 sums
    (the BLOCKTRANS operands read through the free ``(B, d, n)``
    reshapes, component 2's dx produced in the permuted layout) and the
    hidden rematerialised in x's dtype."""
    n, _, d_in = wu[0].shape
    d_out = wd[0].shape[1]
    lead, f_in = x.shape[:-1], x.shape[-1]
    dt = x.dtype
    f = torch.promote_types(dt, torch.float32)   # fp64 stays fp64
    x2d = x.reshape(-1, f_in)
    B = x2d.shape[0]
    g2d = g.reshape(-1, g.shape[-1]).to(dt)
    x1 = x2d.reshape(B, n, d_in).to(f)
    xr = x2d.reshape(B, d_in, n).to(f)         # x2[b,g,k] == xr[b,k,g]
    z1 = g2d.reshape(B, n, d_out).to(f)
    gr = g2d.reshape(B, d_out, n).to(f)        # z2bar[b,g,o] == gr[b,o,g]

    def wf(pair):
        return tuple(w.to(dt).to(f) for w in pair)

    wu1, wu2 = wf(wu)
    wd1, wd2 = wf(wd)

    def up(w1, w2):
        return (torch.einsum("bgk,gjk->bgj", x1, w1)
                + torch.einsum("bkg,gjk->bgj", xr, w2)).to(dt)

    u_pre = up(wu1, wu2)
    if wg is not None:
        wg1, wg2 = wf(wg)
        h, act_vjp = _ff_act_fwd(act, up(wg1, wg2), u_pre)
    else:
        h, act_vjp = _ff_act_fwd(act, None, u_pre)
    hf = h.to(f)
    dwd1 = torch.einsum("bgj,bgo->goj", hf, z1)
    dwd2 = torch.einsum("bgj,bog->goj", hf, gr)
    dh = (torch.einsum("bgo,goj->bgj", z1, wd1)
          + torch.einsum("bog,goj->bgj", gr, wd2)).to(dt)
    pre_grads = act_vjp(dh)

    def in_grads(du, w1, w2):
        du = du.to(f)
        dw1 = torch.einsum("bgk,bgj->gjk", x1, du)
        dw2 = torch.einsum("bkg,bgj->gjk", xr, du)
        # component 2's dx is produced in the permuted layout (bkg)
        dx = (torch.einsum("bgj,gjk->bgk", du, w1).reshape(B, f_in)
              + torch.einsum("bgj,gjk->bkg", du, w2).reshape(B, f_in))
        return dw1, dw2, dx

    dwu1, dwu2, dx = in_grads(pre_grads[-1], wu1, wu2)
    dgs = ()
    if wg is not None:
        dwg1, dwg2, dxg = in_grads(pre_grads[0], wg1, wg2)
        dx = dx + dxg
        dgs = (dwg1.to(wg[0].dtype), dwg2.to(wg[1].dtype))
    return (dx.reshape(*lead, f_in).to(x.dtype), *dgs,
            dwu1.to(wu[0].dtype), dwu2.to(wu[1].dtype),
            dwd1.to(wd[0].dtype), dwd2.to(wd[1].dtype))


def _ff_bwd_oracle(x, ws, g, act: str):
    """Autograd of the einsum oracle ``ref.dyad_ff_ref``: (dx, *dws) in the
    order of ``ws``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, *ws)]
        wg, wu, wd = _ff_weights(leaves[1:], act)
        gs = wg if wg is not None else (None, None)
        y = ref.dyad_ff_ref(leaves[0], *wu, *wd, *gs, act=act)
        return torch.autograd.grad(y, leaves, g)


class _DyadFF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, act, use_kernel_bwd, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.act, ctx.use_kernel_bwd = act, use_kernel_bwd
        return _ff_forward(x, *_ff_weights(ws, act), act)

    @staticmethod
    def backward(ctx, g):
        x, *ws = ctx.saved_tensors
        act = ctx.act
        g = g.contiguous()
        if not ctx.use_kernel_bwd:
            grads = _ff_bwd_oracle(x, ws, g, act)
        else:
            route = (_ff_bwd_kernel if bwd_route(x.device) == "kernel"
                     else _ff_bwd_direct)
            grads = route(x, *_ff_weights(ws, act), g, act)
        return (grads[0], None, None, *grads[1:])


def dyad_ff(params, x, *, act: str = "gelu", use_kernel_bwd: bool = True):
    """The whole bias-free DYAD ff module as one differentiable op.

    ``params`` is the ``layers.mlp`` param dict: ``{"up", "down"}`` (and
    ``"gate"`` for ``act="swiglu"``), each holding DYAD ``w1``/``w2``.
    ``use_kernel_bwd=False`` swaps the backward to autograd of the einsum
    oracle ``ref.dyad_ff_ref``."""
    names = (("gate", "up", "down") if act == "swiglu" else ("up", "down"))
    ws = [params[k][w] for k in names for w in ("w1", "w2")]
    return _DyadFF.apply(x, act, use_kernel_bwd, *ws)


# -- the quantized forward routes ------------------------------------------------


def dyad_mm_quant(x, w1q, w2q, s1, s2, *, variant: str = "it"):
    """Forward-only :func:`dyad_mm` over quantized weights: (..., n * d_in)
    -> (..., n * d_out).  w1q, w2q: (n, d_out, d_in) int8/fp8 payloads;
    s1, s2: (n, d_out) fp32 scales."""
    n, d_out, _ = w1q.shape
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    x1, x2 = ref.block_views(x2d, n, variant)
    if variant == "it":
        y = dyad_mm_blocks_q(x1, x2, w1q, w2q, s1, s2)
    else:
        y = ref.combine(*dyad_mm_blocks_two_q(x1, x2, w1q, w2q, s1, s2),
                        variant)
    return y.reshape(*lead, n * d_out)


def dyad_ff_quant(params, x, *, act: str = "gelu"):
    """Forward-only :func:`dyad_ff` over quantized weights.  ``params`` is
    the ``layers.mlp`` param dict after ``quant.quantize_params`` (every
    projection carries ``w1_q``/``w1_s``/``w2_q``/``w2_s``)."""
    up, down = params["up"], params["down"]
    n = up["w1_q"].shape[0]
    d_out = down["w1_q"].shape[1]
    lead = x.shape[:-1]
    x1, x2 = ref.block_views(x.reshape(-1, x.shape[-1]), n, "it")

    def q(p):
        return p["w1_q"], p["w2_q"], p["w1_s"], p["w2_s"]

    gate = params["gate"] if act == "swiglu" else None
    if ff_route() == "fused":
        gate_kw = {}
        if gate is not None:
            wg1, wg2, sg1, sg2 = q(gate)
            gate_kw = dict(wg1=wg1, wg2=wg2, sg1=sg1, sg2=sg2)
        wu1, wu2, su1, su2 = q(up)
        wd1, wd2, sd1, sd2 = q(down)
        z1, z2 = dyad_ff_fused_q(x1, x2, wu1, wu2, wd1, wd2, su1, su2, sd1,
                                 sd2, act=act, **gate_kw)
    else:
        u = dyad_mm_blocks_q(x1, x2, *q(up))
        if gate is not None:
            h = F.silu(dyad_mm_blocks_q(x1, x2, *q(gate))) * u
        else:
            h = ref.ACTS[act](u)
        z1, z2 = dyad_mm_blocks_two_q(h, h, *q(down))
    return ref.combine(z1, z2, "ot").reshape(*lead, n * d_out)


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


def flash_decode_paged(q, pages_k, pages_v, block_table, idx, *,
                       l_real=None, window=None, scales_k=None,
                       scales_v=None):
    """One-token paged-cache decode attention (inference only)."""
    return flash_attn.flash_decode_paged(
        q, pages_k, pages_v, block_table, idx, l_real=l_real, window=window,
        scales_k=scales_k, scales_v=scales_v)
