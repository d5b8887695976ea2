"""Mixture-of-Experts ff module: top-k routed experts plus shared experts
(port of ``repro.layers.moe``).

Dispatch is GShard-style with the batch rows as capacity groups: each
row's tokens fill at most ``capacity = max(1, int(Sc * top_k *
capacity_factor / n_experts))`` slots of each expert per chunk of ``Sc``
tokens, and the tokens past it are dropped.  A token's k slots are
ordered by a cumulative count over the ``(s, k)`` row-major flattening,
so slot j of token s sees the counts of every earlier token and of its
own slots before j.  Experts are padded to ``e_pad`` (the router's
rows): the padded ones get a ``-1e30`` logit in fp32 and never receive a
token.  Top-k ties go to the lower expert index, as ``jax.lax.top_k``
breaks them.

The routed experts run as plain products with an explicit expert axis;
DYAD experts always take the mixed form (up and gate IT in the block
layout, down OT), whatever ``lin_cfg.variant`` says.  The shared expert
is an ordinary ff module (``layers.mlp.apply_mlp``), so it takes the
config's ff route (the megakernel with ``fuse_ff_kernel``), gated by a
sigmoid over fp32.

Not ported: the reference's sharding constraints on the expert axis
wait for tensor parallelism (ROADMAP A.11).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import factory, linear
from repro_torch.kernels.ref import ACTS
from repro_torch.layers import mlp as mlp_lib


def init_moe(generator, d_model: int, expert_d_ff: int, n_experts: int,
             top_k: int, lin_cfg: factory.LinearCfg, *, n_shared: int = 0,
             shared_d_ff: Optional[int] = None, act: str = "swiglu",
             n_experts_padded: Optional[int] = None, dtype=torch.float32,
             device=None):
    """The routed experts' params stacked on a leading expert axis (one ff
    module's tree, each leaf ``(e_pad, ...)``), the router, and with
    ``n_shared`` the shared expert and its gate."""
    e_pad = n_experts_padded or n_experts
    experts = [mlp_lib.init_mlp(generator, d_model, expert_d_ff, lin_cfg,
                                act=act, dtype=dtype, device=device)
               for _ in range(e_pad)]
    p = {
        "router": linear.init(generator, d_model, e_pad, bias=False,
                              dtype=dtype, device=device),
        "experts": {name: {k: torch.stack([e[name][k] for e in experts])
                           for k in experts[0][name]}
                    for name in experts[0]},
    }
    if n_shared:
        p["shared"] = mlp_lib.init_mlp(
            generator, d_model, shared_d_ff or n_shared * expert_d_ff,
            lin_cfg, act=act, dtype=dtype, device=device)
        p["shared_gate"] = linear.init(generator, d_model, 1, bias=False,
                                       dtype=dtype, device=device)
    return p


def _route(params, x, n_experts: int, top_k: int):
    """x: (..., D) -> (weights, idx, probs): the top-k experts' weights,
    renormalised over the k, their indices and the router's fp32
    probabilities over every (padded) expert."""
    e_pad = params["router"]["w"].shape[0]
    logits = linear.apply(params["router"], x.float())
    if e_pad > n_experts:
        pad = torch.arange(e_pad, device=x.device) >= n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower index first among equals
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :top_k], idx[..., :top_k]
    weights = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, idx, probs


def _dispatch_combine(xc, weights, idx, e_pad: int, capacity: int):
    """One chunk: xc (B, Sc, D) -> (expert_in (B, E, C, D), combine
    (B, Sc, E, C))."""
    B = xc.shape[0]
    oh = F.one_hot(idx, e_pad).float()                      # (B,Sc,k,E)
    # slot j of token s sees the counts of the slots before it, in the
    # (s, k) row-major order
    pos = oh.reshape(B, -1, e_pad).cumsum(1).reshape(oh.shape) - oh
    pos = (pos * oh).sum(-1)                                # (B,Sc,k)
    w = weights * (pos < capacity)                          # dropped -> 0
    cap_oh = (pos[..., None] == torch.arange(
        capacity, device=xc.device)).float()                # (B,Sc,k,C)
    combine = torch.einsum("bske,bskc->bsec", w[..., None] * oh, cap_oh)
    dispatch = (combine > 0).to(xc.dtype)
    expert_in = torch.einsum("bsec,bsd->becd", dispatch, xc)
    return expert_in, combine.to(xc.dtype)


def _dyad_up(p, x):
    """IT up (or gate) over every expert at once, in the block layout:
    x (B, E, C, n * d_in) -> (B, E, C, n, d_out)."""
    n, _, d_in = p["w1"].shape[1:]
    lead = x.shape[:-1]
    x1 = x.reshape(*lead, n, d_in)
    x2 = x.reshape(*lead, d_in, n).transpose(-1, -2)
    return (torch.einsum("becgi,egoi->becgo", x1, p["w1"].to(x.dtype))
            + torch.einsum("becgi,egoi->becgo", x2, p["w2"].to(x.dtype)))


def _expert_ffn(experts, x, act: str):
    """Every expert's ff with the expert axis explicit.  x: (B, E, C, D)."""
    up = experts["up"]
    if "w1" in up:                                   # DYAD experts
        if act == "swiglu":
            h = F.silu(_dyad_up(experts["gate"], x)) * _dyad_up(up, x)
        else:
            h = ACTS[act](_dyad_up(up, x))
        dn = experts["down"]
        z1 = torch.einsum("becgi,egoi->becgo", h, dn["w1"].to(x.dtype))
        z2 = torch.einsum("becgi,egoi->becgo", h, dn["w2"].to(x.dtype))
        nd, d2 = z1.shape[-2:]
        return (z1.reshape(*z1.shape[:-2], nd * d2)
                + z2.transpose(-1, -2).reshape(*z2.shape[:-2], nd * d2))
    # dense experts: (E, f_out, f_in) weights
    if act == "swiglu":
        g = torch.einsum("becd,efd->becf", x,
                         experts["gate"]["w"].to(x.dtype))
        u = torch.einsum("becd,efd->becf", x, up["w"].to(x.dtype))
        h = F.silu(g) * u
    else:
        h = ACTS[act](torch.einsum("becd,efd->becf", x,
                                   up["w"].to(x.dtype)))
    return torch.einsum("becf,edf->becd", h,
                        experts["down"]["w"].to(x.dtype))


def apply_moe(params, x, lin_cfg: factory.LinearCfg, *, n_experts: int,
              top_k: int, capacity_factor: float = 1.25, act: str = "swiglu",
              chunk: Optional[int] = None):
    """x: (B, S, D) -> (y, aux): aux is the Switch load-balance term
    ``n_experts * sum_e f_e p_e / top_k`` in fp32."""
    B, S, D = x.shape
    e_pad = params["router"]["w"].shape[0]
    weights, idx, probs = _route(params, x, n_experts, top_k)
    me = probs.mean(dim=(0, 1))
    fe = F.one_hot(idx, e_pad).float().sum(-2).mean(dim=(0, 1))
    aux = n_experts * (me * fe).sum() / top_k

    Sc = min(chunk or S, S)
    if S % Sc:
        raise ValueError(f"seq {S} must divide moe chunk {Sc}")
    capacity = max(1, int(Sc * top_k * capacity_factor / n_experts))

    def run_chunk(xc, wc, ic):
        expert_in, combine = _dispatch_combine(xc, wc, ic, e_pad, capacity)
        eo = _expert_ffn(params["experts"], expert_in, act)
        return torch.einsum("bsec,becd->bsd", combine, eo)

    if Sc == S:
        y = run_chunk(x, weights, idx)
    else:
        # the reference's scan over the chunks
        y = torch.cat([run_chunk(x[:, s:s + Sc], weights[:, s:s + Sc],
                                 idx[:, s:s + Sc]) for s in range(0, S, Sc)],
                      dim=1)
    if "shared" in params:
        g = torch.sigmoid(linear.apply(params["shared_gate"], x.float()))
        y = y + g.to(x.dtype) * mlp_lib.apply_mlp(params["shared"], x,
                                                  lin_cfg, act=act)
    return y, aux
