"""Transformer ff module — the site the paper targets with DYAD (port of
``repro.layers.mlp``).

SwiGLU (gate/up/down) and single-activation (GELU/ReLU/SiLU) variants;
every projection is created through the linear factory with
``site="ff"``.  Three DYAD execution tiers, picked per config:

* plain — each projection through ``factory.apply``;
* ``fuse_mlp`` — the mixed-variant einsum dataflow (up = IT, down = OT,
  the hidden in the block layout ``(..., n, d_ff_b)``);
* ``fuse_ff_kernel`` — the same dataflow as one op (``kernels.ops.dyad_ff``:
  the ``dyad_ff_fused`` megakernel and its backward kernels).  It needs
  ``use_kernel`` and bias-free DYAD params on every projection; a
  ``fuse_ff_kernel`` module that cannot take it drops to the ``fuse_mlp``
  dataflow, the megakernel's own function, not to the all-IT plain chain.
  With ``quant`` and the sidecars of ``quant.quantize_params`` on every
  projection, the forward runs over the quantized weights instead
  (``kernels.ops.dyad_ff_quant``: ``dyad_ff_fused_q``, or the split
  quantized kernels); ``REPRO_KERNEL_QUANT=off`` keeps the fp route.
  Each decision on that route is an ``ff_quant`` route event (``off``,
  ``fp_fallback`` or the payload dtype), and the ``kernel_nan`` fault site
  with route ``ff_quant`` poisons its output.

Not ported: tensor parallelism (A.11) has no sharding context in the
port, so the reference's per-shard branches (and their ``ff_tp`` route
events) have nothing to dispatch on.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import faults, obs
from repro_torch import quant as quant_lib
from repro_torch.core import dyad as dyad_lib
from repro_torch.core import factory
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ACTS

# activations the ff megakernel runs as its epilogue
_FF_KERNEL_ACTS = frozenset({"swiglu", *ACTS})


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


def _ff_module_ok(params, act: str) -> bool:
    """Bias-free DYAD ff params with an epilogue the megakernel runs: the
    module the megakernel (and its einsum twin ``_fused_dyad_mlp``)
    computes."""
    if act not in _FF_KERNEL_ACTS:
        return False
    need = ("gate", "up", "down") if act == "swiglu" else ("up", "down")
    return all("w1" in params.get(k, {}) and "b" not in params[k]
               for k in need)


def _ff_kernel_ready(params, lin_cfg: factory.LinearCfg, act: str) -> bool:
    """Route this ff module through ``kernels.ops.dyad_ff``?  Needs the
    config opt-in (``fuse_ff_kernel`` with ``use_kernel``) and a module
    :func:`_ff_module_ok` accepts."""
    return (lin_cfg.fuse_ff_kernel and lin_cfg.use_kernel
            and _ff_module_ok(params, act))


def _ff_quant_ready(params, lin_cfg: factory.LinearCfg, act: str) -> bool:
    """Route this ff module through the quantized kernels?  Needs the
    ``quant`` opt-in on top of the megakernel's conditions, the quantized
    routes enabled, and the sidecars on every projection: a tree without
    them (the training params) keeps the fp routes.  Each decision past
    the config's opt-in is an ``ff_quant`` route event."""
    if not (lin_cfg.quant and lin_cfg.use_kernel and lin_cfg.fuse_ff_kernel
            and _ff_module_ok(params, act)):
        return False
    if not quant_lib.enabled():
        obs.route_event("ff_quant", "off", forced=True)
        return False
    if not quant_lib.ff_quantized(params):
        obs.route_event("ff_quant", "fp_fallback")
        return False
    obs.route_event("ff_quant", lin_cfg.quant)
    return True


def _fused_dyad_mlp(params, x, lin_cfg: factory.LinearCfg, act: str):
    """Mixed-variant ff as einsums: up = IT returning the block layout,
    down = OT consuming it, so the hidden never takes the flat layout."""
    n = params["up"]["w1"].shape[0]
    spec = dyad_lib.DyadSpec(n_dyad=n, variant="it")
    if act == "swiglu":
        g = dyad_lib.apply_blocks(params["gate"], x, spec)
        u = dyad_lib.apply_blocks(params["up"], x, spec)
        h = F.silu(g) * u
    else:
        h = ACTS[act](dyad_lib.apply_blocks(params["up"], x, spec))
    return dyad_lib.apply_ot_from_blocks(params["down"], h)


def apply_mlp(params, x, lin_cfg: factory.LinearCfg, *, act: str = "swiglu"):
    if _ff_quant_ready(params, lin_cfg, act):
        # forward-only: the quantized snapshot is frozen.  kernel_nan with
        # route ff_quant models corrupt quantized blocks, which the
        # serving ladder's first rung (quant -> fp) leaves
        y = kops.dyad_ff_quant(params, x, act=act)
        return faults.poison(y, "kernel_nan", route="ff_quant")
    if _ff_kernel_ready(params, lin_cfg, act):
        return kops.dyad_ff(params, x, act=act,
                            use_kernel_bwd=lin_cfg.use_kernel_bwd)
    use_blocks = (lin_cfg.fuse_mlp
                  or (lin_cfg.fuse_ff_kernel and _ff_module_ok(params, act)))
    if use_blocks and "w1" in params.get("down", {}):
        return _fused_dyad_mlp(params, x, lin_cfg, act)
    if act == "swiglu":
        g = factory.apply(params["gate"], x, lin_cfg, site="ff")
        u = factory.apply(params["up"], x, lin_cfg, site="ff")
        h = F.silu(g) * u
    else:
        h = ACTS[act](factory.apply(params["up"], x, lin_cfg, site="ff"))
    return factory.apply(params["down"], h, lin_cfg, site="ff")
