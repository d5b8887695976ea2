"""Config-driven linear substitution (port of ``repro.core.factory``).

Every linear layer is created through this factory with a ``site`` tag
(``"ff"``, ``"attn"``, ...).  :class:`LinearCfg` decides, per site, whether
the layer is the DENSE baseline or a DYAD variant.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import obs
from repro_torch import quant as quant_lib
from repro_torch.core import dyad, linear

Params = Dict[str, torch.Tensor]

# sites a LinearCfg scope can capture
_SCOPES = {
    "none": frozenset(),
    "ff": frozenset({"ff"}),
    "ff+attn": frozenset({"ff", "attn"}),
    "ff+ssm": frozenset({"ff", "ssm"}),
    "all": frozenset({"ff", "attn", "ssm", "head"}),
}


@dataclasses.dataclass(frozen=True)
class LinearCfg:
    """Static, hashable description of the linear-layer policy."""

    impl: str = "dense"            # "dense" | "dyad"
    n_dyad: int = 4
    variant: str = "it"            # "it" | "ot" | "dt"
    cat: bool = False
    use_kernel: bool = False
    use_kernel_bwd: bool = True    # kernel backward (with use_kernel)
    scope: str = "ff"              # which sites receive DYAD when impl == "dyad"
    # the fused ff tiers (layers.mlp)
    fuse_mlp: bool = False
    fuse_ff_kernel: bool = False
    # serving over quantized weights ("int8" | "fp8"; spec tokens "w8",
    # "wfp8"): with use_kernel, a DYAD module that carries the sidecars of
    # repro_torch.quant.quantize_params runs its forward over them
    quant: Optional[str] = None

    def dyad_at(self, site: str) -> bool:
        if self.impl != "dyad":
            return False
        try:
            return site in _SCOPES[self.scope]
        except KeyError:
            raise ValueError(f"unknown dyad scope {self.scope!r}") from None

    def replace(self, **kw) -> "LinearCfg":
        return dataclasses.replace(self, **kw)

    def spec(self, f_in: int, f_out: int) -> dyad.DyadSpec:
        n = dyad.resolve_n_dyad(f_in, f_out, self.n_dyad)
        return dyad.DyadSpec(n_dyad=n, variant=self.variant, cat=self.cat,
                             use_kernel=self.use_kernel,
                             use_kernel_bwd=self.use_kernel_bwd)


DENSE = LinearCfg(impl="dense")


def init(generator: torch.Generator, f_in: int, f_out: int, cfg: LinearCfg,
         *, site: str = "ff", bias: bool = True,
         dtype: torch.dtype = torch.float32, device=None) -> Params:
    if cfg.dyad_at(site):
        return dyad.init(generator, f_in, f_out, cfg.spec(f_in, f_out),
                         bias=bias, dtype=dtype, device=device)
    return linear.init(generator, f_in, f_out, bias=bias, dtype=dtype,
                       device=device)


def apply(params: Params, x: torch.Tensor, cfg: LinearCfg, *,
          site: str = "ff") -> torch.Tensor:
    if "w1" in params:  # dyad params
        ready = False
        if cfg.quant and cfg.use_kernel:
            # forward-only, over the sidecars; a tree without them (the
            # training params) keeps the fp route
            ready = (quant_lib.module_quantized(params)
                     and quant_lib.enabled())
            obs.route_event("mm_quant", cfg.quant if ready else "fp_fallback",
                            site=site)
        if ready:
            from repro_torch.kernels import ops as kops

            y = kops.dyad_mm_quant(x, params["w1_q"], params["w2_q"],
                                   params["w1_s"], params["w2_s"],
                                   variant=cfg.variant)
            if "b" in params:
                y = y + params["b"].to(y.dtype)
            return y
        n, d_out, d_in = params["w1"].shape
        return dyad.apply(params, x, cfg.spec(n * d_in, n * d_out))
    return linear.apply(params, x)


def param_count(f_in: int, f_out: int, cfg: LinearCfg, *, site: str = "ff",
                bias: bool = True) -> int:
    if cfg.dyad_at(site):
        n = dyad.resolve_n_dyad(f_in, f_out, cfg.n_dyad)
        return dyad.param_count(f_in, f_out, n, bias)
    return linear.param_count(f_in, f_out, bias)
