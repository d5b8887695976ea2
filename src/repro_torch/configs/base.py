"""Config registry and linear-spec parsing (port of ``repro.configs.base``).

Each ported architecture registers ``full()`` (the published config) and
``smoke()`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.core import factory
from repro_torch.models.config import ModelCfg

DYAD_DEFAULT = factory.LinearCfg(impl="dyad", n_dyad=4, variant="it", scope="ff")
DENSE = factory.DENSE

# the paper's architectures
PAPER_ARCHS = ["opt125m", "opt350m", "pythia160m"]
# every architecture the port runs: the paper's, and the bias-free lm
# config whose ff takes the megakernel
PORTED_ARCHS = PAPER_ARCHS + ["qwen3_0_6b"]


def linear_cfg(spec: str) -> factory.LinearCfg:
    """Parse "dense" | "dyad_it" | "dyad_ot_8" | "dyad_dt_4_cat" |
    "dyad_it_4_kernel" (route forward and backward through the
    hand-written kernels) | "dyad_it_4_kernel_einsumbwd" (kernel forward,
    einsum-VJP oracle backward) | the fused and quantized tokens ("fused",
    "ffused", "w8", "wfp8"), which parse as in the reference."""
    if spec == "dense":
        return DENSE
    parts = spec.split("_")
    if parts[0] != "dyad":
        raise ValueError(f"unknown linear spec {spec!r}")
    variant = parts[1] if len(parts) > 1 else "it"
    n = int(parts[2]) if len(parts) > 2 and parts[2].isdigit() else 4
    quant = ("int8" if "w8" in parts
             else "fp8" if "wfp8" in parts else None)
    return factory.LinearCfg(impl="dyad", n_dyad=n, variant=variant,
                             cat="cat" in parts, fuse_mlp="fused" in parts,
                             use_kernel="kernel" in parts,
                             use_kernel_bwd="einsumbwd" not in parts,
                             fuse_ff_kernel="ffused" in parts,
                             quant=quant, scope="ff")


def get(arch: str, *, smoke: bool = False,
        linear: Optional[factory.LinearCfg] = None, **overrides) -> ModelCfg:
    if arch not in PORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP A.13); "
            f"ported: {PORTED_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    cfg = (mod.smoke if smoke else mod.full)()
    if linear is not None:
        cfg = cfg.replace(linear=linear)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
