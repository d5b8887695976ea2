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
# every architecture the port runs: the paper's, the dense lm configs, and
# the moe, ssm, hybrid, encdec and vlm families' (Maverick, Qwen2.5-32B
# and Llama-3-405B at smoke size only: their params need several cards,
# ROADMAP A.11)
PORTED_ARCHS = PAPER_ARCHS + ["qwen3_0_6b", "phi3_medium_14b",
                              "qwen2_5_32b", "llama3_405b",
                              "qwen2_moe_a2_7b",
                              "llama4_maverick_400b_a17b", "whisper_medium",
                              "mamba2_780m", "phi3_vision_4_2b",
                              "hymba_1_5b"]


def linear_cfg(spec: str) -> factory.LinearCfg:
    """Parse "dense" | "dyad_it" | "dyad_ot_8" | "dyad_dt_4_cat" |
    "dyad_it_4_kernel" (route forward and backward through the
    hand-written kernels) | "dyad_it_4_kernel_einsumbwd" (kernel forward,
    einsum-VJP oracle backward) | the fused and quantized tokens ("fused",
    "ffused", "w8", "wfp8"), which parse as in the reference.  Every
    spec gets scope ``ff``, as the reference's parser gives it: a config
    whose own linear has scope ``ff+ssm`` (Mamba2, Hymba) loses its SSM
    projections' DYAD under ``--linear`` (ROADMAP C.12)."""
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
        raise ValueError(f"unknown arch {arch!r}; ported: {PORTED_ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    cfg = (mod.smoke if smoke else mod.full)()
    if linear is not None:
        cfg = cfg.replace(linear=linear)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
