"""Architecture configs the port runs: the paper's OPT and Pythia models,
Qwen3-0.6B, and the moe (Qwen1.5-MoE-A2.7B, Llama-4 Maverick), ssm
(Mamba2-780m) and hybrid (Hymba-1.5B) families."""
from repro_torch.configs.base import (  # noqa: F401
    DENSE,
    DYAD_DEFAULT,
    PAPER_ARCHS,
    PORTED_ARCHS,
    get,
    linear_cfg,
)
