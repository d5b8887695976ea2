"""Architecture configs the port runs: the paper's OPT and Pythia models,
the dense Qwen3-0.6B, Phi-3-medium-14B, Qwen2.5-32B and Llama-3-405B, and
the moe (Qwen1.5-MoE-A2.7B, Llama-4 Maverick), ssm (Mamba2-780m), hybrid
(Hymba-1.5B), encdec (Whisper-medium) and vlm (Phi-3-vision-4.2B)
families."""
from repro_torch.configs.base import (  # noqa: F401
    DENSE,
    DYAD_DEFAULT,
    PAPER_ARCHS,
    PORTED_ARCHS,
    get,
    linear_cfg,
)
