"""Architecture configs the port runs: the paper's OPT and Pythia models,
and Qwen3-0.6B."""
from repro_torch.configs.base import (  # noqa: F401
    DENSE,
    DYAD_DEFAULT,
    PAPER_ARCHS,
    PORTED_ARCHS,
    get,
    linear_cfg,
)
