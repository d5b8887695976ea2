"""Architecture configs the port runs: the paper's OPT and Pythia models."""
from repro_torch.configs.base import (  # noqa: F401
    DENSE,
    DYAD_DEFAULT,
    PAPER_ARCHS,
    get,
    linear_cfg,
)
