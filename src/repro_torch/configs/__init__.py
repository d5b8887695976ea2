"""Architecture configs the port serves: the paper's OPT models."""
from repro_torch.configs.base import (  # noqa: F401
    DENSE,
    DYAD_DEFAULT,
    PAPER_ARCHS,
    get,
    linear_cfg,
)
