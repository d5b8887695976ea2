"""Optimizer substrate (port of ``repro.optim``): AdamW and schedules.
Gradient compression waits for ROADMAP A.10."""
from repro_torch.optim import schedule  # noqa: F401
from repro_torch.optim.adamw import AdamW, default_decay_mask  # noqa: F401
