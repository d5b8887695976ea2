"""Optimizer substrate (port of ``repro.optim``): AdamW, schedules and
gradient compression."""
from repro_torch.optim import schedule  # noqa: F401
from repro_torch.optim.adamw import AdamW, default_decay_mask  # noqa: F401
from repro_torch.optim.compress import Compressor  # noqa: F401
