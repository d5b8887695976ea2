"""Checkpoints (port of ``repro.checkpoint``) and the weight bridge to the
reference's flat layout."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
