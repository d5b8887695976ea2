"""Typed errors of the training stack (the part of ``repro.errors`` the
port's trainer and checkpoints raise).  Each also subclasses the builtin
the reference raises at the same site."""
from __future__ import annotations


class ReproError(Exception):
    """Root of every typed error the port raises deliberately."""


class NumericalFault(ReproError, ArithmeticError):
    """Non-finite values survived every recovery rung: the trainer saw
    ``nan_strikes`` consecutive non-finite steps with no checkpoint to roll
    back to, or kept seeing them after ``max_rollbacks`` rollbacks."""


class CheckpointIOError(ReproError, RuntimeError):
    """A checkpoint write failed after exhausting its retries (or an async
    save failed and surfaced at ``wait()``)."""
