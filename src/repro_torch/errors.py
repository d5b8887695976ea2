"""Typed errors (port of ``repro.errors``): the trainer's and the
checkpoints', and the continuous engine's admission, deadline and page
accounting errors.  Each also subclasses the builtin the reference raises
at the same site, so the same ``except`` clauses catch them."""
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


class AdmissionError(ReproError, ValueError):
    """A request can never be admitted: prompt + budget exceeds the cache
    length, the page pool could never hold it, or the parameters are
    malformed (``max_new < 1``).  Raised by ``submit`` before queueing."""


class DeadlineExceeded(ReproError, TimeoutError):
    """``ContinuousBatchingEngine.run(deadline_s=...)`` overran its drain
    budget.  Per-request deadlines do not raise: they retire the request
    with ``RetireReason.DEADLINE``."""


class PageExhausted(ReproError, RuntimeError):
    """``PageAllocator.alloc`` found no free page.  The continuous engine
    treats it as pool pressure: it rolls the partial admission back and
    retries or preempts."""


class PageAccountingError(ReproError, ValueError):
    """A page-refcount invariant was about to be violated: a double
    release, a retain of a free page, or a free-list page with a live
    refcount."""
