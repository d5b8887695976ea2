"""Runtime observability (port of ``repro.obs``): tracing spans, metrics
and route-dispatch events.

* :mod:`repro_torch.obs.trace` — the process-global tracer: nestable
  spans on the monotonic clock, a bounded ring buffer, Chrome-trace JSON
  export.  Off by default; the disabled path is one global load.
* :mod:`repro_torch.obs.metrics` — the per-owner :class:`MetricsRegistry`
  the trainer and the engines feed, and the report lines.
* route events (:func:`route_event` below) — every kernel routing decision
  of :mod:`repro_torch.kernels.ops` and the layers (ff fused or split,
  flash or plain attention, CUDA or plain backward, a CUDA kernel or its
  plain version, the quantized routes, the engine's demotions) is counted
  here and, while tracing, marked in the timeline.

One difference from the reference: JAX records a routing decision once
per trace of a jitted function, while the port runs eagerly and records
one per call.  So the counts here are calls (per step, per layer), where
the reference's are compilations.  Each event is a dict bump, plus an
instant only while the tracer is on.

Consumers: ``launch/serve.py`` and ``launch/train.py`` (``--trace``,
``--metrics-json``) and ``python -m repro_torch.perf.timeline``.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, format_serving_line,
                                     format_training_line)
from repro_torch.obs.trace import (Tracer, disable, enable, enabled, export,
                                   get_tracer, instant, span, verbose)

# (op, route) -> count of dispatch decisions.  Process-global on purpose:
# routing is a property of the process (device, environment), and the
# counters run whether or not a tracer is installed.
_ROUTE_COUNTS: Dict[Tuple[str, str], int] = {}


def route_event(op: str, route: str, **args) -> None:
    """Record one kernel routing decision: a dict bump, and an instant
    event while tracing."""
    key = (op, route)
    _ROUTE_COUNTS[key] = _ROUTE_COUNTS.get(key, 0) + 1
    t = _trace._TRACER
    if t is not None:
        t.instant(f"route:{op}={route}", "route", op=op, route=route, **args)


def route_counts() -> Dict[Tuple[str, str], int]:
    """Copy of the dispatch-decision counters ({(op, route): n})."""
    return dict(_ROUTE_COUNTS)


def reset_route_counts() -> None:
    _ROUTE_COUNTS.clear()


def routes_snapshot() -> Dict[str, int]:
    """JSON-ready view of the dispatch counters (``{"op:route": n}``), as
    ``--metrics-json`` carries it beside the latency percentiles."""
    return {f"{op}:{route}": n
            for (op, route), n in sorted(_ROUTE_COUNTS.items())}


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "format_serving_line", "format_training_line",
    "Tracer", "enable", "disable", "enabled", "export", "get_tracer",
    "instant", "span", "verbose",
    "route_event", "route_counts", "reset_route_counts", "routes_snapshot",
]
