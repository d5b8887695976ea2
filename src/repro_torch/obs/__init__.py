"""Telemetry (port of ``repro.obs``): the metrics registry the trainer
and the continuous engine feed, and the serving report line.  Spans,
tracing and route events wait for ROADMAP A.12."""
from repro_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    format_serving_line,
)
