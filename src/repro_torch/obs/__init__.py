"""Telemetry (port of ``repro.obs``): the metrics registry the trainer
feeds.  Spans, tracing and route events wait for ROADMAP A.12."""
from repro_torch.obs.metrics import MetricsRegistry  # noqa: F401
