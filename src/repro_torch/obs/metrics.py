"""Counters, gauges and histograms (port of ``repro.obs.metrics``).  Each
trainer and engine owns a :class:`MetricsRegistry`; the instruments are
plain Python arithmetic and snapshot to plain dicts for
``--metrics-json`` and the launchers' summary lines.

The trainer's set: ``step_time_s`` and ``data_time_s`` (histograms),
``tokens_per_s`` and ``loss`` (gauges), ``tokens_trained``,
``straggler_count``, ``nonfinite_steps`` and ``rollbacks`` (counters).
The engine's: ``ttft_s``, ``itl_s`` and ``decode_step_s`` (histograms),
``queue_depth``, ``active_slots`` and ``page_pool_used`` (gauges), and
request, token, prefix, preemption and retirement counters.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Union

Number = Union[int, float]


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value and its high-water mark."""

    __slots__ = ("value", "max")

    def __init__(self) -> None:
        self.value = 0
        self.max = 0

    def set(self, v: Number) -> None:
        self.value = v
        if v > self.max:
            self.max = v


class Histogram:
    """Exact-sample histogram (up to ``max_samples`` observations kept)."""

    __slots__ = ("samples", "count", "total", "max_samples")

    def __init__(self, max_samples: int = 100_000) -> None:
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.max_samples = max_samples

    def observe(self, v: Number) -> None:
        self.count += 1
        self.total += v
        if len(self.samples) < self.max_samples:
            self.samples.append(float(v))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the kept samples (0 if empty)."""
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[idx]

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Named instruments, created on first touch (``m.counter("x").inc()``)."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self.t_start = time.perf_counter()

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._hists.setdefault(name, Histogram())

    def snapshot(self) -> dict:
        """JSON-ready: counters as values, gauges as {value, max},
        histograms as count/mean/percentiles."""
        return {
            "elapsed_s": time.perf_counter() - self.t_start,
            "counters": {k: v.value for k, v in sorted(self._counters.items())},
            "gauges": {k: {"value": g.value, "max": g.max}
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._hists.items())},
        }

    def write_json(self, path: str, **extra) -> str:
        """Write the snapshot (plus ``extra`` top-level sections) as JSON."""
        doc = self.snapshot()
        doc.update(extra)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        return path


def _fmt(v: float) -> str:
    if v >= 100:
        return f"{v:.0f}"
    return f"{v:.3g}"


def format_serving_line(m: MetricsRegistry) -> str:
    """The periodic one-line serving report (and the final summary body)."""
    snap = m.snapshot()
    c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
    toks = c.get("tokens_generated", 0)
    el = max(snap["elapsed_s"], 1e-9)
    ttft = h.get("ttft_s", {})
    itl = h.get("itl_s", {})
    pool = g.get("page_pool_used", {"value": 0, "max": 0})
    return (f"reqs={c.get('requests_finished', 0)} tok={toks} "
            f"tok/s={_fmt(toks / el)} "
            f"ttft_ms p50={_fmt(1e3 * ttft.get('p50', 0.0))} "
            f"p99={_fmt(1e3 * ttft.get('p99', 0.0))} "
            f"itl_ms p50={_fmt(1e3 * itl.get('p50', 0.0))} "
            f"queue={g.get('queue_depth', {}).get('value', 0)} "
            f"active={g.get('active_slots', {}).get('value', 0)} "
            f"pages={pool['value']}/{pool['max']}peak "
            f"prefix_hits={c.get('prefix_hits', 0)} "
            f"prefix_tok_skipped={c.get('prefix_tokens_skipped', 0)} "
            f"rejects={c.get('admission_rejects', 0)} "
            f"preempts={c.get('preemptions', 0)} "
            f"faulted={c.get('retired_faulted', 0)}")


def format_training_line(m: MetricsRegistry, step: int,
                         loss: Optional[float] = None,
                         extra: str = "") -> str:
    """The one-line training report: step, loss, tokens/s, step ms p50."""
    snap = m.snapshot()
    h = snap["histograms"].get("step_time_s", {})
    g = snap["gauges"]
    line = (f"step {step} "
            + (f"loss={loss:.4f} " if loss is not None else "")
            + f"tok/s={_fmt(g.get('tokens_per_s', {}).get('value', 0.0))} "
            f"step_ms p50={_fmt(1e3 * h.get('p50', 0.0))}")
    return line + (f" {extra}" if extra else "")
