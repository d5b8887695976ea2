"""Nestable tracing spans with Chrome-trace/Perfetto JSON export (port of
``repro.obs.trace``; the same span names, categories and document, so a
trace from either package loads in the same viewer and
``python -m repro_torch.perf.timeline`` diffs one against the other).

The tracer is a process-global singleton, **off by default**.  The
instrumented paths (the trainer's steps and checkpoints, the engines'
prefill, admission and decode steps) call :func:`span` / :func:`instant`
unconditionally; the disabled path is one module-global ``is None`` check
returning a shared no-op context manager (no allocation, no clock read).

Enabled (:func:`enable`), spans record ``time.perf_counter_ns`` enter/exit
pairs into a bounded ring buffer (``collections.deque(maxlen=capacity)``),
so a long-running server keeps the most recent window.  The Chrome trace
format (``ph: "X"`` complete events) nests spans by time containment per
thread, so :func:`export` emits one event per span with the recording
thread's id as ``tid`` (the async checkpoint writer records from its own
thread).  Load the file in ``ui.perfetto.dev`` or ``chrome://tracing``.

Spans time the host.  A span around device work ends when its body
returns; the instrumented sites that wait for the device (the trainer's
step, the engines' token copies) end after that wait, the others measure
the host's time to queue.  Span args must be JSON-serializable scalars
(anything else is stringified at export, never in the hot path).
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, Dict, List, Optional

DEFAULT_CAPACITY = 200_000


class _NullSpan:
    """The disabled tracer's span: a shared, stateless context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        """Attach args after entry (no-op when disabled)."""


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records enter/exit timestamps on the tracer clock."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self._tracer._record(self.name, self.cat, self._t0, t1 - self._t0,
                             self.args)
        return False

    def set(self, **args) -> None:
        """Attach/overwrite args from inside the span body (e.g. a result
        computed mid-span, like the number of tokens a step emitted)."""
        self.args.update(args)


class Tracer:
    """Bounded in-memory span recorder on the monotonic clock."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._events: Deque[tuple] = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.t_origin_ns = time.perf_counter_ns()
        self.dropped = 0          # events evicted by the ring bound

    def _record(self, name: str, cat: str, t0_ns: int, dur_ns: int,
                args: dict) -> None:
        ev = (name, cat, t0_ns, dur_ns, threading.get_ident(), args)
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    def span(self, name: str, cat: str = "repro", **args) -> _Span:
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        """Zero-duration marker event (route decisions, rejects, ...)."""
        self._record(name, cat, time.perf_counter_ns(), -1, args)

    def __len__(self) -> int:
        return len(self._events)

    # -- export -------------------------------------------------------------
    @staticmethod
    def _clean(args: dict) -> dict:
        out = {}
        for k, v in args.items():
            if isinstance(v, (int, float, str, bool)) or v is None:
                out[k] = v
            else:
                out[k] = str(v)
        return out

    def to_chrome_trace(self) -> dict:
        """The full Chrome-trace document (``ui.perfetto.dev`` opens it).

        Timestamps are microseconds relative to the tracer's origin; spans
        are ``ph: "X"`` complete events (Perfetto nests them by time
        containment per tid), instants are ``ph: "i"``."""
        with self._lock:
            events = list(self._events)
        out: List[dict] = []
        pid = os.getpid()
        for name, cat, t0, dur, tid, args in events:
            ev: Dict = {
                "name": name, "cat": cat, "pid": pid, "tid": tid,
                "ts": (t0 - self.t_origin_ns) / 1e3,
            }
            if dur < 0:
                ev["ph"] = "i"
                ev["s"] = "t"
            else:
                ev["ph"] = "X"
                ev["dur"] = dur / 1e3
            if args:
                ev["args"] = self._clean(args)
            out.append(ev)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"recorder": "repro_torch.obs",
                          "dropped": self.dropped},
        }

    def export(self, path: str) -> str:
        doc = self.to_chrome_trace()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        os.replace(tmp, path)
        return path


# -- the process-global tracer ------------------------------------------------

_TRACER: Optional[Tracer] = None


def enable(capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Install (or return the existing) process-global tracer."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer(capacity)
    return _TRACER


def disable() -> Optional[Tracer]:
    """Remove the global tracer; returns it (for a final export)."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def span(name: str, cat: str = "repro", **args):
    """``with obs.span("decode_step", batch=4): ...`` — a nestable span on
    the global tracer, or a shared no-op when tracing is off.  The disabled
    path is one global load and one branch."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "repro", **args) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, **args)


def export(path: str) -> Optional[str]:
    """Export the global tracer's buffer as Chrome-trace JSON (None when
    tracing is off)."""
    t = _TRACER
    if t is None:
        return None
    return t.export(path)


def verbose() -> bool:
    """Shared gate for human-readable progress lines from long-running
    internals: on when ``REPRO_OBS_VERBOSE`` is truthy, off when it is
    falsy, and otherwise on exactly while the tracer is enabled."""
    env = os.environ.get("REPRO_OBS_VERBOSE", "").lower()
    if env in ("1", "true", "on", "yes"):
        return True
    if env in ("0", "false", "off", "no"):
        return False
    return _TRACER is not None
