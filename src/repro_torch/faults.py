"""Deterministic, seedable fault injection (port of ``repro.faults``): the
same sites, schedule syntax, knobs and per-site streams, so a schedule and
seed fire at the same checks in both packages.

========================  ===================================================
site                      where it fires
========================  ===================================================
``page_exhaustion``       ``PageAllocator.alloc`` raises :class:`PageExhausted`
                          even though pages are free
``nan_logits``            the continuous engine's decode step multiplies
                          the batch logits by NaN (once per attempt)
``nan_loss``              the trainer poisons the step's gradients and loss
                          with NaN (through the ``_fault_poison`` batch key)
``kernel_nan``            the kernel routes (``layers/mlp.py``,
                          ``kernels/ops.py``, ``layers/attention.py``)
                          multiply the routed output by NaN when the active
                          route matches ``route=``: a numerically broken
                          kernel for the demotion ladder to leave
``slow_step``             the engine's step and the trainer's step sleep
                          ``ms=`` on the host: stragglers and stalls
``ckpt_io``               ``CheckpointManager`` writes raise
                          :class:`CheckpointIOError` (retry and backoff)
========================  ===================================================

Schedules come from ``REPRO_FAULT`` (``site:k=v[,k=v];site2:...``) plus
``REPRO_FAULT_SEED``, or from :func:`configure`::

    REPRO_FAULT="page_exhaustion:p=0.05;nan_logits:at_step=3;ckpt_io:p=0.1"

Knobs: ``p`` (fire on each check with probability p), ``at_step`` (fire
on the site's check number ``at_step``, 0-based, once), ``times`` (cap
the fires; 1 by default with ``at_step``), ``ms`` (``slow_step``'s
sleep) and ``route`` (fire only where the call site reports this route:
``ff_quant``, ``ff_fused``, ``ff_split``, ``attn_flash``).

Each site draws from its own numpy generator seeded with ``[seed,
crc32(site)]``, so checks of other sites never move a site's sequence.
The environment is read once, at the first :func:`active` call; after it
the disabled path is one module-global ``bool`` load.

One difference from the reference: JAX checks ``kernel_nan`` when it
traces a jitted function, so its ``at_step`` counts traces; the port runs
eagerly and checks on every call, so its ``at_step`` counts calls.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, Optional, Union

import numpy as np

from repro_torch import obs

ENV_VAR = "REPRO_FAULT"
ENV_SEED = "REPRO_FAULT_SEED"

_FLOAT_KEYS = ("p", "ms")
_INT_KEYS = ("at_step", "times")


@dataclasses.dataclass
class FaultSpec:
    """One site's schedule (see the module docstring for the knobs)."""
    site: str
    p: float = 0.0
    at_step: Optional[int] = None
    times: Optional[int] = None
    ms: float = 0.0
    route: Optional[str] = None

    def __post_init__(self):
        if self.p and self.at_step is not None:
            raise ValueError(
                f"fault {self.site!r}: p= and at_step= are exclusive")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault {self.site!r}: p={self.p} not in [0,1]")
        if self.times is None and self.at_step is not None:
            self.times = 1          # a step trigger fires once by default


def parse(spec: str) -> Dict[str, FaultSpec]:
    """``"site:k=v[,k=v];site2:..."`` -> {site: FaultSpec}.  An entry with
    no knobs (``"kernel_nan"``) fires unconditionally while configured."""
    out: Dict[str, FaultSpec] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, kvs = part.partition(":")
        site = site.strip()
        kwargs: dict = {}
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k = k.strip()
            if k in _FLOAT_KEYS:
                kwargs[k] = float(v)
            elif k in _INT_KEYS:
                kwargs[k] = int(v)
            elif k == "route":
                kwargs[k] = v.strip()
            else:
                raise ValueError(f"unknown fault knob {k!r} in {part!r}")
        if site in out:
            raise ValueError(f"duplicate fault site {site!r}")
        out[site] = FaultSpec(site=site, **kwargs)
    return out


class FaultRegistry:
    """Seeded firing engine over a parsed schedule.  Owns per-site check /
    fire counters (the chaos tests and ``--metrics-json`` read them) and
    per-site RNG streams."""

    def __init__(self, specs: Dict[str, FaultSpec], seed: int = 0):
        self.specs = dict(specs)
        self.seed = int(seed)
        self._rng: Dict[str, np.random.Generator] = {
            site: np.random.default_rng(
                [self.seed, zlib.crc32(site.encode())])
            for site in specs
        }
        self.checks: Dict[str, int] = {site: 0 for site in specs}
        self.fired: Dict[str, int] = {site: 0 for site in specs}

    def check(self, site: str, route: Optional[str] = None
              ) -> Optional[FaultSpec]:
        """One firing decision for ``site``; returns the spec when the
        fault fires, else None.  Route-mismatched checks do not consume a
        draw or advance the site's check counter, so the same schedule
        fires identically whatever other routes run."""
        spec = self.specs.get(site)
        if spec is None:
            return None
        if spec.route is not None and route != spec.route:
            return None
        n = self.checks[site]
        self.checks[site] = n + 1
        if spec.times is not None and self.fired[site] >= spec.times:
            return None
        if spec.at_step is not None:
            fire = n == spec.at_step
        elif spec.p:
            fire = bool(self._rng[site].random() < spec.p)
        else:
            fire = True
        if not fire:
            return None
        self.fired[site] += 1
        obs.instant("fault", cat="fault", site=site, check=n,
                    route=route or "", fired=self.fired[site])
        return spec

    def snapshot(self) -> dict:
        """JSON-ready per-site tallies (rides in ``--metrics-json``)."""
        return {site: {"checks": self.checks[site],
                       "fired": self.fired[site]}
                for site in sorted(self.specs)}


# -- process-global registry -------------------------------------------------
# _ACTIVE is the fast path: None until the environment has been read, then
# a bool, so every hot-path ``if faults.active(): ...`` is one global load
# and one branch.
_REGISTRY: Optional[FaultRegistry] = None
_ACTIVE: Optional[bool] = None


def configure(spec: Union[str, Dict[str, FaultSpec], None],
              seed: int = 0) -> Optional[FaultRegistry]:
    """Install a fault schedule (string syntax or pre-parsed specs);
    ``configure(None)`` clears it.  Either wins over ``REPRO_FAULT``.
    Returns the live registry."""
    global _REGISTRY, _ACTIVE
    if spec is None:
        _REGISTRY, _ACTIVE = None, False
        return None
    specs = parse(spec) if isinstance(spec, str) else dict(spec)
    _REGISTRY = FaultRegistry(specs, seed=seed)
    _ACTIVE = bool(specs)
    return _REGISTRY


def reset() -> None:
    """Clear the schedule and read the environment again at the next
    check (test isolation)."""
    global _REGISTRY, _ACTIVE
    _REGISTRY, _ACTIVE = None, None


def _load_env() -> None:
    global _ACTIVE
    _ACTIVE = False
    spec = os.environ.get(ENV_VAR, "").strip()
    if spec:
        configure(spec, seed=int(os.environ.get(ENV_SEED, "0") or 0))


def active() -> bool:
    """Is any fault schedule configured?  One global load after the first
    call has read ``REPRO_FAULT``."""
    a = _ACTIVE
    if a is None:
        _load_env()
        a = _ACTIVE
    return a


def registry() -> Optional[FaultRegistry]:
    if _ACTIVE is None:
        _load_env()
    return _REGISTRY


def fire(site: str, route: Optional[str] = None) -> Optional[FaultSpec]:
    """One firing decision at ``site`` (None = keep going).  The per-site
    check counter advances on every call, so retries re-draw — a transient
    injected fault clears on the retry exactly like a real one."""
    if not active():
        return None
    return _REGISTRY.check(site, route=route)


def poison(x, site: str, route: Optional[str] = None):
    """Kernel-route poisoning: ``x`` untouched unless ``site`` fires for
    ``route``, in which case the route's output is multiplied by NaN in
    its own dtype (the demotion ladder's routes carry other labels, so the
    retried call no longer matches)."""
    if not active():
        return x
    if _REGISTRY.check(site, route=route) is None:
        return x
    return x * float("nan")


def snapshot() -> dict:
    """Per-site check/fire tallies of the live registry ({} when off)."""
    reg = registry()
    return reg.snapshot() if reg else {}
