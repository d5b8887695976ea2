"""Fault-tolerant training loop (port of ``repro.train.loop``):

* **auto-resume** from the newest complete checkpoint (the data stream is
  stateless by step, so the data resumes exactly);
* **preemption hook**: SIGTERM/SIGINT finish the step in flight, write a
  blocking checkpoint and end ``run`` (the launcher then exits 0);
* **straggler watchdog**: a step slower than ``straggler_factor`` times
  the running median is recorded (and handed to ``on_straggler``);
* **NaN backoff**: the step skips a non-finite update itself
  (``metrics["nonfinite"]``); after ``nan_strikes`` consecutive strikes
  the trainer rolls back to the last checkpoint, and raises
  :class:`repro_torch.errors.NumericalFault` with no checkpoint to roll
  back to or after ``max_rollbacks`` rollbacks;
* **async checkpointing** every ``ckpt_every`` steps;
* **prefetch**: while the device runs step ``i`` the host builds batch
  ``i + 1``, so a device-bound loop runs at the step's pace;
* **telemetry**: a :class:`repro_torch.obs.MetricsRegistry` with the
  ``step_time_s`` histogram (host clock from the step's launch until the
  device has finished it; on the CPU, where the step is done before its
  call returns, it includes the next batch), the ``data_time_s``
  histogram (host clock around each batch) and the ``tokens_per_s`` /
  ``loss`` gauges; the reference's spans (``resume``, ``rollback``,
  ``train_step``, which ends after the device wait, and ``checkpoint``)
  and instants (``nonfinite_step``, ``straggler``);
* **fault sites** (``repro_torch.faults``): ``slow_step`` sleeps on the
  host and ``nan_loss`` sets the ``_fault_poison`` batch key, present on
  every step while the site is armed.

One difference from the reference (ROADMAP C.9): the ``slow_step`` sleep
runs inside the timed step, so the straggler watchdog sees it; the
reference sleeps before its step clock starts.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Callable, Optional

import torch

from repro_torch import faults, obs, tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.errors import NumericalFault


def _wait_for(t: torch.Tensor) -> None:
    """Block until the device has computed ``t``."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Trainer:
    def __init__(
        self,
        train_step: Callable,
        init_state: dict,
        data,
        *,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        log_every: int = 10,
        straggler_factor: float = 3.0,
        on_straggler: Optional[Callable] = None,
        nan_strikes: int = 3,
        max_rollbacks: int = 3,
        log_fn: Callable = print,
    ):
        self.train_step = train_step
        self.state = init_state
        self.data = data
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler
        self.log = log_fn
        self.step = 0
        self.straggler_events = []
        self.preempted = False
        self._step_times = []
        self._median = 0.0            # running median the watchdog keeps
        self.nan_strikes = nan_strikes
        self.max_rollbacks = max_rollbacks
        self._strikes = 0             # consecutive non-finite steps
        self._rollbacks = 0
        self.metrics = obs.MetricsRegistry()

    # -- fault tolerance ------------------------------------------------------
    def install_preemption_handler(self, signals=(signal.SIGTERM,)):
        for s in signals:
            signal.signal(s, self._on_preempt)

    def _on_preempt(self, signum, frame):
        self.log(f"[trainer] preemption signal {signum}: checkpoint + exit")
        self.preempted = True

    def _restore(self) -> None:
        self.step, restored = self.ckpt.restore(self.state)
        # in place: the step function and its callers keep their tensors
        with torch.no_grad():
            tree.map(lambda old, new: old.copy_(new), self.state, restored)

    def maybe_resume(self):
        if self.ckpt and self.ckpt.latest_step() is not None:
            with obs.span("resume", cat="train"):
                self._restore()
            self.log(f"[trainer] resumed from step {self.step}")

    def _after_step(self, metrics) -> None:
        """Consecutive non-finite accounting and rollback."""
        bad = metrics.get("nonfinite")
        if bad is None or not float(bad):
            self._strikes = 0
            return
        self._strikes += 1
        self.metrics.counter("nonfinite_steps").inc()
        obs.instant("nonfinite_step", cat="train", step=self.step,
                    strikes=self._strikes)
        self.log(f"[trainer] non-finite loss/grad at step {self.step} "
                 f"(skipped; strike {self._strikes}/{self.nan_strikes})")
        if self._strikes < self.nan_strikes:
            return
        if not self.ckpt or self.ckpt.latest_step() is None:
            raise NumericalFault(
                f"{self._strikes} consecutive non-finite steps and no "
                "checkpoint to roll back to")
        self._rollbacks += 1
        if self._rollbacks > self.max_rollbacks:
            raise NumericalFault(
                f"still non-finite after {self.max_rollbacks} rollbacks "
                "- the fault is not transient")
        with obs.span("rollback", cat="train", step=self.step,
                      strikes=self._strikes, rollback=self._rollbacks):
            self.ckpt.wait()
            self._restore()
        self.metrics.counter("rollbacks").inc()
        self._strikes = 0
        self.log(f"[trainer] rolled back to checkpoint step {self.step} "
                 f"(rollback {self._rollbacks}/{self.max_rollbacks})")

    def _watch_straggler(self, dt: float):
        self._step_times.append(dt)
        if len(self._step_times) >= 8:
            med = statistics.median(self._step_times[-64:])
            self._median = med
            if dt > self.straggler_factor * med:
                self.straggler_events.append((self.step, dt, med))
                self.metrics.counter("straggler_count").inc()
                obs.instant("straggler", cat="train", step=self.step,
                            dt_ms=round(dt * 1e3, 2),
                            median_ms=round(med * 1e3, 2))
                self.log(f"[trainer] straggler at step {self.step}: "
                         f"{dt * 1e3:.1f}ms vs median {med * 1e3:.1f}ms")
                if self.on_straggler:
                    self.on_straggler(self.step, dt, med)

    # -- main loop -------------------------------------------------------------
    def _batch(self, step: int) -> dict:
        t0 = time.perf_counter()
        batch = self.data.batch(step)
        dt = time.perf_counter() - t0
        self.metrics.histogram("data_time_s").observe(dt)
        return batch

    def run(self, num_steps: int):
        """Train until ``self.step == num_steps`` (or a preemption);
        returns (state, the last step's metrics)."""
        self.maybe_resume()
        metrics = {}
        m = self.metrics
        ahead = None              # (step, batch) built during the last step
        while self.step < num_steps and not self.preempted:
            if ahead is not None and ahead[0] == self.step:
                batch = ahead[1]
            else:
                batch = self._batch(self.step)
            slow = None
            if faults.active():
                slow = faults.fire("slow_step")
                reg = faults.registry()
                if reg is not None and "nan_loss" in reg.specs:
                    # the key is present on every step while the site is
                    # armed, as in the reference
                    batch = dict(batch, _fault_poison=float(
                        faults.fire("nan_loss") is not None))
            n_tok = int(batch["tokens"].numel())
            t0 = time.perf_counter()
            with obs.span("train_step", cat="train", step=self.step,
                          tokens=n_tok):
                if slow is not None and slow.ms:
                    with obs.span("slow_step_fault", cat="fault",
                                  ms=slow.ms):
                        time.sleep(slow.ms / 1000.0)
                self.state, metrics = self.train_step(self.state, batch)
                # the step is queued on the device: build the next batch
                ahead = None
                if self.step + 1 < num_steps:
                    ahead = (self.step + 1, self._batch(self.step + 1))
                _wait_for(metrics["loss"])
            dt = time.perf_counter() - t0
            self._watch_straggler(dt)
            m.histogram("step_time_s").observe(dt)
            m.counter("tokens_trained").inc(n_tok)
            m.gauge("tokens_per_s").set(n_tok / max(dt, 1e-9))
            self.step += 1
            self._after_step(metrics)
            if self.step % self.log_every == 0:
                loss = float(metrics["loss"])
                m.gauge("loss").set(loss)
                med = self._median or statistics.median(self._step_times)
                self.log(f"[trainer] step {self.step} loss={loss:.4f} "
                         f"gnorm={float(metrics['grad_norm']):.3f} "
                         f"tok/s={n_tok / max(dt, 1e-9):.0f} "
                         f"step_ms_med={med * 1e3:.1f}")
            if self.ckpt and self.step % self.ckpt_every == 0:
                with obs.span("checkpoint", cat="train", step=self.step):
                    self.ckpt.save(self.step, self.state)
        if self.ckpt:
            with obs.span("checkpoint", cat="train", step=self.step,
                          final=True):
                self.ckpt.save(self.step, self.state, blocking=True)
                self.ckpt.wait()
        return self.state, metrics

