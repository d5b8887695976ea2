"""Checkpoints: atomic, async, keep-N, path-addressed (port of
``repro.checkpoint.manager``), in the reference's on-disk layout::

    <dir>/ckpt_<step>/arrays.npz     # flat {key-path: array}, layers stacked
    <dir>/ckpt_<step>/manifest.json  # step, keys, shapes, dtypes

so a checkpoint written by either package restores in the other
(``checkpoint.bridge`` maps the port's trees onto those keys).  Writes go
to ``ckpt_<step>.tmp`` and are renamed into place, so a crash mid-save
never corrupts the newest complete step.  Async saves snapshot the tree to
host memory first, then serialize on a worker thread; a failed async save
re-raises at the next ``wait()`` or ``save()``.  Writes retry with
exponential backoff (transient I/O errors, and the ``ckpt_io`` fault site,
which draws again on each attempt) and raise
:class:`repro_torch.errors.CheckpointIOError` after ``retries`` extra
attempts; each failed attempt marks a ``ckpt_retry`` instant in the trace.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import bridge
from repro_torch.errors import CheckpointIOError


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = True, retries: int = 3,
                 backoff_s: float = 0.05):
        self.directory = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self.retries = retries
        self.backoff_s = backoff_s
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False):
        host = bridge.to_flat(tree)          # device -> host, synchronously
        self.wait()
        if self.async_save and not blocking:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write_async(self, step: int, host: dict):
        try:
            self._write(step, host)
        except BaseException as e:        # surfaces at the next wait()
            self._error = e

    def _write(self, step: int, host: dict):
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                self._write_once(step, host)
                return
            except (OSError, CheckpointIOError) as e:
                obs.instant("ckpt_retry", cat="train", step=step,
                            attempt=attempt, error=str(e))
                if attempt == self.retries:
                    raise CheckpointIOError(
                        f"checkpoint step {step} failed after "
                        f"{attempt + 1} attempts: {e}") from e
                time.sleep(delay)
                delay *= 2

    def _write_once(self, step: int, host: dict):
        # the fault site sits inside the retry loop: each attempt draws
        # again, so an injected transient clears as a real one would
        if faults.active() and faults.fire("ckpt_io"):
            raise CheckpointIOError(
                f"checkpoint step {step} write failed (injected)")
        final = os.path.join(self.directory, f"ckpt_{step}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                     for k, v in host.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.directory, f"ckpt_{s}"),
                          ignore_errors=True)

    def wait(self):
        """Join an in-flight async save; re-raise its failure if it had
        one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if (name.startswith("ckpt_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "manifest.json"))):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None):
        """Returns (step, tree): the arrays matched by key path into
        ``template``'s structure, each on its template leaf's device and in
        its dtype.  Raises KeyError on a missing key, ValueError on a shape
        mismatch."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with np.load(os.path.join(self.directory, f"ckpt_{step}",
                                  "arrays.npz")) as npz:
            data = dict(npz)

        def pick(path, leaf):
            key, stacked = tree_lib.reference_key(path)
            arr = data[key]
            if stacked:
                arr = arr[[p for p in path if isinstance(p, int)][0]]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch at {key}: ckpt {arr.shape} vs "
                    f"template {tuple(leaf.shape)}")
            return torch.from_numpy(np.array(arr, copy=True)).to(
                device=leaf.device, dtype=leaf.dtype)

        return step, tree_lib.map_with_path(pick, template)
