"""Serving engines (port of ``repro.serve.engine``).

* :class:`Engine` — homogeneous batches: one single-pass prefill for the
  whole prompt batch, then a Python decode loop.  Token semantics follow
  the reference: the first emitted token is sampled from the prefill
  logits and each decode step feeds the previous token, so ``generate``
  returns ``(B, num_new)``.
* :class:`ContinuousBatchingEngine` — heterogeneous requests share one
  padded decode step over ``n_slots`` cache slots.  A :class:`SlotManager`
  assigns slots, finished sequences retire (EOS, length, deadline, cancel,
  fault) and queued requests back-fill freed slots.  Two cache modes:

  - dense per-slot rings (``init_cache(..., per_slot=True)``): admission
    prefills the prompt on a B=1 cache and copies it into the slot's row;
  - paged (``page_size=``): per-layer page pools addressed through
    per-slot block tables.  A :class:`PageAllocator` owns pages ``1 ..
    n_pages - 1`` with refcounts (page 0 is the scratch page); admission
    reserves exactly ``ceil((prompt + max_new - 1) / page_size)`` pages,
    prompts prefill in chunks (``prefill_chunk``) written straight into
    the shared pools, ``prefix_cache=True`` shares full prompt pages
    between requests through a sha1 chain over the prompt's int32 bytes,
    and under pool pressure a fresh request preempts the youngest
    decoding slot, which later resumes token-exact.  ``REPRO_PAGED_KV=off``
    is the escape hatch back to the dense rings.

  Before every decode step the host pushes the block tables and write
  indices in one copy (every layer shares the two tensors; free and
  mid-prefill lanes point at scratch page 0 with index 0), and the step's
  tokens and its non-finite-lane mask come back in one copy.  A NaN guard
  retries a step with non-finite logits once on the same route, then
  walks a ladder of demotions, one rung per retry, for this engine alone:
  ``quant`` (the quantized weight sidecars ignored: the fp routes) and
  ``ff`` (the ff forward from the fused megakernel to the split kernels).
  A rung already on its safe route is passed without a retry.  Lanes
  still non-finite retire ``FAULTED``.  The reference's third rung,
  ``attn`` (flash -> einsum), is not taken: on the card the port never
  gives way to plain torch attention (ROADMAP C.5).  The caches are
  written in place and a retried step rewrites the same rows, so the last
  tokens are committed only once a step is accepted.

Both engines carry the reference's spans and instants (``repro_torch.obs``;
category ``serve``): ``prefill`` and ``decode_loop`` in ``Engine``;
``admit``, ``prefill``, ``prefill_chunk``, ``sync_control``, ``decode_step``,
``preempt`` and ``retire`` spans and ``preempted``, ``admit_backoff``,
``admission_reject``, ``nan_detected`` and ``nan_unrecovered`` instants in
the continuous engine, whose demotions are ``demote`` route events.  Its
fault sites (``repro_torch.faults``): ``page_exhaustion`` in
:meth:`PageAllocator.alloc`, ``nan_logits`` once per decode attempt and
``slow_step`` once per engine step.  The dense mode's ``sync_control``
span has no twin in the reference, whose dense rings keep their write
indices in the jitted cache (ROADMAP C.10).

Not ported: the reference's ``autotune`` (ROADMAP A.12).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import hashlib
import itertools
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import faults, obs
from repro_torch import quant as quant_lib
from repro_torch.errors import (AdmissionError, DeadlineExceeded,
                                PageAccountingError, PageExhausted)
from repro_torch.kernels import ops as kops
from repro_torch.models import model
from repro_torch.models.config import ModelCfg


def prefill(cfg: ModelCfg, params, cache, tokens):
    """Single-pass prefill.  Returns (last logits (B,1,V) fp32, cache at S)."""
    return model.prefill(cfg, params, cache, tokens)


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature <= 0 or no generator) or temperature sampling
    from the last position of ``logits (B, S, V)``.  Returns (B, 1) int64.
    Greedy ties go to the first index, as ``jnp.argmax``."""
    last = logits[:, -1]
    if temperature <= 0.0 or generator is None:
        return torch.argmax(last, dim=-1, keepdim=True)
    probs = torch.softmax(last / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Greedy/temperature batched generation over a persistent cache.

    After each ``generate``, ``timings`` holds ``prefill_s`` (prompt in to
    first token out) and ``decode_s`` (the decode loop), each measured on
    the host clock after a device synchronisation; ``metrics`` accumulates
    the reference's ``ttft_s`` and ``itl_s`` histograms and the
    ``tokens_generated`` and ``requests_finished`` counters.
    """

    def __init__(self, cfg: ModelCfg, params, max_len: int,
                 cache_dtype: torch.dtype = torch.float32, device=None):
        self.cfg, self.params, self.max_len = cfg, params, max_len
        self.cache_dtype = cache_dtype
        self.device = device_lib.resolve(device)
        self.timings: dict = {}
        self.metrics = obs.MetricsRegistry()

    @torch.no_grad()
    def generate(self, prompt_tokens: torch.Tensor, num_new: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """prompt_tokens: (B, S) int -> (B, num_new) int64 generated tokens.

        Requires S + num_new - 1 <= max_len (the cache length)."""
        B, S = prompt_tokens.shape
        if num_new < 1:
            raise ValueError(f"num_new must be >= 1, got {num_new}")
        if S + num_new - 1 > self.max_len:
            raise ValueError(
                f"prompt {S} + {num_new} new tokens exceeds max_len "
                f"{self.max_len}")
        tokens = prompt_tokens.to(self.device)
        t0 = time.perf_counter()
        cache = model.init_cache(self.cfg, B, self.max_len, self.cache_dtype,
                                 self.device)
        with obs.span("prefill", cat="serve", batch=B, prompt_len=S):
            logits, cache = prefill(self.cfg, self.params, cache, tokens)
            tok = sample_token(logits, temperature, generator)
            _sync(self.device)
        t1 = time.perf_counter()
        toks = tok
        if num_new > 1:
            out = [tok]
            with obs.span("decode_loop", cat="serve", batch=B,
                          num_new=num_new):
                # the reference's scan also runs a last step whose token
                # it drops
                for _ in range(num_new - 1):
                    logits, cache = model.decode_step(self.cfg, self.params,
                                                      cache, tok)
                    tok = sample_token(logits, temperature, generator)
                    out.append(tok)
                toks = torch.cat(out, dim=1)
                _sync(self.device)
        self.timings = {"prefill_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1}
        m = self.metrics
        m.histogram("ttft_s").observe(self.timings["prefill_s"])
        m.counter("tokens_generated").inc(B * num_new)
        m.counter("requests_finished").inc(B)
        if num_new > 1:
            m.histogram("itl_s").observe(self.timings["decode_s"]
                                         / (num_new - 1))
        return toks


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------
class RetireReason(str, enum.Enum):
    """Why a request left its slot.  ``PREEMPTED`` is transient (the request
    re-queues and later retires with a terminal reason); the rest are
    terminal.  The engine counts one ``retired_<reason>`` metric per
    terminal retirement plus a ``preemptions`` counter."""
    EOS = "eos"
    MAX_NEW = "max_new"
    DEADLINE = "deadline"
    CANCELLED = "cancelled"
    PREEMPTED = "preempted"
    FAULTED = "faulted"


@dataclasses.dataclass
class Request:
    """One generation request moving through the continuous engine.

    ``tokens`` accumulates generated ids (the prompt is not echoed).
    ``deadline_s`` is a wall-clock budget from submit; expiry retires the
    request with ``RetireReason.DEADLINE`` (partial output kept).  After a
    preemption ``resume_token`` holds the last emitted token: re-admission
    prefills ``prompt + tokens[:-1]`` and seeds decode with it instead of
    sampling again, so a preempted greedy request's output equals an
    undisturbed run's."""
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    deadline_s: Optional[float] = None
    retire_reason: Optional[RetireReason] = None
    preemptions: int = 0
    resume_token: Optional[int] = None
    admit_seq: int = -1                  # admission order (victim picking)
    # perf_counter timestamps; 0.0 = not reached yet
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0

    @property
    def expired(self) -> bool:
        return (self.deadline_s is not None
                and time.perf_counter() - self.t_submit > self.deadline_s)


class SlotManager:
    """Fixed-capacity slot allocator.  ``lengths[slot]`` counts the tokens
    written to that slot's cache (prompt + decode writes); the engine
    retires a slot when it reaches the cache length."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots - 1, -1, -1))
        self.active: Dict[int, Request] = {}
        self.lengths = np.zeros((n_slots,), np.int64)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def alloc(self, req: Request, prompt_len: int) -> int:
        slot = self._free.pop()
        req.slot = slot
        self.active[slot] = req
        self.lengths[slot] = prompt_len
        return slot

    def release(self, slot: int) -> None:
        req = self.active.pop(slot)
        req.slot = -1
        self.lengths[slot] = 0
        self._free.append(slot)


class PageAllocator:
    """Ref-counted allocator over the KV pages ``1 .. n_pages - 1`` (page 0
    is the scratch page, never handed out; dead block-table entries point
    at it).  ``alloc`` hands out a free page at refcount 1, ``retain`` adds
    a reference (prefix sharing), ``release`` drops one and returns the
    page to the pool at zero.  A page is never handed out twice while
    referenced and refcounts never go negative: the guards raise
    :class:`PageAccountingError` before either could happen."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least one non-scratch page")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self.refcount = np.zeros((n_pages,), np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if faults.active() and faults.fire("page_exhaustion"):
            raise PageExhausted("page pool exhausted (injected)")
        if not self._free:
            raise PageExhausted("page pool exhausted")
        page = self._free.pop()
        if self.refcount[page] != 0:
            raise PageAccountingError(
                f"free-list page {page} has refcount "
                f"{int(self.refcount[page])}")
        self.refcount[page] = 1
        return page

    def retain(self, page: int) -> None:
        if not 1 <= page < self.n_pages or self.refcount[page] <= 0:
            count = (int(self.refcount[page]) if 0 <= page < self.n_pages
                     else "out of range")
            raise PageAccountingError(
                f"retain of unallocated page {page} (refcount {count})")
        self.refcount[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; True when the page went back to the pool."""
        if not 1 <= page < self.n_pages or self.refcount[page] <= 0:
            raise PageAccountingError(
                f"release of unallocated page {page}: double release or "
                "stale block-table entry")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)
            return True
        return False


class ContinuousBatchingEngine:
    """Slot-based continuous batching: heterogeneous requests share one
    padded decode step (see the module docstring for the two cache modes).

    ``submit`` queues a request and admits it as soon as a slot (and, in
    paged mode, its pages) is free; ``step`` advances every mid-prefill
    slot one chunk and every decoding slot one token, retires finished
    requests and back-fills freed slots; ``run`` steps until queue and
    slots drain.  Greedy when ``temperature <= 0``; otherwise softmax
    sampling from the engine's own ``torch.Generator`` seeded with
    ``seed``.  ``cache_dtype`` defaults to fp32, as the reference's."""

    def __init__(self, cfg: ModelCfg, params, *, n_slots: int = 8,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 temperature: float = 0.0,
                 cache_dtype: torch.dtype = torch.float32, seed: int = 0,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False, nan_guard: bool = True,
                 preempt: bool = True,
                 report_every_s: Optional[float] = None,
                 log_fn: Callable = print, device=None):
        if cfg.family in ("vlm", "encdec"):
            raise NotImplementedError(
                "continuous batching serves token-only families")
        if os.environ.get("REPRO_PAGED_KV", "").lower() in ("0", "off",
                                                            "dense"):
            page_size = None                       # escape hatch
        if page_size is not None and cfg.family not in ("lm", "moe"):
            raise NotImplementedError(
                "paged KV serves the pure-KV families (lm/moe); SSM and "
                "hybrid caches keep dense rings")
        self.device = device_lib.resolve(device)
        self.paged = page_size is not None
        self.page_size = page_size
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_len = n_slots, max_len
        self.eos_id, self.temperature = eos_id, float(temperature)
        self.cache_dtype = cache_dtype
        self.metrics = obs.MetricsRegistry()
        self.report_every_s = report_every_s
        self.log = log_fn
        self._last_report = time.perf_counter()
        dev = self.device
        if self.paged:
            self.n_blocks = -(-max_len // page_size)      # blocks per slot
            if n_pages is None:
                n_pages = 1 + n_slots * self.n_blocks     # + scratch page 0
            self.pages = PageAllocator(n_pages)
            self.cache = model.init_cache(cfg, n_slots, max_len, cache_dtype,
                                          dev, page_size=page_size,
                                          n_pages=n_pages)
            # HOST truth: block tables and reserved-block counts per slot
            self._bt = np.zeros((n_slots, self.n_blocks), np.int32)
            self._nblk = np.zeros((n_slots,), np.int32)
            self._prefilling: Dict[int, int] = {}   # slot -> tokens prefilled
            self.prefill_chunk = prefill_chunk
            self.prefix_cache = bool(prefix_cache)
            self._prefix: Dict[bytes, int] = {}       # hash chain -> page id
            self._page_hash: Dict[int, bytes] = {}    # page id -> hash key
            self.stats = {"prefill_chunks": 0, "prefill_tokens": 0,
                          "prefix_hits": 0, "prefix_pages_shared": 0}
            n_ctl = n_slots * self.n_blocks + n_slots
        else:
            self.cache = model.init_cache(cfg, n_slots, max_len, cache_dtype,
                                          dev, per_slot=True)
            n_ctl = n_slots
        # one device buffer holds the block tables and the write indices
        # every layer reads, so the host refreshes both in one copy
        self._ctl = torch.zeros(n_ctl, dtype=torch.int32, device=dev)
        self._ctl_views(self.cache, self._ctl, n_slots)
        self.tokens = torch.zeros((n_slots, 1), dtype=torch.long, device=dev)
        self.slots = SlotManager(n_slots)
        self.queue: collections.deque = collections.deque()
        self.finished: List[Request] = []
        self._uid = itertools.count()
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self.nan_guard = bool(nan_guard)
        self.preempt_enabled = bool(preempt)
        self._admit_seq = itertools.count()
        # the demoted rungs, held in this engine's calls (``_routes``):
        # ``quant`` ignores the weight sidecars, ``ff`` forces the ff
        # forward to ``split``
        self.demoted: List[str] = []
        self._sidecars = any(quant_lib.ff_quantized(lp.get("mlp"))
                             for lp in params["layers"])

    def _ctl_views(self, cache, ctl, batch: int) -> None:
        """Point every layer's block table and write index at views of the
        control buffer ``ctl`` (block tables first, then the indices)."""
        n_bt = ctl.numel() - batch
        idx = ctl[n_bt:]
        bt = ctl[:n_bt].view(batch, -1) if n_bt else None
        for lc in cache:
            lc["kv"]["idx"] = idx
            if bt is not None:
                lc["kv"]["block_table"] = bt

    def _tokens_in(self, seq) -> torch.Tensor:
        return torch.as_tensor(np.asarray(seq, np.int64),
                               device=self.device)[None, :]

    def _sample(self, logits) -> torch.Tensor:
        if self.temperature > 0.0:
            # a lane with non-finite logits is flagged bad and its token
            # dropped; keep the sampler's input finite all the same
            logits = torch.nan_to_num(logits, nan=0.0, posinf=0.0,
                                      neginf=0.0)
            return sample_token(logits, self.temperature, self._gen)
        return sample_token(logits, 0.0)

    # -- the decode step ----------------------------------------------------
    def _batch_step(self, poison: bool = False):
        """Decode every lane one token over the shared cache (in place).
        ``poison`` (the ``nan_logits`` fault) multiplies the logits by NaN.
        Returns (next tokens (B, 1), non-finite-lane mask (B,))."""
        with torch.no_grad(), self._routes():
            logits, _ = model.decode_step(self.cfg, self.params, self.cache,
                                          self.tokens)
        if poison:
            logits = logits * float("nan")
        if self.nan_guard:
            bad = ~torch.isfinite(logits).all(dim=2).all(dim=1)
        else:
            bad = torch.zeros(logits.shape[0], dtype=torch.bool,
                              device=logits.device)
        return self._sample(logits), bad

    def _prefill_one(self, seq):
        """Dense mode: prefill one prompt on a fresh B=1 per-slot cache.
        Returns (first token (1, 1), the B=1 cache)."""
        cache1 = model.init_cache(self.cfg, 1, self.max_len,
                                  self.cache_dtype, self.device,
                                  per_slot=True)
        with torch.no_grad(), self._routes():
            logits, cache1 = model.prefill(self.cfg, self.params, cache1,
                                           self._tokens_in(seq))
        return self._sample(logits), cache1

    def _write_slot(self, cache1, slot: int) -> None:
        """Copy a B=1 cache's rings into row ``slot`` of the slot cache
        (the write index is the host's, pushed before every step)."""
        for full, one in zip(self.cache, cache1):
            full["kv"]["k"][slot] = one["kv"]["k"][0]
            full["kv"]["v"][slot] = one["kv"]["v"][0]

    # -- paged machinery ----------------------------------------------------
    def _chunk(self, slot: int, seq, pos: int) -> torch.Tensor:
        """Paged prefill of one prompt chunk for one slot, as a B=1 view
        over the shared pools: the K/V rows land straight in the slot's
        reserved pages.  The view's block table row and write index are one
        host-to-device copy.  Returns the token sampled after the chunk."""
        ctl = torch.as_tensor(np.concatenate(
            [self._bt[slot], np.asarray([pos], np.int32)])).to(self.device)
        view = [{"kv": dict(lc["kv"])} for lc in self.cache]
        self._ctl_views(view, ctl, 1)
        with torch.no_grad(), self._routes():
            logits, _ = model.prefill(self.cfg, self.params, view,
                                      self._tokens_in(seq))
        return self._sample(logits)

    def _prefill_tokens(self, req: Request) -> np.ndarray:
        """The sequence this request's (re-)prefill writes: the prompt,
        plus after a preemption every generated token but the last (which
        seeds decode through ``resume_token``)."""
        if req.resume_token is None:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(req.tokens[:-1], np.int32)])

    def _advance_prefill(self, slot: int) -> None:
        """Prefill the next chunk of ``slot``'s prompt; after the last
        chunk, emit the first token and hand the slot to the decode batch
        (a resumed request re-seeds decode with its last emitted token)."""
        pos = self._prefilling[slot]
        req = self.slots.active[slot]
        seq = self._prefill_tokens(req)
        S = len(seq)
        chunk = (S - pos if not self.prefill_chunk
                 else min(self.prefill_chunk, S - pos))
        with obs.span("prefill_chunk", cat="serve", slot=slot, pos=pos,
                      chunk=chunk, prompt_len=S,
                      resumed=req.resume_token is not None):
            tok = self._chunk(slot, seq[pos:pos + chunk], pos)
            if obs.enabled():
                # only a traced run waits here: untraced chunks stay
                # queued (the decode harvest waits once per engine step)
                _sync(self.device)
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_tokens"] += chunk
        self.metrics.counter("prefill_tokens").inc(chunk)
        pos += chunk
        if pos >= S:
            del self._prefilling[slot]
            self._register_prefix(req, slot)
            if req.resume_token is not None:
                # nothing new is emitted: the sampled token re-derives the
                # last emitted one
                self.tokens[slot, 0] = req.resume_token
                req.resume_token = None
                req.retire_reason = None
            else:
                self.tokens[slot] = tok[0]
                self._emit(req, int(tok[0, 0]))
        else:
            self._prefilling[slot] = pos

    def _prefix_keys(self, prompt: np.ndarray) -> List[bytes]:
        """Rolling sha1 chain over the FULL pages of a prompt: key i
        commits to ``prompt[:(i+1) * page_size]`` (its int32 bytes), so
        equal keys mean equal token prefixes and equal K/V pages."""
        h = hashlib.sha1()
        keys = []
        P = self.page_size
        for i in range(len(prompt) // P):
            h.update(np.ascontiguousarray(prompt[i * P:(i + 1) * P],
                                          np.int32).tobytes())
            keys.append(h.digest())
        return keys

    def _match_prefix(self, prompt: np.ndarray):
        """Longest registered full-page prefix of ``prompt``, capped so at
        least one prompt token remains to prefill (the logits that seed
        decode come from this request's own forward)."""
        if not self.prefix_cache:
            return 0, []
        limit = (len(prompt) - 1) // self.page_size
        pages: List[int] = []
        for key in self._prefix_keys(prompt)[:limit]:
            pid = self._prefix.get(key)
            if pid is None:
                break
            pages.append(pid)
        return len(pages), pages

    def _register_prefix(self, req: Request, slot: int) -> None:
        """Publish a prefilled prompt's full pages for later sharers.  The
        registry holds no reference: an entry goes when its page returns
        to the pool."""
        if not self.prefix_cache:
            return
        for i, key in enumerate(self._prefix_keys(req.prompt)):
            pid = int(self._bt[slot, i])
            if key in self._prefix or pid in self._page_hash:
                continue
            self._prefix[key] = pid
            self._page_hash[pid] = key

    def _release_page(self, page: int) -> None:
        if self.pages.release(page):        # back in the pool: unpublish
            key = self._page_hash.pop(page, None)
            if key is not None:
                self._prefix.pop(key, None)

    def _release_slot_pages(self, slot: int) -> None:
        for i in range(int(self._nblk[slot])):
            self._release_page(int(self._bt[slot, i]))
        self._bt[slot] = 0
        self._nblk[slot] = 0

    def _sync_control(self) -> None:
        """Push HOST truth to the device in one copy: each decoding lane's
        write index (its length) and, paged, its block table.  Free and
        mid-prefill lanes get index 0 and scratch page 0, so their padding
        writes never touch a live page."""
        with obs.span("sync_control", cat="serve"):
            idx = self.slots.lengths.astype(np.int32)
            live = [s in self.slots.active
                    and not (self.paged and s in self._prefilling)
                    for s in range(self.n_slots)]
            idx[~np.asarray(live)] = 0
            if self.paged:
                bt = self._bt.copy()
                bt[~np.asarray(live)] = 0
                host = np.concatenate([bt.reshape(-1), idx])
            else:
                host = idx
            self._ctl.copy_(torch.from_numpy(host))

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``'s request to relieve page-pool pressure: release
        its pages, remember its last emitted token and re-queue it at the
        back.  The redo is one re-prefill of ``prompt + generated[:-1]``;
        under greedy decoding the resumed output equals an undisturbed
        run's."""
        req = self.slots.active[slot]
        with obs.span("preempt", cat="serve", uid=req.uid, slot=slot,
                      generated=len(req.tokens),
                      pages_freed=int(self._nblk[slot])):
            req.retire_reason = RetireReason.PREEMPTED
            req.preemptions += 1
            req.resume_token = req.tokens[-1]
            self._release_slot_pages(slot)
            self.slots.release(slot)
            self.queue.append(req)
            self.metrics.counter("preemptions").inc()
            obs.instant("preempted", cat="serve", uid=req.uid)
        self._update_occupancy()

    def _preempt_for(self, req: Request, pages_short: int) -> bool:
        """Free at least ``pages_short`` pages for ``req`` by preempting
        victims, youngest-admitted first.  A victim is decoding (not mid-
        prefill, at least one token) with every page private (refcount 1).
        Only a request never preempted itself may preempt, so preemptions
        are bounded by submissions and cannot cycle."""
        if not self.preempt_enabled or req.preemptions:
            return False
        while self.pages.free_pages < pages_short:
            victims = [
                s for s, r in self.slots.active.items()
                if s not in self._prefilling and r.tokens
                and all(self.pages.refcount[int(self._bt[s, i])] == 1
                        for i in range(int(self._nblk[s])))]
            if not victims:
                return False
            self._preempt(max(victims,
                              key=lambda s: self.slots.active[s].admit_seq))
        return True

    def _admit_paged(self) -> None:
        """Admit queued requests while a slot AND enough pages are free.
        Reservation is exact and up front: ``ceil((S + max_new - 1) / P)``
        pages cover every K/V row the request can write, so an admitted
        request never runs out.  Prefix-matched pages are retained, not
        allocated, and their tokens skipped by the prefill.  When the head
        request does not fit, the engine first tries preemption, then
        blocks the queue.  A :class:`PageExhausted` mid-admission rolls
        the partial reservation back and re-queues the request at the
        front."""
        while self.queue and self.slots.free_slots:
            req = self.queue[0]
            seq = self._prefill_tokens(req)
            # rows the request will ever hold, invariant under preemption
            rows = len(req.prompt) + req.max_new - 1
            nblk = max(1, -(-rows // self.page_size))
            m, shared = self._match_prefix(seq)
            if self.pages.free_pages < nblk - m:
                if not self._preempt_for(req, nblk - m):
                    return      # no eligible victim: head-of-line block
                # preemption may have unpublished prefix pages: re-match
                m, shared = self._match_prefix(seq)
                if self.pages.free_pages < nblk - m:
                    return
            self.queue.popleft()
            slot = self.slots.alloc(req, len(seq))
            req.admit_seq = next(self._admit_seq)
            with obs.span("admit", cat="serve", uid=req.uid, slot=slot,
                          pages=nblk, prefix_pages=m,
                          resumed=req.resume_token is not None,
                          queued=len(self.queue)):
                try:
                    for i, pid in enumerate(shared):
                        self.pages.retain(pid)
                        self._bt[slot, i] = pid
                        self._nblk[slot] = i + 1
                    for i in range(m, nblk):
                        self._bt[slot, i] = self.pages.alloc()
                        self._nblk[slot] = i + 1
                except PageExhausted:
                    # roll the partial reservation back; the request
                    # returns to the head of the queue
                    self._release_slot_pages(slot)
                    self.slots.release(slot)
                    self.queue.appendleft(req)
                    self.metrics.counter("admission_backoffs").inc()
                    obs.instant("admit_backoff", cat="serve", uid=req.uid)
                    self._update_occupancy()
                    return
                if m:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_pages_shared"] += m
                    self.metrics.counter("prefix_hits").inc()
                    self.metrics.counter("prefix_tokens_skipped").inc(
                        m * self.page_size)
                self._update_occupancy()
                self._prefilling[slot] = m * self.page_size
                if not self.prefill_chunk:
                    # unchunked: the whole remaining prompt is one chunk,
                    # so admission completes the prefill as in dense mode
                    self._advance_prefill(slot)

    # -- request lifecycle --------------------------------------------------
    def submit(self, prompt, max_new: int, *,
               deadline_s: Optional[float] = None) -> int:
        """Queue a prompt ((S,) ints) for up to ``max_new`` generated
        tokens; returns its uid (the key into :meth:`run`'s result).
        Requests that can never be served raise :class:`AdmissionError`
        here, before queueing."""
        if torch.is_tensor(prompt):
            prompt = prompt.cpu().numpy()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new - 1 > self.max_len:
            self.metrics.counter("admission_rejects").inc()
            obs.instant("admission_reject", cat="serve", reason="max_len",
                        prompt_len=int(prompt.size), max_new=max_new)
            raise AdmissionError(
                f"prompt {prompt.size} + {max_new} new tokens exceeds "
                f"max_len {self.max_len}")
        if max_new < 1:
            self.metrics.counter("admission_rejects").inc()
            raise AdmissionError("max_new must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            self.metrics.counter("admission_rejects").inc()
            raise AdmissionError(f"deadline_s must be positive, "
                                 f"got {deadline_s}")
        if self.paged:
            need = max(1, -(-(prompt.size + max_new - 1) // self.page_size))
            if need > self.pages.n_pages - 1:
                self.metrics.counter("admission_rejects").inc()
                obs.instant("admission_reject", cat="serve",
                            reason="never_fits", pages_needed=need)
                raise AdmissionError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.pages.n_pages - 1}")
        req = Request(uid=next(self._uid), prompt=prompt, max_new=max_new,
                      deadline_s=deadline_s, t_submit=time.perf_counter())
        self.queue.append(req)
        self.metrics.counter("requests_submitted").inc()
        self._admit()
        self._update_occupancy()
        return req.uid

    def cancel(self, uid: int) -> bool:
        """Cancel a queued or running request: it retires at once with
        ``RetireReason.CANCELLED``, keeping its tokens so far.  False when
        ``uid`` is unknown or already finished."""
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[i]
                self._retire(req, RetireReason.CANCELLED)
                self._update_occupancy()
                return True
        for slot, req in list(self.slots.active.items()):
            if req.uid == uid:
                self._retire(req, RetireReason.CANCELLED)
                self._admit()
                return True
        return False

    def _check_deadlines(self) -> None:
        """Retire every queued or active request whose deadline expired;
        runs once per step, the engine's scheduling quantum."""
        expired_q = [r for r in self.queue if r.expired]
        if expired_q:
            live = {id(r) for r in expired_q}
            self.queue = collections.deque(
                r for r in self.queue if id(r) not in live)
        for req in expired_q:
            self._retire(req, RetireReason.DEADLINE)
        for slot, req in list(self.slots.active.items()):
            if req.expired:
                self._retire(req, RetireReason.DEADLINE)
        if expired_q:
            self._update_occupancy()

    def _admit(self) -> None:
        """Move queued requests into free slots (prefill + slot write)."""
        if self.paged:
            self._admit_paged()
            return
        while self.queue and self.slots.free_slots:
            req = self.queue.popleft()
            slot = self.slots.alloc(req, len(req.prompt))
            with obs.span("admit", cat="serve", uid=req.uid, slot=slot,
                          queued=len(self.queue)):
                with obs.span("prefill", cat="serve", slot=slot,
                              prompt_len=len(req.prompt)):
                    tok0, cache1 = self._prefill_one(req.prompt)
                    self._write_slot(cache1, slot)
                    first = int(tok0[0, 0])      # waits for the prefill
                self.tokens[slot] = tok0[0]
                self._emit(req, first)

    def _emit(self, req: Request, token: int) -> None:
        req.tokens.append(token)
        now = time.perf_counter()
        if len(req.tokens) == 1:
            req.t_first = now
            self.metrics.histogram("ttft_s").observe(now - req.t_submit)
        self.metrics.counter("tokens_generated").inc()
        if self.eos_id is not None and token == self.eos_id:
            self._retire(req, RetireReason.EOS)
        elif (len(req.tokens) >= req.max_new
              or self.slots.lengths[req.slot] >= self.max_len):  # row full
            self._retire(req, RetireReason.MAX_NEW)

    def _retire(self, req: Request, reason: RetireReason) -> None:
        """Terminal retirement: record the reason, free the slot and its
        pages, move the request to ``finished``.  Every exit path funnels
        through here, so the ``retired_<reason>`` counters are exact."""
        now = time.perf_counter()
        with obs.span("retire", cat="serve", uid=req.uid, slot=req.slot,
                      reason=reason.value, n_tokens=len(req.tokens)):
            req.retire_reason = reason
            req.t_done = now
            if len(req.tokens) > 1:
                self.metrics.histogram("itl_s").observe(
                    (now - req.t_first) / (len(req.tokens) - 1))
            self.metrics.counter("requests_finished").inc()
            self.metrics.counter(f"retired_{reason.value}").inc()
            if req.slot >= 0:
                if self.paged:
                    self._prefilling.pop(req.slot, None)
                    self._release_slot_pages(req.slot)
                self.slots.release(req.slot)
                self._update_occupancy()
            self.finished.append(req)

    # -- NaN guard + demotion ladder ----------------------------------------
    # the demotion ladder, in the order it is walked
    LADDER = ("quant", "ff")

    @contextlib.contextmanager
    def _routes(self):
        """The context of this engine's model calls: its demoted routes."""
        with quant_lib.disabled("quant" in self.demoted), \
                kops.force_ff_route("split" if "ff" in self.demoted
                                    else None):
            yield

    def _on_safe_route(self, rung: str) -> bool:
        """Does ``rung`` run its safe route already?  ``quant``: the
        quantized routes are off, or no ff module of the params carries
        sidecars; ``ff``: the ff forward runs split anyway."""
        if rung == "quant":
            return not (quant_lib.enabled() and self._sidecars)
        return kops.ff_route() == "split"

    def _demote_next(self) -> bool:
        """Take the next rung of :attr:`LADDER` for this engine's calls,
        passing over (but recording) rungs already on their safe route.
        False when no rung is left to take: the caller then retires the
        still-bad lanes as ``FAULTED``."""
        for rung in self.LADDER:
            if rung in self.demoted:
                continue
            self.demoted.append(rung)
            if self._on_safe_route(rung):
                continue
            obs.route_event("demote", rung)
            self.metrics.counter("demotions").inc()
            return True
        return False

    def reset_demotions(self) -> None:
        """Restore the routes from before any demotion (after the fault
        behind them was fixed)."""
        self.demoted.clear()

    def _decode_once(self, decoding: List[int]):
        """The batch decode step with NaN containment: on a non-finite
        lane, (1) retry once on the same route (the step rewrites the same
        cache rows from the same tokens, so the state is as before), (2)
        demote the ff rung on the next attempt, (3) with the ladder
        exhausted, commit the step and let the caller retire the bad lanes.
        Tokens and the bad-lane mask come back in one copy.  Returns
        (emitted tokens, bad-lane mask) as numpy arrays.  The ``nan_logits``
        fault site is checked once per attempt."""
        attempt = 0
        while True:
            poison = (faults.active()
                      and faults.fire("nan_logits") is not None)
            tok, bad = self._batch_step(poison)
            host = torch.stack([tok[:, 0], bad.to(tok.dtype)]).cpu().numpy()
            bad_h = host[1].astype(bool)
            bad_slots = [s for s in decoding if bad_h[s]]
            if not bad_slots:
                break
            self.metrics.counter("nan_steps").inc()
            obs.instant("nan_detected", cat="serve", attempt=attempt,
                        slots=len(bad_slots))
            if attempt > 0 and not self._demote_next():
                obs.instant("nan_unrecovered", cat="serve",
                            slots=len(bad_slots))
                break
            attempt += 1
        self.tokens = tok
        return host[0], bad_h

    def step(self) -> List[Request]:
        """One engine step; returns the requests finished in it.  Paged
        mode first advances each mid-prefill slot one chunk (a slot whose
        prompt completes joins this step's decode), then every decoding
        slot takes its token.  Expired deadlines are swept first; lanes
        whose logits stay non-finite after the retry and the ladder retire
        as ``FAULTED``."""
        before = len(self.finished)
        self._check_deadlines()
        if faults.active():
            sp = faults.fire("slow_step")
            if sp is not None and sp.ms:
                with obs.span("slow_step_fault", cat="fault", ms=sp.ms):
                    time.sleep(sp.ms / 1000.0)
        if self.paged and self._prefilling:
            for slot in sorted(self._prefilling):
                self._advance_prefill(slot)
            self._admit()           # chunk completions may have freed slots
        decoding = [s for s in self.slots.active
                    if not (self.paged and s in self._prefilling)]
        if not decoding:
            self._admit()
            self._maybe_report()
            return self.finished[before:]
        self._sync_control()
        t0 = time.perf_counter()
        with obs.span("decode_step", cat="serve", batch=len(decoding)):
            emitted, bad = self._decode_once(decoding)
        self.metrics.histogram("decode_step_s").observe(
            time.perf_counter() - t0)
        for slot in decoding:
            req = self.slots.active[slot]
            if bad[slot]:
                # non-finite after the whole ladder: drop the token
                self._retire(req, RetireReason.FAULTED)
                continue
            self.slots.lengths[slot] += 1
            self._emit(req, int(emitted[slot]))
        self._admit()
        self._update_occupancy()
        self._maybe_report()
        return self.finished[before:]

    # -- telemetry ----------------------------------------------------------
    def _update_occupancy(self) -> None:
        """Refresh the load gauges wherever they can change, so their
        high-water marks are exact."""
        m = self.metrics
        m.gauge("queue_depth").set(len(self.queue))
        m.gauge("active_slots").set(len(self.slots.active))
        if self.paged:
            m.gauge("page_pool_used").set(
                self.pages.n_pages - 1 - self.pages.free_pages)

    def _maybe_report(self) -> None:
        if self.report_every_s is None:
            return
        now = time.perf_counter()
        if now - self._last_report >= self.report_every_s:
            self._last_report = now
            self.log(f"[serve] {obs.format_serving_line(self.metrics)}")

    def metrics_summary(self) -> dict:
        """JSON-ready snapshot of the serving metrics (the payload of the
        launcher's ``--metrics-json``), with the fault tallies while a
        schedule is armed and any demoted rungs."""
        snap = self.metrics.snapshot()
        if faults.active():
            snap["faults"] = faults.snapshot()
        if self.demoted:
            snap["demoted"] = list(self.demoted)
        return snap

    def format_summary(self) -> str:
        return obs.format_serving_line(self.metrics)

    def run(self, deadline_s: Optional[float] = None) -> Dict[int, List[int]]:
        """Step until every queued and active request finishes.  Returns
        {uid: generated tokens} (kept for every terminal reason).
        ``deadline_s`` bounds the whole drain: overrun raises
        :class:`DeadlineExceeded` with every request intact."""
        t0 = time.perf_counter()
        while self.slots.active or self.queue:
            if (deadline_s is not None
                    and time.perf_counter() - t0 > deadline_s):
                raise DeadlineExceeded(
                    f"run() exceeded its {deadline_s}s drain budget with "
                    f"{len(self.slots.active)} active / {len(self.queue)} "
                    "queued requests")
            self.step()
        self._update_occupancy()
        out = {r.uid: r.tokens for r in self.finished}
        self.finished = []
        return out
