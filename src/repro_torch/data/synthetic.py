"""Deterministic, resumable, host-sharded synthetic LM data (port of
``repro.data.synthetic.SyntheticLM``).

The stream is stateless: batch ``i`` of shard ``s`` is a function of
``(seed, i, s)`` only, so a resumed run and a re-sharded one see exactly
the batches they would have seen, and each host builds only its shard.
The token process: a fixed random permutation ``perm`` of the vocabulary;
with probability ``p_copy`` the next token is ``perm[prev]``, otherwise
uniform noise.  ``labels`` are ``tokens`` shifted by one.

The walk is built without a loop over the sequence: a token ``k`` copy
steps after the last fresh draw ``a`` is ``perm^k(a)``, and ``perm^k`` is
applied bit by bit from a cached table of ``perm^(2^b)``, so a batch costs
``log2(seq_len)`` gathers whatever ``p_copy`` is.

Each batch is drawn on the host from an explicit ``torch.Generator``
seeded from ``(seed, i, s)`` and then copied to ``device`` without a
host sync.  The draws are
not ``jax.random``'s, so the stream does not equal the reference's bit for
bit; it has the same semantics.  Tests that compare the two packages feed
both the same numpy batches.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_lib


def _generator(*words: int) -> torch.Generator:
    seed = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & ((1 << 63) - 1))


@functools.lru_cache(maxsize=8)
def _perm_powers(vocab_size: int, seed: int, n: int) -> torch.Tensor:
    """(n, vocab_size): row b is ``perm`` composed ``2**b`` times."""
    rows = [torch.randperm(vocab_size, generator=_generator(seed + 7919))]
    for _ in range(1, n):
        rows.append(rows[-1][rows[-1]])
    return torch.stack(rows)


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` copied to ``dev``; to a card from pinned memory, so the copy
    queues behind the work already on the stream instead of waiting for
    it (the trainer builds the next batch while the device runs a step)."""
    t = t.contiguous()
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    p_copy: float = 0.8
    shard: int = 0
    num_shards: int = 1
    device: Optional[str] = None        # None: cuda (raises without it)

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {self.num_shards} shards")

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_shards

    def perm(self) -> torch.Tensor:
        return _perm_powers(self.vocab_size, self.seed, 1)[0]

    def batch(self, step: int) -> dict:
        """{"tokens", "labels": (local_batch, seq_len) int64} on the
        device."""
        dev = device_lib.resolve(self.device)
        gen = _generator(self.seed, step, self.shard)
        B, S, V = self.local_batch, self.seq_len, self.vocab_size
        first = torch.randint(0, V, (B,), generator=gen)
        noise = torch.randint(0, V, (B, S), generator=gen)
        use_copy = torch.rand((B, S), generator=gen) < self.p_copy
        # seq[:, 0] = first; seq[:, t + 1] = perm[seq[:, t]] where
        # use_copy[:, t], else noise[:, t].  Position j holds
        # perm^(j - a)(fresh[a]), a the last fresh draw at or before j.
        fresh = torch.cat([first[:, None], noise], dim=1)
        is_fresh = torch.cat([torch.ones(B, 1, dtype=torch.bool),
                              ~use_copy], dim=1)
        pos = torch.arange(S + 1)
        anchor = torch.where(is_fresh, pos, 0).cummax(dim=1).values
        hops = pos - anchor
        seq = fresh.gather(1, anchor)
        pows = _perm_powers(V, self.seed, max(S.bit_length(), 1))
        for b in range(pows.shape[0]):
            seq = torch.where((hops >> b) & 1 == 1, pows[b][seq], seq)
        return {"tokens": _to(seq[:, :-1], dev),
                "labels": _to(seq[:, 1:], dev)}

    def reshard(self, shard: int, num_shards: int) -> "SyntheticLM":
        return dataclasses.replace(self, shard=shard, num_shards=num_shards)
