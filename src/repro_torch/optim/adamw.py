"""AdamW with decoupled weight decay, a decay mask and a configurable moment
dtype (port of ``repro.optim.adamw``).

``update`` is functional, as in the reference: it returns new params and a
new state and leaves its arguments alone; the train step decides whether
to copy them in (its skip-step).

The decay mask is decided on the reference's layout, where each ``layers``
subtree is stacked on a leading axis, so a per-layer leaf has one more
dimension there than here.  The reference's rule, "rank >= 2 and no
``norm``/``scale``/``A_log``/``dt_bias`` in the key", therefore decays the
ff biases ``layers/mlp/{up,down}/b`` (stacked ``(L, d)``) though its
docstring says "skip biases"; the port follows the rule, not the
docstring (ROADMAP C.3).  The 1-D ``final_norm`` leaves and the
``norm1``/``norm2`` leaves are not decayed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch import tree

_NO_DECAY = ("norm", "scale", "A_log", "dt_bias")


def default_decay_mask(path, leaf) -> bool:
    """Decay a leaf whose rank in the reference's stacked layout is >= 2
    and whose reference key names no norm, scale, ``A_log`` or
    ``dt_bias``."""
    key, stacked = tree.reference_key(path)
    if leaf.dim() + stacked < 2:
        return False
    return not any(s in key for s in _NO_DECAY)


def _flat(leaves) -> torch.Tensor:
    """The leaves, in order, as one fp32 vector: no copy when they are
    packed fp32 (``tree.pack``), so read it, never write it."""
    return tree.flat(leaves).to(torch.float32)


@functools.lru_cache(maxsize=8)
def _decay_flags(spans: tuple, device: torch.device) -> torch.Tensor:
    """A bool per element of the flattened params: its leaf is decayed."""
    flags = torch.tensor([f for f, _ in spans], dtype=torch.bool)
    counts = torch.tensor([n for _, n in spans], dtype=torch.int64)
    return torch.repeat_interleave(flags, counts).to(device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]   # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"
    # fp32 master copy: params stay in their (e.g. bf16) dtype while the
    # update accumulates in fp32
    master: bool = False

    def init(self, params) -> dict:
        """Moments (and the master copy) packed, each tree one buffer
        (``tree.pack``), so ``update`` reads them without a copy."""
        md = (torch.bfloat16 if self.moment_dtype == "bfloat16"
              else torch.float32)
        ls = tree.leaves(params)
        size, dev = sum(p.numel() for p in ls), ls[0].device
        st = {
            "m": tree.unflat(torch.zeros(size, dtype=md, device=dev), params),
            "v": tree.unflat(torch.zeros(size, dtype=md, device=dev), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if self.master:
            st["master"] = tree.unflat(_flat(ls).clone(), params)
        return st

    @torch.no_grad()
    def update(self, grads, state, params):
        """Returns (new_params, new_state, {"grad_norm", "lr"}), all new
        tensors; nothing is read back to the host.

        Each operand is one fp32 vector (its packed buffer, or the leaves
        concatenated) updated by a few whole-vector ops (elementwise, so
        each element gets the reference's arithmetic), instead of a dozen
        ops per leaf: the step then costs tens of launches, not thousands.
        The new params and state are packed views of the new vectors."""
        step = state["step"] + 1
        lr = self.lr(step)
        g = _flat(tree.leaves(grads))
        gnorm = torch.linalg.vector_norm(g)
        if self.clip_norm is not None:
            g = g * torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        sf = step.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, sf)
        c2 = 1.0 - torch.pow(b2, sf)
        m = b1 * _flat(tree.leaves(state["m"])) + (1 - b1) * g
        v = b2 * _flat(tree.leaves(state["v"])) + (1 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        base = _flat(tree.leaves(state.get("master", params)))
        if self.weight_decay:
            spans = tuple((default_decay_mask(path, p), p.numel())
                          for path, p in tree.leaves_with_paths(params))
            u = torch.where(_decay_flags(spans, u.device),
                            u + self.weight_decay * base, u)
        p_new = base - lr * u
        md = tree.leaves(state["m"])[0].dtype
        new_state = {"m": tree.unflat(m.to(md), params),
                     "v": tree.unflat(v.to(md), params), "step": step}
        if self.master:
            new_state["master"] = tree.unflat(p_new, params)
        pd = tree.leaves(params)[0].dtype
        return (tree.unflat(p_new.to(pd), params), new_state,
                {"grad_norm": gnorm, "lr": lr})
