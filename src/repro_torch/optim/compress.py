"""Gradient compression with error feedback (port of
``repro.optim.compress``).

Two codecs, each wrapped in error feedback (the residual between the true
and the decoded gradient is carried to the next step, which is what makes
a lossy reduction converge):

* ``int8`` — symmetric quantization with one scale per parameter,
  ``scale = max|g| / 127`` (``repro_torch.quant.quant_int8``);
* ``topk`` — keep the top ``topk_frac`` of each parameter's entries by
  magnitude.

A parameter is a leaf of the reference's layer-stacked tree: the port
keeps each layer's tensor apart, and the layers of one parameter (one
``tree.reference_key``) share its scale or threshold, as the reference
computes them over the stacked array.

:meth:`Compressor.compress_decompress` is the simulated lossy reduction
the train step applies before the optimizer update.  It reads the
gradients as one vector and the error state as one packed buffer
(``tree.pack``), so the pass is a few vector kernels plus one reduction
per leaf for the scales (one top-k per parameter), never one scale over
the whole buffer.  The reference's ``compressed_psum``, a
collective, waits for ROADMAP A.11.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import tree
from repro_torch.quant import _EPS


@dataclasses.dataclass(frozen=True)
class Compressor:
    codec: str = "int8"        # "int8" | "topk" | "none"
    topk_frac: float = 0.01

    def __post_init__(self):
        if self.codec not in ("int8", "topk", "none"):
            raise ValueError(f"unknown gradient codec {self.codec!r} "
                             "(know int8, topk, none)")

    def init(self, params) -> dict:
        """``{"err": fp32 zeros shaped like params}`` in one packed buffer
        (``{}`` for ``none``)."""
        if self.codec == "none":
            return {}
        return {"err": tree.pack(tree.map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))}

    def compress_decompress(self, grads, state) -> Tuple[dict, dict]:
        """(decoded grads in their own dtypes, new state); the state given
        is not changed."""
        if self.codec == "none":
            return grads, state
        paths, gl = zip(*tree.leaves_with_paths(grads))
        el = tree.leaves(state["err"])
        sizes = [g.numel() for g in gl]
        gc = tree.flat(gl).to(torch.float32) + tree.flat(el)
        pieces = torch.split(gc, sizes)
        # the parameter of each leaf: its key in the layer-stacked tree
        keys = [tree.reference_key(p)[0] for p in paths]
        group = {k: i for i, k in enumerate(dict.fromkeys(keys))}
        gid = torch.tensor([group[k] for k in keys], device=gc.device)
        per_elem = torch.tensor(sizes, device=gc.device)
        if self.codec == "int8":
            amax = torch.zeros(len(group), device=gc.device).scatter_reduce(
                0, gid, torch.stack([p.abs().amax() for p in pieces]),
                "amax")
            scale = torch.repeat_interleave((amax / 127.0 + _EPS)[gid],
                                            per_elem)
            # the int8 payload, decoded: its integers are exact in fp32
            dec = torch.clamp(torch.round(gc / scale), -127.0, 127.0) * scale
        else:
            members = {}
            for k, p in zip(keys, pieces):
                members.setdefault(k, []).append(p)
            thresh = torch.stack([
                torch.cat(ps).abs().topk(max(1, int(
                    sum(p.numel() for p in ps) * self.topk_frac))).values[-1]
                for ps in members.values()])
            keep = gc.abs() >= torch.repeat_interleave(thresh[gid], per_elem)
            dec = gc * keep.to(gc.dtype)
        err = tree.unflat(gc - dec, state["err"])
        out = iter(torch.split(dec, sizes))
        decoded = tree.map(lambda g: next(out).view(g.shape).to(g.dtype),
                           grads)
        return decoded, {"err": err}
