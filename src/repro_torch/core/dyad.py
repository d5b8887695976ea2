"""DYAD structured near-sparse linear layers (port of ``repro.core.dyad``).

A DYAD layer approximates a dense linear ``y = x @ W.T + b`` with the sum of
two block-structured components, each a ``(n_dyad, d_out, d_in)`` tensor
(``f_in = n_dyad * d_in``, ``f_out = n_dyad * d_out``):

* ``w1`` — BLOCKDIAG, block-diagonal;
* ``w2`` — BLOCKTRANS, block-diagonal after a strided feature permutation:
  on the input for ``it``, on the output for ``ot``, on both for ``dt``.

Activations are feature-last (``x: (..., f_in) -> y: (..., f_out)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]

VARIANTS = ("it", "ot", "dt")


@dataclasses.dataclass(frozen=True)
class DyadSpec:
    """Static configuration of one DYAD layer."""

    n_dyad: int = 4
    variant: str = "it"           # "it" | "ot" | "dt"
    cat: bool = False             # paper's -CAT: one bmm over 2*n_dyad blocks
    use_kernel: bool = False      # route through the hand-written kernel
    use_kernel_bwd: bool = True   # its kernel backward (False: einsum VJP)

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown DYAD variant {self.variant!r}")
        if self.n_dyad < 1:
            raise ValueError("n_dyad must be >= 1")


def resolve_n_dyad(f_in: int, f_out: int, requested: int) -> int:
    """Largest n <= requested dividing both feature dims (paper App. 5.1)."""
    n = min(requested, f_in, f_out)
    while n > 1 and (f_in % n or f_out % n):
        n -= 1
    return max(n, 1)


def init(generator: torch.Generator, f_in: int, f_out: int, spec: DyadSpec,
         *, bias: bool = True, dtype: torch.dtype = torch.float32,
         device=None) -> Params:
    """Paper-faithful init: uniform(-k, k) with k = 1/sqrt(f_in)."""
    n = spec.n_dyad
    if f_in % n or f_out % n:
        raise ValueError(
            f"DYAD dims must divide n_dyad: f_in={f_in} f_out={f_out} n_dyad={n}")
    d_in, d_out = f_in // n, f_out // n
    k = 1.0 / math.sqrt(f_in)

    def u(*shape):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.uniform_(-k, k, generator=generator)

    p: Params = {"w1": u(n, d_out, d_in), "w2": u(n, d_out, d_in)}
    if bias:
        p["b"] = u(f_out)
    return p


def _block_views(x: torch.Tensor, n: int, d_in: int, variant: str):
    """Return (x1, x2): the block-contiguous and (maybe) strided views.

    x1[..., g, i] = x[..., g*d_in + i]       (BLOCKDIAG input, all variants)
    x2[..., g, i] = x[..., i*n + g]          (BLOCKTRANS input, it/dt)
    x2 = x1                                   (ot — permutation is on the output)
    """
    lead = x.shape[:-1]
    x1 = x.reshape(*lead, n, d_in)
    if variant in ("it", "dt"):
        x2 = x.reshape(*lead, d_in, n).transpose(-1, -2)
    else:
        x2 = x1
    return x1, x2


def _combine_outputs(z1: torch.Tensor, z2: torch.Tensor,
                     variant: str) -> torch.Tensor:
    """Fold per-block outputs ``(..., n, d_out)`` back to ``(..., f_out)``:
    y1[..., g*d_out + o] = z1[..., g, o]; y2[..., o*n + g] = z2[..., g, o]
    for ot/dt, block-contiguous for it."""
    lead = z1.shape[:-2]
    f_out = z1.shape[-2] * z1.shape[-1]
    y1 = z1.reshape(*lead, f_out)
    if variant in ("ot", "dt"):
        y2 = z2.transpose(-1, -2).reshape(*lead, f_out)
    else:
        y2 = z2.reshape(*lead, f_out)
    return y1 + y2


def _bmm(xv: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...gi,goi->...go", xv, w)


def apply(params: Params, x: torch.Tensor, spec: DyadSpec) -> torch.Tensor:
    """y = DYAD(x).  x: (..., f_in) -> (..., f_out)."""
    w1, w2 = params["w1"], params["w2"]
    n, d_out, d_in = w1.shape
    if x.shape[-1] != n * d_in:
        raise ValueError(f"expected {n * d_in} input features, got {x.shape[-1]}")

    if spec.use_kernel:
        from repro_torch.kernels import ops as kops

        y = kops.dyad_mm(x, w1, w2, variant=spec.variant,
                         use_kernel_bwd=spec.use_kernel_bwd)
    else:
        w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
        x1, x2 = _block_views(x, n, d_in, spec.variant)
        if spec.cat:
            # paper §3.4.3: one batched matmul over the concatenated blocks.
            z = _bmm(torch.cat([x1, x2], dim=-2), torch.cat([w1, w2], dim=0))
            z1, z2 = z[..., :n, :], z[..., n:, :]
        else:
            # faithful two-step path (two sequential bmms).
            z1, z2 = _bmm(x1, w1), _bmm(x2, w2)
        y = _combine_outputs(z1, z2, spec.variant)

    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def apply_blocks(params: Params, x: torch.Tensor,
                 spec: DyadSpec) -> torch.Tensor:
    """IT apply returning the block layout ``(..., n, d_out)``."""
    if spec.variant != "it":
        raise ValueError("apply_blocks is defined for the IT variant")
    w1, w2 = params["w1"], params["w2"]
    n, d_out, d_in = w1.shape
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    x1, x2 = _block_views(x, n, d_in, "it")
    z = _bmm(x1, w1) + _bmm(x2, w2)
    if "b" in params:
        z = z + params["b"].to(z.dtype).reshape(n, d_out)
    return z


def apply_ot_from_blocks(params: Params, h: torch.Tensor) -> torch.Tensor:
    """OT apply consuming a block-layout input ``(..., n, d_in)``; returns
    the flat ``(..., f_out)``."""
    w1, w2 = params["w1"].to(h.dtype), params["w2"].to(h.dtype)
    y = _combine_outputs(_bmm(h, w1), _bmm(h, w2), "ot")
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def to_dense(params: Params, spec: DyadSpec) -> torch.Tensor:
    """The full structured ``(f_out, f_in)`` matrix — the oracle:
    ``apply(params, x, spec) == x @ to_dense(params, spec).T + b``.
    Overlapping nonzeros of the two components add."""
    w1, w2 = params["w1"], params["w2"]
    n, d_out, d_in = w1.shape
    dev = w1.device
    g = torch.arange(n, device=dev)[:, None, None]
    o = torch.arange(d_out, device=dev)[None, :, None]
    i = torch.arange(d_in, device=dev)[None, None, :]

    rows1, cols1 = g * d_out + o, g * d_in + i                 # BLOCKDIAG
    if spec.variant == "it":
        rows2, cols2 = g * d_out + o, i * n + g
    elif spec.variant == "ot":
        rows2, cols2 = o * n + g, g * d_in + i
    else:  # "dt"
        rows2, cols2 = o * n + g, i * n + g

    W = torch.zeros(n * d_out, n * d_in, dtype=w1.dtype, device=dev)
    for rows, cols, w in ((rows1, cols1, w1), (rows2, cols2, w2)):
        W.index_put_((rows.expand(w.shape), cols.expand(w.shape)), w,
                     accumulate=True)
    return W


def param_count(f_in: int, f_out: int, n_dyad: int, bias: bool = True) -> int:
    return 2 * f_out * f_in // n_dyad + (f_out if bias else 0)


def flops(batch: int, f_in: int, f_out: int, n_dyad: int) -> int:
    """Forward multiply-add FLOPs (2 per MAC), both components."""
    return 2 * 2 * batch * f_out * f_in // n_dyad
