"""Plain-torch oracles for the kernels (port of ``repro.kernels.ref``).

``dyad_mm_ref`` computes what ``kernels.ops.dyad_mm`` computes: the sum of
the BLOCKDIAG and BLOCKTRANS contributions for a variant, without bias.

    x        (..., f_in)                 f_in  = n_dyad * d_in
    w1, w2   (n_dyad, d_out, d_in)       f_out = n_dyad * d_out
    returns  (..., f_out)

``dyad_mm_bwd_ref`` is its einsum VJP, the oracle every backward route is
held against; ``dyad_ff_ref`` is the einsum oracle of the whole ff module
(``ops.dyad_ff``), and ``ACTS`` the activation table its epilogue and the
kernels' share.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def block_views(x: torch.Tensor, n: int, variant: str):
    """(x1, x2) per-block input views; see ``core.dyad._block_views``."""
    d_in = x.shape[-1] // n
    lead = x.shape[:-1]
    x1 = x.reshape(*lead, n, d_in)
    if variant in ("it", "dt"):
        x2 = x.reshape(*lead, d_in, n).transpose(-1, -2)
    else:
        x2 = x1
    return x1, x2


def combine(z1: torch.Tensor, z2: torch.Tensor, variant: str) -> torch.Tensor:
    lead = z1.shape[:-2]
    f_out = z1.shape[-2] * z1.shape[-1]
    y1 = z1.reshape(*lead, f_out)
    if variant in ("ot", "dt"):
        y2 = z2.transpose(-1, -2).reshape(*lead, f_out)
    else:
        y2 = z2.reshape(*lead, f_out)
    return y1 + y2


def dyad_mm_ref(x, w1, w2, *, variant: str = "it"):
    n = w1.shape[0]
    x1, x2 = block_views(x, n, variant)
    z1 = torch.einsum("...gi,goi->...go", x1, w1.to(x.dtype))
    z2 = torch.einsum("...gi,goi->...go", x2, w2.to(x.dtype))
    return combine(z1, z2, variant)


def split_cotangent(g: torch.Tensor, n: int, variant: str):
    """(z1bar, z2bar): per-component views ``(..., n, d_out)`` of the output
    cotangent ``g: (..., f_out)``, mirroring the layouts of :func:`combine`."""
    d_out = g.shape[-1] // n
    lead = g.shape[:-1]
    z1bar = g.reshape(*lead, n, d_out)
    if variant in ("ot", "dt"):
        z2bar = g.reshape(*lead, d_out, n).transpose(-1, -2)
    else:
        z2bar = z1bar
    return z1bar, z2bar


def unview(dx1: torch.Tensor, dx2: torch.Tensor, variant: str) -> torch.Tensor:
    """Fold per-view input cotangents back onto the flat feature axis — the
    exact inverse of :func:`block_views` — summing the two components."""
    lead = dx1.shape[:-2]
    f_in = dx1.shape[-2] * dx1.shape[-1]
    out = dx1.reshape(*lead, f_in)
    if variant in ("it", "dt"):
        return out + dx2.transpose(-1, -2).reshape(*lead, f_in)
    return out + dx2.reshape(*lead, f_in)


def dyad_mm_bwd_ref(x, w1, w2, g, *, variant: str = "it"):
    """Einsum VJP of :func:`dyad_mm_ref`: ``(dx, dw1, dw2)`` for the output
    cotangent ``g: (..., f_out)`` (port of the reference's
    ``ref.dyad_mm_bwd_ref``)."""
    n = w1.shape[0]
    x1, x2 = block_views(x, n, variant)
    z1bar, z2bar = split_cotangent(g, n, variant)
    dw1 = torch.einsum("...gi,...go->goi", x1, z1bar).to(w1.dtype)
    dw2 = torch.einsum("...gi,...go->goi", x2, z2bar).to(w2.dtype)
    dx1 = torch.einsum("...go,goi->...gi", z1bar, w1.to(g.dtype))
    dx2 = torch.einsum("...go,goi->...gi", z2bar, w2.to(g.dtype))
    return unview(dx1, dx2, variant).to(x.dtype), dw1, dw2


# the reference's activation table (jax.nn.gelu defaults to the tanh form)
ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def dyad_ff_ref(x, wu1, wu2, wd1, wd2, wg1=None, wg2=None, *,
                act: str = "gelu"):
    """Einsum oracle for the ff megakernel (``ops.dyad_ff``): up = IT in
    block layout, the activation (``act="swiglu"`` gates with wg1/wg2),
    down = OT consuming the block-layout hidden.

        x          (..., f_in)            f_in  = n * d_in
        wu*, wg*   (n, d_ff_b, d_in)      hidden is (..., n, d_ff_b)
        wd*        (n, d_out, d_ff_b)     f_out = n * d_out
        returns    (..., f_out)
    """
    n = wu1.shape[0]
    x1, x2 = block_views(x, n, "it")

    def up(w1, w2):
        return (torch.einsum("...gi,gji->...gj", x1, w1.to(x.dtype))
                + torch.einsum("...gi,gji->...gj", x2, w2.to(x.dtype)))

    u = up(wu1, wu2)
    h = F.silu(up(wg1, wg2)) * u if act == "swiglu" else ACTS[act](u)
    z1 = torch.einsum("...gj,goj->...go", h, wd1.to(x.dtype))
    z2 = torch.einsum("...gj,goj->...go", h, wd2.to(x.dtype))
    return combine(z1, z2, "ot")


def sdpa_ref(q, k, v, qpos, kpos, *, causal: bool = True, window=None):
    """Einsum oracle for the flash kernels.

    q: (B, S, K, G, h); k, v: (B, T, K, h); qpos: (S,) or (B, S) absolute
    query positions; kpos: (T,) or (B, T) key positions (< 0 = invalid).
    Scores accumulate in fp32; masked probabilities are zeroed explicitly,
    so a fully-masked row yields output 0 (the ``max(l, 1e-30)`` guard).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bskgh,btkh->bskgt", q.float(), k.float()) * scale
    qp = qpos if qpos.ndim == 2 else qpos[None, :]          # (B?, S)
    kp = kpos if kpos.ndim == 2 else kpos[None, :]          # (B?, T)
    m = (kp[:, None, :] >= 0)
    if causal:
        m = m & (kp[:, None, :] <= qp[..., :, None])
    if window is not None:
        m = m & (qp[..., :, None] - kp[:, None, :] < window)
    m = m[:, :, None, None, :]
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.where(m, torch.exp(s - mx), torch.zeros_like(s))
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bskgt,btkh->bskgh", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)
