"""Mamba2 (SSD, state-space duality) mixer (port of ``repro.layers.ssm``).

The no-cache forward and the prefill use the chunked dual form: quadratic
attention-like products inside chunks of ``chunk`` tokens and a
sequential recurrence over the chunks' states ``(B, H, P, N)``, which
stay fp32.  Decode is the one-token recurrent update.  The in and out
projections (``wz``, ``wx``, ``wo``) go through the linear factory with
``site="ssm"``, so a scope of ``ff+ssm`` makes them DYAD, and with
``use_kernel`` they run the DYAD kernels.

The reference's five-operand einsum of the intra-chunk outputs is taken
here as pairwise products (the (B, nc, H, L, L) scores, scaled, then
against x), so no (B, nc, L, L, H, N) intermediate is built.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import factory, linear
from repro_torch.layers import norms


def init_ssm(generator, d_model: int, lin_cfg: factory.LinearCfg, *,
             d_state: int = 128, head_dim: int = 64, expand: int = 2,
             n_groups: int = 1, conv_width: int = 4, dtype=torch.float32,
             device=None):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * n_groups * d_state

    def proj(f_in, f_out):
        return factory.init(generator, f_in, f_out, lin_cfg, site="ssm",
                            bias=False, dtype=dtype, device=device)

    def plain(f_out):
        return linear.init(generator, d_model, f_out, bias=False,
                           dtype=dtype, device=device)

    p = {"wz": proj(d_model, d_inner), "wx": proj(d_model, d_inner),
         "wbc": plain(2 * n_groups * d_state), "wdt": plain(n_heads),
         "wo": proj(d_inner, d_model)}
    p["conv"] = torch.randn(conv_width, conv_ch, generator=generator,
                            device=device).to(dtype) * 0.1
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          device=device)).to(dtype)
    p["D"] = torch.ones(n_heads, dtype=dtype, device=device)
    u = torch.rand(n_heads, generator=generator, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    p["dt_bias"] = torch.log(torch.expm1(dt)).to(dtype)
    p["norm"] = norms.init_rmsnorm(d_inner, dtype, device)
    return p


def _segsum(x):
    """x: (..., L) -> (..., L, L): T[i, j] = sum_{k=j+1..i} x[k] for
    i >= j, -inf above the diagonal."""
    L = x.shape[-1]
    cs = x.cumsum(-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _causal_conv(u, kernel, hist=None):
    """Depthwise causal conv: u (B, S, Ch), kernel (W, Ch).  ``hist`` is
    the optional (B, W-1, Ch) left context (the conv tail of the decode
    cache); None zero-pads, as a fresh stream."""
    W = kernel.shape[0]
    if hist is None:
        up = F.pad(u, (0, 0, W - 1, 0))
    else:
        up = torch.cat([hist.to(u.dtype), u], dim=1)
    out = torch.zeros_like(u)
    for w in range(W):
        out = out + up[:, w:w + u.shape[1], :] * kernel[w]
    return out


def _project(params, x, lin_cfg):
    """The four input projections: z, x, B|C, dt."""
    z = factory.apply(params["wz"], x, lin_cfg, site="ssm")
    xs = factory.apply(params["wx"], x, lin_cfg, site="ssm")
    bc = linear.apply(params["wbc"], x)
    dt = linear.apply(params["wdt"], x)
    return z, xs, bc, dt


def _ssd_forward(params, x, lin_cfg, *, d_state, head_dim, n_groups, chunk,
                 hist=None, s0=None):
    """Chunked SSD forward that also yields the recurrent decode cache.

    x: (B, S, D) in the activation dtype; ``hist`` the (B, W-1, Ch) conv
    history and ``s0`` the (B, H, P, N) fp32 initial state (None: a fresh
    stream).  A sequence off the chunk is right-padded, its padded
    positions given dt = 0, so they move neither the state nor any real
    output.  Returns (y (B, S, D), final state, conv tail (B, W-1, Ch))."""
    B, S, _ = x.shape
    n_heads = params["A_log"].shape[0]
    d_inner = n_heads * head_dim
    L = min(chunk, S)
    Sp = -(-S // L) * L
    if Sp != S:
        x = F.pad(x, (0, 0, 0, Sp - S))
    z, xs, bc, dt = _project(params, x, lin_cfg)
    conv_in = torch.cat([xs, bc], dim=-1)
    W = params["conv"].shape[0]
    head = (hist.to(conv_in.dtype) if hist is not None
            else conv_in.new_zeros(B, W - 1, conv_in.shape[-1]))
    # the conv tail, from the unpadded input
    conv_tail = torch.cat([head, conv_in[:, :S]], dim=1)[:, -(W - 1):]
    conv_out = F.silu(_causal_conv(conv_in, params["conv"].to(x.dtype),
                                   hist=hist))
    xs, bmat, cmat = torch.split(
        conv_out, [d_inner, n_groups * d_state, n_groups * d_state], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"].float())     # (B,Sp,H)
    if Sp != S:
        live = torch.arange(Sp, device=x.device)[None, :, None] < S
        dt = torch.where(live, dt, torch.zeros_like(dt))
    A = -torch.exp(params["A_log"].float())                     # (H,)
    xh = xs.reshape(B, Sp, n_heads, head_dim).float()
    rep = n_heads // n_groups
    bh = bmat.reshape(B, Sp, n_groups, d_state).float().repeat_interleave(
        rep, dim=2)                                             # (B,Sp,H,N)
    ch = cmat.reshape(B, Sp, n_groups, d_state).float().repeat_interleave(
        rep, dim=2)

    nc = Sp // L

    def r(t):
        return t.reshape(B, nc, L, *t.shape[2:])

    xh, bh, ch, dt = r(xh), r(bh), r(ch), r(dt)
    dA = dt * A                                                 # (B,nc,L,H)
    dA_cs = dA.cumsum(2)

    # 1) intra-chunk: (C B^T) * decay * dt, then against x
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))           # (B,nc,H,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", ch, bh) * Lmat
    scores = scores * dt.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xh)

    # 2) each chunk's final state
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)       # (B,nc,L,H)
    states = torch.einsum("bclhn,bclhp->bchpn", bh,
                          xh * (decay_states * dt)[..., None])

    # 3) the recurrence over the chunks
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                 # (B,nc,H)
    s = (torch.zeros(B, n_heads, head_dim, d_state, dtype=torch.float32,
                     device=x.device) if s0 is None else s0.float())
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                      # (B,nc,H,P,N)

    # 4) the carried state's share of each output
    y_off = (torch.einsum("bclhn,bchpn->bclhp", ch, prev_states)
             * torch.exp(dA_cs)[..., None])
    y = (y_diag + y_off).reshape(B, Sp, n_heads, head_dim)
    y = y + params["D"].float()[:, None] * xh.reshape(B, Sp, n_heads,
                                                      head_dim)
    y = y.reshape(B, Sp, d_inner).to(x.dtype)
    y = norms.rmsnorm(params["norm"], y * F.silu(z))
    y = factory.apply(params["wo"], y, lin_cfg, site="ssm")
    return y[:, :S], s, conv_tail


def apply_ssm(params, x, lin_cfg, *, d_state=128, head_dim=64, n_groups=1,
              chunk=256):
    """Chunked SSD forward without a cache.  x: (B, S, D) -> (B, S, D)."""
    y, _, _ = _ssd_forward(params, x, lin_cfg, d_state=d_state,
                           head_dim=head_dim, n_groups=n_groups, chunk=chunk)
    return y


def ssm_prefill(params, x, cache, lin_cfg, *, d_state=128, head_dim=64,
                n_groups=1, chunk=256):
    """Multi-token prefill: the chunked forward from ``cache`` ({"conv"
    (B, W-1, Ch), "state" (B, H, P, N) fp32}), and the cache after it,
    which continues decode at position S.  Returns (y, new cache)."""
    y, state, tail = _ssd_forward(
        params, x, lin_cfg, d_state=d_state, head_dim=head_dim,
        n_groups=n_groups, chunk=chunk, hist=cache["conv"], s0=cache["state"])
    return y, {"conv": tail.to(cache["conv"].dtype), "state": state}


def init_ssm_cache(batch, d_model, *, d_state=128, head_dim=64, expand=2,
                   n_groups=1, conv_width=4, n_heads=None,
                   dtype=torch.float32, device=None):
    d_inner = expand * d_model
    h = n_heads or d_inner // head_dim
    conv_ch = d_inner + 2 * n_groups * d_state
    return {"conv": torch.zeros(batch, conv_width - 1, conv_ch, dtype=dtype,
                                device=device),
            "state": torch.zeros(batch, h, head_dim, d_state,
                                 dtype=torch.float32, device=device)}


def ssm_decode_step(params, x, cache, lin_cfg, *, d_state=128, head_dim=64,
                    n_groups=1):
    """One-token recurrent update.  x: (B, 1, D) -> (y (B, 1, D), new
    cache); the cache passed in is left as it was."""
    B = x.shape[0]
    n_heads = params["A_log"].shape[0]
    d_inner = n_heads * head_dim
    z, xs, bc, dt = _project(params, x, lin_cfg)
    conv_in = torch.cat([xs, bc], dim=-1)[:, 0]                 # (B,Ch)
    hist = torch.cat([cache["conv"], conv_in[:, None]], dim=1)
    kernel = params["conv"].to(x.dtype)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, kernel))
    xs, bmat, cmat = torch.split(
        conv_out, [d_inner, n_groups * d_state, n_groups * d_state], dim=-1)

    dt = F.softplus(dt[:, 0].float() + params["dt_bias"].float())  # (B,H)
    A = -torch.exp(params["A_log"].float())
    xh = xs.reshape(B, n_heads, head_dim).float()
    rep = n_heads // n_groups
    bh = bmat.reshape(B, n_groups, d_state).float().repeat_interleave(rep, 1)
    chh = cmat.reshape(B, n_groups, d_state).float().repeat_interleave(rep, 1)

    decay = torch.exp(dt * A)                                   # (B,H)
    state = (cache["state"] * decay[..., None, None]
             + (dt[..., None] * xh)[..., None] * bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, chh)
    y = y + params["D"].float()[:, None] * xh
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = norms.rmsnorm(params["norm"], y * F.silu(z))
    out = factory.apply(params["wo"], y, lin_cfg, site="ssm")
    return out, {"conv": hist[:, 1:], "state": state}
