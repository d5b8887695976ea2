"""Rotary position embeddings (port of ``repro.layers.rotary``), with
arbitrary position offsets (single-token decode against a long cache)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).

    Angles in fp32 (positions can exceed bf16 range); the rotation math
    stays in the activation dtype."""
    inv = rope_freqs(x.shape[-1], theta, x.device)           # (hd/2,)
    ang = positions[..., None].to(torch.float32) * inv        # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)            # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
