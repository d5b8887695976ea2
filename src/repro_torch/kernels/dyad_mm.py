"""The DYAD forward kernel: ``dyad_mm_blocks`` (CUDA, ``csrc/dyad_mm.cu``).

    out[b, g, o] = sum_k x1[b, g, k] * w1[g, o, k] + x2[b, g, k] * w2[g, o, k]

with the input views taken from the flat activation inside the kernel:
``x1[b, g, k] = x[b, g*d_in + k]`` and, for ``it``/``dt``,
``x2[b, g, k] = x[b, k*n + g]`` (``x2 = x1`` for ``ot``).  Ports the TPU
kernel ``repro.kernels.dyad_mm.dyad_mm_blocks``.

The wrapper takes the plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dyad_mm_blocks_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                         variant: str = "it") -> torch.Tensor:
    """The kernel's function in plain torch: (M, n*d_in) -> (M, n, d_out)."""
    n, _, d_in = w1.shape
    x1 = x.reshape(-1, n, d_in)
    if variant in ("it", "dt"):
        x2 = x.reshape(-1, d_in, n).transpose(-1, -2)
    else:
        x2 = x1
    return (torch.einsum("bgk,gok->bgo", x1, w1)
            + torch.einsum("bgk,gok->bgo", x2, w2))


def dyad_mm_blocks(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   variant: str = "it") -> torch.Tensor:
    """Fused dual block matmul.  x: (M, n*d_in); w1, w2: (n, d_out, d_in),
    all of one dtype (fp32 or bf16).  Returns (M, n, d_out) in x's dtype."""
    if x.device.type == "cpu":
        return dyad_mm_blocks_plain(x, w1, w2, variant)
    if x.device.type != "cuda":
        raise ValueError(f"dyad_mm_blocks: unsupported device {x.device}")
    n, d_out, d_in = w1.shape
    if x.dim() != 2 or x.shape[1] != n * d_in:
        raise ValueError(f"dyad_mm_blocks: x {tuple(x.shape)} does not match "
                         f"w {tuple(w1.shape)}")
    if w2.shape != w1.shape:
        raise ValueError("dyad_mm_blocks: w1 and w2 shapes differ")
    if x.dtype not in _DTYPES or not (x.dtype == w1.dtype == w2.dtype):
        raise TypeError(f"dyad_mm_blocks: dtypes {x.dtype}/{w1.dtype}/"
                        f"{w2.dtype}; want one of fp32, bf16")
    if x.stride(1) != 1 or not (w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError("dyad_mm_blocks: x rows and w must be contiguous")
    if variant not in ("it", "ot", "dt"):
        raise ValueError(f"unknown DYAD variant {variant!r}")
    M = x.shape[0]
    out = torch.empty(M, n, d_out, dtype=x.dtype, device=x.device)
    err = build.entry("dyad_mm")(
        build.ptr(x), build.ptr(w1), build.ptr(w2), build.ptr(out),
        M, n, d_in, d_out, x.stride(0), int(variant != "ot"),
        _DTYPES[x.dtype], build.stream(x.device))
    build.check(err, "dyad_mm_blocks")
    dyad_mm_blocks.launches += 1
    return out


dyad_mm_blocks.launches = 0
