"""The DYAD kernels (CUDA, ``csrc/``), each porting the TPU kernel of the
same name in ``repro.kernels.dyad_mm``:

* :func:`dyad_mm_blocks` (``dyad_mm.cu``), the forward,

      out[b, g, o] = sum_k x1[b, g, k] * w1[g, o, k] + x2[b, g, k] * w2[g, o, k]

  with the input views taken from the flat activation inside the kernel:
  ``x1[b, g, k] = x[b, g*d_in + k]`` and, for ``it``/``dt``,
  ``x2[b, g, k] = x[b, k*n + g]`` (``x2 = x1`` for ``ot``);
* :func:`dyad_mm_dgrad_two` (``dyad_dgrad.cu``), the input cotangent per
  component, ``dx_c[b, g, i] = sum_o z_c[b, g, o] * w_c[g, o, i]``;
* :func:`dyad_mm_wgrad` (``dyad_wgrad.cu``), both weight cotangents,
  ``dw_c[g, o, i] = sum_b z_c[b, g, o] * x_c[b, g, i]``.

The backward kernels read their (b, g, inner) operands through strides, so
the strided views (``x2``, ``z2bar``) are passed as they are.  Every
accumulation is fp32.  Each wrapper takes its plain version only for a CPU
tensor; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import math

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


def _check_views(name: str, *views) -> None:
    if any(t.device.type != "cuda" for t in views):
        raise ValueError(f"{name}: unsupported device {views[0].device}")
    if views[0].dtype not in _DTYPES or any(t.dtype != views[0].dtype
                                            for t in views):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in views]}; want "
                        "one of fp32, bf16 for every operand")
    if any(t.dim() != 3 for t in views):
        raise ValueError(f"{name}: operands must be 3-D (rows, n, inner)")


def dyad_mm_dgrad_two_plain(z1, z2, w1, w2):
    """The dgrad kernel's function in plain torch: ``(dx1, dx2)``, each
    (M, n, d_in) in z1's dtype, fp32 accumulation (fp64 for fp64)."""
    f = torch.promote_types(z1.dtype, torch.float32)
    dx1 = torch.einsum("bgo,goi->bgi", z1.to(f), w1.to(f))
    dx2 = torch.einsum("bgo,goi->bgi", z2.to(f), w2.to(f))
    return dx1.to(z1.dtype), dx2.to(z1.dtype)


def dyad_mm_dgrad_two(z1, z2, w1, w2):
    """Input cotangent per component.  z1, z2: (M, n, d_out) views (any
    strides); w1, w2: (n, d_out, d_in), one dtype with z (fp32 or bf16).

    Returns ``(dx1, dx2)``, each (M, n, d_in) in z's dtype.  On CUDA
    ``dx2`` is a view of a contiguous (M, d_in, n) buffer, so the IT/DT
    un-view (``ref.unview``: transpose, reshape, add) reshapes it for
    free."""
    if z1.device.type == "cpu":
        return dyad_mm_dgrad_two_plain(z1, z2, w1, w2)
    _check_views("dyad_mm_dgrad_two", z1, z2, w1, w2)
    M, n, d_out = z1.shape
    d_in = w1.shape[2]
    if z2.shape != z1.shape or w1.shape != (n, d_out, d_in) or \
            w2.shape != w1.shape:
        raise ValueError(f"dyad_mm_dgrad_two: z {tuple(z1.shape)}/"
                         f"{tuple(z2.shape)} vs w {tuple(w1.shape)}/"
                         f"{tuple(w2.shape)}")
    if not (w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError("dyad_mm_dgrad_two: w must be contiguous")
    dx1 = torch.empty(M, n, d_in, dtype=z1.dtype, device=z1.device)
    dx2 = torch.empty(M, d_in, n, dtype=z1.dtype,
                      device=z1.device).transpose(1, 2)
    err = build.entry("dyad_dgrad")(
        build.ptr(z1), build.ptr(z2), build.ptr(w1), build.ptr(w2),
        build.ptr(dx1), build.ptr(dx2), M, n, d_in, d_out, *z1.stride(),
        *z2.stride(), *dx1.stride(), *dx2.stride(), _DTYPES[z1.dtype],
        build.stream(z1.device))
    build.check(err, "dyad_mm_dgrad_two")
    dyad_mm_dgrad_two.launches += 1
    return dx1, dx2


dyad_mm_dgrad_two.launches = 0


def dyad_mm_wgrad_plain(x1, x2, z1, z2, out_dtype=None):
    """The wgrad kernel's function in plain torch: ``(dw1, dw2)``, each
    (n, d_out, d_in) in ``out_dtype`` (x1's dtype by default), fp32
    accumulation (fp64 for fp64)."""
    f = torch.promote_types(x1.dtype, torch.float32)
    out_dtype = out_dtype or x1.dtype
    dw1 = torch.einsum("bgo,bgi->goi", z1.to(f), x1.to(f))
    dw2 = torch.einsum("bgo,bgi->goi", z2.to(f), x2.to(f))
    return dw1.to(out_dtype), dw2.to(out_dtype)


# blocks the wgrad grid aims for (about 4 per SM of an H100), and the
# tiles of csrc/dyad_gemm.cuh: 128 rows (o) x 64 columns (i) per block
_WGRAD_BLOCKS = 4 * 132
_TILE_O, _TILE_I, _WGRAD_ROWS = 128, 64, 32


def wgrad_split(M: int, n: int, d_in: int, d_out: int):
    """(split, rows): the row ranges the wgrad kernel reduces apart, enough
    for about four blocks per SM; rows is a multiple of the kernel's row
    step."""
    tiles = (2 * n * math.ceil(d_out / _TILE_O)
             * math.ceil(d_in / _TILE_I))
    chunks = max(1, math.ceil(M / _WGRAD_ROWS))
    split = max(1, min(chunks, math.ceil(_WGRAD_BLOCKS / max(tiles, 1))))
    rows = math.ceil(chunks / split) * _WGRAD_ROWS
    return max(1, math.ceil(M / rows)), rows


def dyad_mm_wgrad(x1, x2, z1, z2, out_dtype=None):
    """Both weight cotangents.  x1, x2: (M, n, d_in) input views; z1, z2:
    (M, n, d_out) cotangent views (any strides), all one dtype (fp32 or
    bf16).  Returns ``(dw1, dw2)``, each (n, d_out, d_in) in ``out_dtype``
    (x1's dtype by default), cast once from the fp32 sums.  The sum over
    rows is split into fixed ranges added in a fixed order, so the result
    does not depend on the run."""
    if x1.device.type == "cpu":
        return dyad_mm_wgrad_plain(x1, x2, z1, z2, out_dtype)
    _check_views("dyad_mm_wgrad", x1, x2, z1, z2)
    out_dtype = out_dtype or x1.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"dyad_mm_wgrad: out_dtype {out_dtype}")
    M, n, d_in = x1.shape
    d_out = z1.shape[2]
    if x2.shape != x1.shape or z1.shape != (M, n, d_out) or \
            z2.shape != z1.shape:
        raise ValueError(f"dyad_mm_wgrad: x {tuple(x1.shape)}/"
                         f"{tuple(x2.shape)} vs z {tuple(z1.shape)}/"
                         f"{tuple(z2.shape)}")
    dev = x1.device
    dw1 = torch.empty(n, d_out, d_in, dtype=out_dtype, device=dev)
    dw2 = torch.empty(n, d_out, d_in, dtype=out_dtype, device=dev)
    split, rows = wgrad_split(M, n, d_in, d_out)
    part = (torch.empty(split, 2, n, d_out, d_in, dtype=torch.float32,
                        device=dev) if split > 1 else None)
    err = build.entry("dyad_wgrad")(
        build.ptr(x1), build.ptr(x2), build.ptr(z1), build.ptr(z2),
        build.ptr(dw1), build.ptr(dw2), build.ptr(part), M, n, d_in, d_out,
        split, rows, *x1.stride(), *x2.stride(), *z1.stride(), *z2.stride(),
        _DTYPES[x1.dtype], _DTYPES[out_dtype], build.stream(dev))
    build.check(err, "dyad_mm_wgrad")
    dyad_mm_wgrad.launches += 1
    return dw1, dw2


dyad_mm_wgrad.launches = 0
