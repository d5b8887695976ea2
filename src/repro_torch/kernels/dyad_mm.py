"""The DYAD kernels (CUDA, ``csrc/``), each porting the TPU kernel of the
same name in ``repro.kernels.dyad_mm``:

* :func:`dyad_mm_blocks` (``dyad_mm.cu``), the forward,

      out[b, g, o] = sum_k x1[b, g, k] * w1[g, o, k] + x2[b, g, k] * w2[g, o, k]

  with the input views taken from the flat activation inside the kernel:
  ``x1[b, g, k] = x[b, g*d_in + k]`` and, for ``it``/``dt``,
  ``x2[b, g, k] = x[b, k*n + g]`` (``x2 = x1`` for ``ot``);
* :func:`dyad_mm_blocks_two` (``dyad_mm_two.cu``), the same contraction
  with ``z1`` and ``z2`` emitted apart (the OT/DT forward);
* :func:`dyad_mm_dgrad_two` (``dyad_dgrad.cu``), the input cotangent per
  component, ``dx_c[b, g, i] = sum_o z_c[b, g, o] * w_c[g, o, i]``;
* :func:`dyad_mm_dgrad` (``dyad_dgrad_fused.cu``), both components of
  that contraction in one accumulator (the OT input cotangent);
* :func:`dyad_mm_wgrad` (``dyad_wgrad.cu``), both weight cotangents,
  ``dw_c[g, o, i] = sum_b z_c[b, g, o] * x_c[b, g, i]``;
* :func:`dyad_ff_fused` (``dyad_ff.cu``), the whole ff module: IT up (and
  gate), the activation, OT down, with the hidden kept on chip.

All but ``dyad_mm_blocks`` read their (b, g, inner) operands through
strides, so the strided views (``x2``, ``z2bar``) are passed as they are.
Every accumulation is fp32.  Each wrapper takes its plain version only for
a CPU tensor; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build, ref

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


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation dtype: fp32, or fp64 for fp64
    inputs (``torch.autograd.gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def _permuted_out(M: int, n: int, d: int, like: torch.Tensor):
    """An (M, n, d) view of a contiguous (M, d, n) buffer: a component-2
    output that the OT/DT ``combine`` (or the IT/DT ``unview``) then reads
    with a free reshape."""
    return torch.empty(M, d, n, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _check_views(name: str, *views) -> None:
    if any(t.device.type != "cuda" for t in views):
        raise ValueError(f"{name}: unsupported device {views[0].device}")
    if views[0].dtype not in _DTYPES or any(t.dtype != views[0].dtype
                                            for t in views):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in views]}; want "
                        "one of fp32, bf16 for every operand")
    if any(t.dim() != 3 for t in views):
        raise ValueError(f"{name}: operands must be 3-D (rows, n, inner)")


def dyad_mm_blocks_two_plain(x1, x2, w1, w2):
    """The two-output forward kernel's function in plain torch: ``(z1,
    z2)``, each (M, n, d_out) in x1's dtype, fp32 accumulation (fp64 for
    fp64)."""
    f = _acc(x1.dtype)
    z1 = torch.einsum("bgk,gok->bgo", x1.to(f), w1.to(f))
    z2 = torch.einsum("bgk,gok->bgo", x2.to(f), w2.to(f))
    return z1.to(x1.dtype), z2.to(x1.dtype)


def dyad_mm_blocks_two(x1, x2, w1, w2):
    """The DYAD forward with the two components emitted apart.  x1, x2:
    (M, n, d_in) input views (any strides; the IT/DT ``x2`` is the stride-n
    view); w1, w2: (n, d_out, d_in), one dtype with x (fp32 or bf16).

    Returns ``(z1, z2)``, each (M, n, d_out) in x's dtype.  On CUDA ``z2``
    is a view of a contiguous (M, d_out, n) buffer, so the OT/DT
    ``ref.combine`` (transpose, reshape, add) reshapes it for free."""
    if x1.device.type == "cpu":
        return dyad_mm_blocks_two_plain(x1, x2, w1, w2)
    _check_views("dyad_mm_blocks_two", x1, x2, w1, w2)
    M, n, d_in = x1.shape
    d_out = w1.shape[1]
    if x2.shape != x1.shape or w1.shape != (n, d_out, d_in) or \
            w2.shape != w1.shape:
        raise ValueError(f"dyad_mm_blocks_two: x {tuple(x1.shape)}/"
                         f"{tuple(x2.shape)} vs w {tuple(w1.shape)}/"
                         f"{tuple(w2.shape)}")
    if not (w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError("dyad_mm_blocks_two: w must be contiguous")
    z1 = torch.empty(M, n, d_out, dtype=x1.dtype, device=x1.device)
    z2 = _permuted_out(M, n, d_out, x1)
    err = build.entry("dyad_mm_two")(
        build.ptr(x1), build.ptr(x2), build.ptr(w1), build.ptr(w2),
        build.ptr(z1), build.ptr(z2), M, n, d_in, d_out, *x1.stride(),
        *x2.stride(), *z1.stride(), *z2.stride(), _DTYPES[x1.dtype],
        build.stream(x1.device))
    build.check(err, "dyad_mm_blocks_two")
    dyad_mm_blocks_two.launches += 1
    return z1, z2


dyad_mm_blocks_two.launches = 0


def dyad_mm_dgrad_plain(z1, z2, w1, w2):
    """The fused dgrad kernel's function in plain torch: dx (M, n, d_in)
    in z1's dtype, one fp32 sum (fp64 for fp64) over component 1's o and
    then component 2's, the order the kernel sums in."""
    f = _acc(z1.dtype)
    z = torch.cat([z1, z2], dim=-1).to(f)
    w = torch.cat([w1, w2], dim=1).to(f)
    return torch.einsum("bgo,goi->bgi", z, w).to(z1.dtype)


def dyad_mm_dgrad(z1, z2, w1, w2):
    """Input cotangent with both components in one fp32 accumulator: valid
    where both dx components share the block layout (the OT input side).
    z1, z2: (M, n, d_out) views (any strides; the OT ``z2bar`` is a stride-n
    view); w1, w2: (n, d_out, d_in), one dtype with z (fp32 or bf16).
    Returns dx (M, n, d_in) in z's dtype."""
    if z1.device.type == "cpu":
        return dyad_mm_dgrad_plain(z1, z2, w1, w2)
    _check_views("dyad_mm_dgrad", z1, z2, w1, w2)
    M, n, d_out = z1.shape
    d_in = w1.shape[2]
    if z2.shape != z1.shape or w1.shape != (n, d_out, d_in) or \
            w2.shape != w1.shape:
        raise ValueError(f"dyad_mm_dgrad: z {tuple(z1.shape)}/"
                         f"{tuple(z2.shape)} vs w {tuple(w1.shape)}/"
                         f"{tuple(w2.shape)}")
    if not (w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError("dyad_mm_dgrad: w must be contiguous")
    dx = torch.empty(M, n, d_in, dtype=z1.dtype, device=z1.device)
    err = build.entry("dyad_dgrad_fused")(
        build.ptr(z1), build.ptr(z2), build.ptr(w1), build.ptr(w2),
        build.ptr(dx), M, n, d_in, d_out, *z1.stride(), *z2.stride(),
        *dx.stride(), _DTYPES[z1.dtype], build.stream(z1.device))
    build.check(err, "dyad_mm_dgrad")
    dyad_mm_dgrad.launches += 1
    return dx


dyad_mm_dgrad.launches = 0


def dyad_mm_dgrad_two_plain(z1, z2, w1, w2):
    """The dgrad kernel's function in plain torch: ``(dx1, dx2)``, each
    (M, n, d_in) in z1's dtype, fp32 accumulation (fp64 for fp64)."""
    f = _acc(z1.dtype)
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
    dx2 = _permuted_out(M, n, d_in, z1)
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
    f = _acc(x1.dtype)
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


# -- the ff megakernel ------------------------------------------------------

# the epilogues of csrc/dyad_ff.cu, by the code the kernel takes
_ACT_CODES = {"gelu": 0, "relu": 1, "silu": 2, "swiglu": 3}
# the tiles of csrc/dyad_ff.cu: 32 rows x 256 outputs per block, the
# hidden in 16-column down stages
_FF_ROWS, _FF_OUT, _FF_STAGE = 32, 256, 16


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ff_split(M: int, n: int, d_ff: int, d_out: int, sms: int):
    """(split, span): the hidden axis is cut into ``split`` ranges of
    ``span`` columns (a multiple of the kernel's 16-column down stage),
    enough for about two blocks per SM of a card with ``sms`` SMs when the
    rows alone give fewer; each range sums its fp32 partial outputs apart
    and a second pass adds them in a fixed order."""
    base = (n * math.ceil(M / _FF_ROWS) * math.ceil(d_out / _FF_OUT))
    units = max(1, math.ceil(d_ff / _FF_STAGE))
    split = max(1, min(units, math.ceil(2 * sms / max(base, 1))))
    span = math.ceil(units / split) * _FF_STAGE
    return max(1, math.ceil(d_ff / span)), span


def dyad_ff_fused_plain(x1, x2, wu1, wu2, wd1, wd2, wg1=None, wg2=None, *,
                        act: str = "gelu"):
    """The megakernel's function in plain torch: ``(z1, z2)``, each
    (M, n, d_out) in x1's dtype.  The weights are rounded to x's dtype,
    the up (and gate) products sum in fp32 (fp64 for fp64), the activation
    runs on those sums and the hidden is rounded to x's dtype before the
    down products, as the TPU kernel does."""
    _check_ff_args(wg1, wg2, act)
    f = _acc(x1.dtype)

    def w(t):
        return t.to(x1.dtype).to(f)

    xf1, xf2 = x1.to(f), x2.to(f)

    def up(w1, w2):
        return (torch.einsum("bgk,gjk->bgj", xf1, w(w1))
                + torch.einsum("bgk,gjk->bgj", xf2, w(w2)))

    u = up(wu1, wu2)
    if act == "swiglu":
        h = torch.nn.functional.silu(up(wg1, wg2)) * u
    else:
        h = ref.ACTS[act](u)
    h = h.to(x1.dtype).to(f)
    z1 = torch.einsum("bgj,goj->bgo", h, w(wd1))
    z2 = torch.einsum("bgj,goj->bgo", h, w(wd2))
    return z1.to(x1.dtype), z2.to(x1.dtype)


def _check_ff_args(wg1, wg2, act: str) -> None:
    gated = act == "swiglu"
    if gated != (wg1 is not None) or gated != (wg2 is not None):
        raise ValueError("wg1/wg2 must be passed exactly when act='swiglu'")
    if act not in _ACT_CODES:
        raise ValueError(f"unsupported megakernel activation {act!r}")


def dyad_ff_fused(x1, x2, wu1, wu2, wd1, wd2, wg1=None, wg2=None, *,
                  act: str = "gelu"):
    """The whole DYAD ff module in one kernel; the hidden stays on chip.

    x1, x2:   (M, n, d_in) block-contiguous / stride-n input views (IT),
              fp32 or bf16;
    wu1, wu2: (n, d_ff_b, d_in) up weights; wg1, wg2 likewise for the
              SwiGLU gate (required exactly when ``act == "swiglu"``);
    wd1, wd2: (n, d_out, d_ff_b) down weights (OT, read from the block
              layout, so both components consume the same hidden).
    The weights are contiguous, in x's dtype or, for bf16 x, in fp32: the
    kernel then rounds each weight to bf16 as it loads it, which computes
    what a cast before the call would, without the copy.

    Returns ``(z1, z2)``, each (M, n, d_out) in x's dtype; the caller
    applies the OT re-view and add (``ref.combine``).  On CUDA ``z2`` is a
    view of a contiguous (M, d_out, n) buffer, so that ``combine`` is a
    free reshape plus one add."""
    if x1.device.type == "cpu":
        return dyad_ff_fused_plain(x1, x2, wu1, wu2, wd1, wd2, wg1, wg2,
                                   act=act)
    _check_ff_args(wg1, wg2, act)
    _check_views("dyad_ff_fused", x1, x2)
    ups = (wu1, wu2) + ((wg1, wg2) if act == "swiglu" else ())
    weights = ups + (wd1, wd2)
    wdt = wu1.dtype
    if any(t.device != x1.device for t in weights):
        raise ValueError("dyad_ff_fused: weights must be on x's device")
    if any(t.dtype != wdt for t in weights) or wdt not in (
            x1.dtype, torch.float32):
        raise TypeError(f"dyad_ff_fused: weight dtypes "
                        f"{[t.dtype for t in weights]} for x {x1.dtype}; "
                        "want x's dtype or fp32, all alike")
    if not all(t.is_contiguous() for t in weights):
        raise ValueError("dyad_ff_fused: the weights must be contiguous")
    M, n, d_in = x1.shape
    d_ff = wu1.shape[1]
    d_out = wd1.shape[1]
    if (x2.shape != x1.shape
            or any(t.shape != (n, d_ff, d_in) for t in ups)
            or any(t.shape != (n, d_out, d_ff) for t in (wd1, wd2))):
        raise ValueError(f"dyad_ff_fused: x {tuple(x1.shape)}, up "
                         f"{tuple(wu1.shape)}, down {tuple(wd1.shape)}")
    dev = x1.device
    z1 = torch.empty(M, n, d_out, dtype=x1.dtype, device=dev)
    z2 = _permuted_out(M, n, d_out, x1)
    split, span = ff_split(M, n, d_ff, d_out, sm_count(dev))
    part = (torch.empty(split, 2, M, n, d_out, dtype=torch.float32,
                        device=dev) if split > 1 else None)
    err = build.entry("dyad_ff")(
        build.ptr(x1), build.ptr(x2), build.ptr(wu1), build.ptr(wu2),
        build.ptr(wg1), build.ptr(wg2), build.ptr(wd1), build.ptr(wd2),
        build.ptr(z1), build.ptr(z2), build.ptr(part), M, n, d_in, d_ff,
        d_out, split, span, *x1.stride(), *x2.stride(), *z1.stride(),
        *z2.stride(), _ACT_CODES[act], _DTYPES[x1.dtype], _DTYPES[wdt],
        build.stream(dev))
    build.check(err, "dyad_ff_fused")
    dyad_ff_fused.launches += 1
    return z1, z2


dyad_ff_fused.launches = 0
