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
  gate), the activation, OT down, with the hidden kept on chip;
* :func:`dyad_mm_blocks_q` and :func:`dyad_mm_blocks_two_q`
  (``dyad_mm_q.cu``) and :func:`dyad_ff_fused_q` (``dyad_ff.cu``'s second
  entry): the forward kernels over quantized weights, int8 or fp8 payloads
  with one fp32 scale per (block, out_row) (``repro_torch.quant``).  The
  payload reaches the kernel as it is stored and is converted exactly
  on chip; each scale multiplies its fp32 sum.

All but ``dyad_mm_blocks`` read their (b, g, inner) operands through
strides, so the strided views (``x2``, ``z2bar``) are passed as they are.
Every accumulation is fp32.  With bf16 operands ``dyad_mm_blocks`` (past
its decode rows, M > 8), ``dyad_mm_blocks_two``, ``dyad_mm_dgrad_two``,
``dyad_mm_dgrad`` and ``dyad_mm_wgrad`` run on the tensor cores (the
``wgmma`` mainloop of ``dyad_gemm_tc.cuh``), and the ff megakernel on a
``wgmma`` kernel of its own (``dyad_ff_tc.cuh``, picked by
:func:`ff_plan`); so do the quantized kernels for bf16 x (the mainloop's
pieces in ``dyad_mm_q.cu``, the megakernel's payload instantiation,
picked by :func:`mm_q_plan` and :func:`ff_q_plan`, the payloads converted
to bf16 in shared memory by ``quant_tc.cuh``).  With fp32 operands
``dyad_mm_blocks`` past its decode rows and ``dyad_mm_blocks_two`` run on
that mainloop too, and ``dyad_mm_dgrad_two``, ``dyad_mm_dgrad`` and
``dyad_mm_wgrad`` on kernels of their own on the mainloop's pieces
(``dyad_gemm_tf32.cuh``: the dgrad transposed, ``dx^T = w^T z^T``, the
wgrad with one operand transposed on its way in, since tf32 ``wgmma``
reads its shared operands K-major only), all in split TF32: each operand
split into tf32 hi and lo, three tf32 products a pair (``a_lo b_hi +
a_hi b_lo + a_hi b_hi``), each good to about 2^-21 relative, fp32 sums.
The quantized GEMMs take fp32 x on the tensor cores too
(``dyad_mm_q_tf32_kernel``): x split into tf32 hi and lo, the payload
converted to fp32, which is exact in tf32, so two tf32 products a pair
(``x_lo w + x_hi w``).  The decode rows of ``dyad_mm_blocks`` and the ff
kernels' fp32 operands run on fp32 FMA, and so do the quantized GEMMs'
decode rows where :func:`mm_q_plan` keeps them there.
Each wrapper takes its plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises.
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
    ``ref.combine`` (transpose, reshape, add) reshapes it for free.  Both
    dtypes run on the tensor-core mainloop at every row count: bf16 one
    product a pair (at Qwen3's decode rows, M 8, it beats the FMA kernel
    too), fp32 in split TF32 (the OT and DT forward of OPT-125m's fp32
    train step)."""
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
    Returns dx (M, n, d_in) in z's dtype.  Both dtypes run on the tensor
    cores: bf16 products, fp32 in split TF32."""
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
    free.  Both dtypes run on the tensor cores: bf16 products, fp32 in
    split TF32."""
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


_SMS = 132   # an H100's
# the wgrad tiles of csrc/dyad_gemm_tf32.cuh (fp32 on split TF32): 64
# columns of the operand read as it lies (A) x 96 of the one transposed on
# its way in (B) per block, two blocks an SM, the rows summed in stages of
# 32; and the most row ranges a call is split into
_TF32_TILE_A, _TF32_TILE_B, _WGRAD_ROWS = 64, 96, 32
_TF32_SLOTS = 2 * _SMS
_WGRAD_MAX_SPLIT = 8
# the tiles of csrc/dyad_gemm_tc.cuh (bf16): 128 x 128 per block, one block
# per SM, the rows summed in stages of 64
_TC_TILE_O, _TC_TILE_I, _TC_ROWS = 128, 128, 64


def _tf32_tiles(d_in: int, d_out: int):
    """The split-TF32 wgrad's tiles for one (component, dyad block) GEMM:
    with x as A, and with z as A."""
    return (math.ceil(d_in / _TF32_TILE_A) * math.ceil(d_out / _TF32_TILE_B),
            math.ceil(d_out / _TF32_TILE_A) * math.ceil(d_in / _TF32_TILE_B))


def wgrad_orient(d_in: int, d_out: int, x_strided: bool = False,
                 z_strided: bool = False) -> bool:
    """Whether the split-TF32 wgrad (fp32) reads x as its A, in 64-column
    tiles over d_in, and z as its B, in 96-column tiles over d_out (else
    the other way round): the way with fewer tiles; on a tie the operand
    with a stride-n view (``x_strided``: the IT x2; ``z_strided``: the OT
    z2bar), whose gather then runs along A's contiguous tile rows; else x
    where d_in is the narrower side.  OPT-125m's 192 x 768 and 768 x 192
    blocks tie (24 tiles either way): x for the IT views, z for the OT."""
    t_x, t_z = _tf32_tiles(d_in, d_out)
    if t_x != t_z:
        return t_x < t_z
    if x_strided != z_strided:
        return x_strided
    return d_in <= d_out


def wgrad_split(M: int, n: int, d_in: int, d_out: int, bf16: bool = False):
    """(split, rows): the row ranges the wgrad kernel reduces apart; rows
    is a multiple of the kernel's row step.  Each split adds 2 * n * d_out
    * d_in fp32 partials written and read again, so a kernel splits only
    where its tiles alone leave block slots idle.  The bf16 kernel (one
    block an SM) splits as far as its tiles still find idle SMs.  The
    split-TF32 kernel (fp32, two blocks an SM) takes the split, at most
    ``_WGRAD_MAX_SPLIT``, whose blocks best fill whole waves of its slots:
    the least waves x stages a block, the fewer ranges on a tie (OPT-125m's
    192 tiles: 4 ranges, 3 waves of 32 stages, against 128 stages in one
    wave of 192 blocks on 264 slots)."""
    if bf16:
        tiles = 2 * n * math.ceil(d_out / _TC_TILE_O) * math.ceil(
            d_in / _TC_TILE_I)
        chunks = max(1, math.ceil(M / _TC_ROWS))
        split = max(1, min(chunks, _SMS // max(tiles, 1)))
        step = _TC_ROWS
    else:
        tiles = max(1, 2 * n * min(_tf32_tiles(d_in, d_out)))
        chunks = max(1, math.ceil(M / _WGRAD_ROWS))
        split = 1
        if tiles < _TF32_SLOTS:
            split = min(range(1, min(chunks, _WGRAD_MAX_SPLIT) + 1),
                        key=lambda s: (math.ceil(tiles * s / _TF32_SLOTS)
                                       * math.ceil(chunks / s), s))
        step = _WGRAD_ROWS
    rows = math.ceil(chunks / split) * step
    return max(1, math.ceil(M / rows)), rows


def dyad_mm_wgrad(x1, x2, z1, z2, out_dtype=None):
    """Both weight cotangents.  x1, x2: (M, n, d_in) input views; z1, z2:
    (M, n, d_out) cotangent views (any strides), all one dtype (fp32 or
    bf16).  Returns ``(dw1, dw2)``, each (n, d_out, d_in) in ``out_dtype``
    (x1's dtype by default), cast once from the fp32 sums.  The sum over
    rows is split into fixed ranges added in a fixed order, so the result
    does not depend on the run.  Both dtypes run on the tensor cores: bf16
    products, fp32 in split TF32 (:func:`wgrad_orient` picks which operand
    is read as it lies)."""
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
    split, rows = wgrad_split(M, n, d_in, d_out,
                              bf16=x1.dtype == torch.bfloat16)
    part = (torch.empty(split, 2, n, d_out, d_in, dtype=torch.float32,
                        device=dev) if split > 1 else None)
    err = build.entry("dyad_wgrad")(
        build.ptr(x1), build.ptr(x2), build.ptr(z1), build.ptr(z2),
        build.ptr(dw1), build.ptr(dw2), build.ptr(part), M, n, d_in, d_out,
        split, rows, int(wgrad_orient(d_in, d_out, x2.stride(2) != 1,
                                      z2.stride(2) != 1)), *x1.stride(),
        *x2.stride(), *z1.stride(), *z2.stride(), _DTYPES[x1.dtype],
        _DTYPES[out_dtype], build.stream(dev))
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
# the tensor-core kernel of csrc/dyad_ff_tc.cuh: 64 rows x 256 outputs per
# block (128 over payloads), one block an SM, x resident in shared memory
# up to d_in 256 per component
_FF_TC_ROWS, _FF_TC_HIDDEN, _FF_TC_MAX_IN = 64, 64, 256
_FF_TC_Q_OUT = 128


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


def ff_plan(M: int, n: int, d_in: int, d_ff: int, d_out: int, sms: int,
            dtype: torch.dtype):
    """(kernel, split, span) of ``dyad_ff_fused``: ``"tc"``, the tensor-core
    kernel, for bf16 x at every row count (d_in up to 256), with
    :func:`ff_tc_split`'s ranges; else ``"fma"``, the FMA kernel (fp32),
    with :func:`ff_split`'s.  On an H100 the tensor-core kernel, its
    weights cast in the call, beats the FMA kernel at Qwen3's decode rows
    too (0.0426 against 0.0828 ms at M 8, PERF.md)."""
    if dtype != torch.bfloat16 or d_in > _FF_TC_MAX_IN:
        return ("fma",) + ff_split(M, n, d_ff, d_out, sms)
    return ("tc",) + ff_tc_split(M, n, d_ff, d_out, sms)


def ff_tc_split(M: int, n: int, d_ff: int, d_out: int, sms: int,
                out: int = _FF_OUT):
    """(split, span) of the tensor-core kernel, whose blocks own ``out``
    outputs of each component (256, or 128 over payloads).  While one
    range per 64-column hidden tile keeps its grid of 64-row blocks within
    two waves of ``sms`` (one block an SM; Qwen3-0.6B's serving rows, M <=
    320, or 128 over payloads), each tile is a range: a row's result then
    has the same bits whatever
    M, so routes that batch rows apart (chunked or one-shot prefill,
    decode) agree.  Past that, ranges (``span`` columns, a multiple of 16)
    as narrow as keep the grid within one wave (a second wave cost more
    than it spread, PERF.md), down to one range once the rows fill the
    card."""
    base = n * math.ceil(M / _FF_TC_ROWS) * math.ceil(d_out / out)
    tiles = max(1, math.ceil(d_ff / _FF_TC_HIDDEN))
    if base * tiles <= 2 * sms:
        return tiles, _FF_TC_HIDDEN
    units = max(1, math.ceil(d_ff / _FF_STAGE))
    want = max(1, sms // base)
    span = math.ceil(units / want) * _FF_STAGE
    return max(1, math.ceil(d_ff / span)), span


def ff_cast_elems(weights) -> int:
    """The bf16 scratch the C entry casts fp32 weights into: each weight's
    elements rounded up to 8, so that every one starts on 16 bytes."""
    return sum(-(-t.numel() // 8) * 8 for t in weights)


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
    C entry then casts them to bf16 once a call, in one launch into a
    scratch buffer the wrapper allocates, which computes what a cast
    before the call would.  :func:`ff_plan` picks the kernel and the
    hidden split.

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
    kernel, split, span = ff_plan(M, n, d_in, d_ff, d_out, sm_count(dev),
                                  x1.dtype)
    # the tensor-core kernel stages bf16 weights with cp.async: fp32 ones
    # are cast into this scratch by the entry
    wcast = (torch.empty(ff_cast_elems(weights), dtype=x1.dtype, device=dev)
             if kernel == "tc" and wdt != x1.dtype else None)
    part = (torch.empty(split, 2, M, n, d_out, dtype=torch.float32,
                        device=dev) if split > 1 else None)
    err = build.entry("dyad_ff")(
        build.ptr(x1), build.ptr(x2), build.ptr(wu1), build.ptr(wu2),
        build.ptr(wg1), build.ptr(wg2), build.ptr(wd1), build.ptr(wd2),
        build.ptr(z1), build.ptr(z2), build.ptr(part), build.ptr(wcast), M,
        n, d_in, d_ff, d_out, split, span, *x1.stride(), *x2.stride(),
        *z1.stride(), *z2.stride(), _ACT_CODES[act], _DTYPES[x1.dtype],
        _DTYPES[wdt], int(kernel == "tc"), build.stream(dev))
    build.check(err, "dyad_ff_fused")
    dyad_ff_fused.launches += 1
    return z1, z2


dyad_ff_fused.launches = 0


# -- the quantized-weight kernels -------------------------------------------

# the payload codes of csrc/quant.cuh
_PAYLOADS = {torch.int8: 0, torch.float8_e4m3fn: 1}


# the FMA decode-row kernel of csrc/dyad_mm_q.cu: up to 8 rows of x, both
# x views of a group staged as fp32 within 200 KB of shared memory, one
# warp per output row, 8 output rows a block
_MV_ROWS, _MV_SMEM, _MV_OUTS = 8, 200 * 1024, 8


# the k of one stage of the quantized GEMMs' tensor-core routes: 64 for
# bf16 x, 32 for fp32 x (one 128-byte row of x either way)
_Q_TC_DEPTH = {torch.bfloat16: 64, torch.float32: 32}


def mm_q_tc_split(M: int, n: int, d_in: int, d_out: int, sms: int,
                  dtype: torch.dtype):
    """(split, krows) of the quantized GEMMs' tensor-core route for x of
    ``dtype``: k cut into ``split`` ranges of ``krows`` (whole stages of
    the route's depth, 64 k for bf16 x and 32 for fp32) as far as its
    128 x 128 tiles per (component, block) alone leave SMs of a card with
    ``sms`` idle (one block an SM; each range writes scaled fp32 partials
    that a second pass adds in a fixed order)."""
    depth = _Q_TC_DEPTH[dtype]
    tiles = 2 * n * math.ceil(M / _TC_TILE_O) * math.ceil(d_out / _TC_TILE_I)
    stages = max(1, math.ceil(d_in / depth))
    per = math.ceil(stages / max(1, min(stages, sms // max(tiles, 1))))
    return math.ceil(stages / per), per * depth


def mm_q_plan(M: int, n: int, d_in: int, d_out: int, sms: int,
              dtype: torch.dtype):
    """(kernel, split, krows) of ``dyad_mm_blocks_q`` and
    ``dyad_mm_blocks_two_q``: ``"tc"``, the tensor-core route (bf16
    products for bf16 x, two tf32 products a pair for fp32 x), with
    :func:`mm_q_tc_split`'s ranges; but ``"fma"``, the FMA decode kernel,
    for decode rows (M <= 8 whose two x views fit its shared memory) where
    it wins on an H100: with bf16 x where the decode kernel has at least
    two waves of blocks (it beats the tensor cores at Qwen3's up and gate,
    M 8, 384 blocks, and loses at its down, 128 blocks), with fp32 x
    always (it beats the two-product tf32 kernel at both of OPT-125m's
    projections at M 8, 384 and 96 blocks: 0.0126 and 0.0169 ms against
    0.0208 and 0.0221; PERF.md)."""
    if (M <= _MV_ROWS and 2 * 4 * M * d_in <= _MV_SMEM
            and (dtype == torch.float32
                 or n * math.ceil(d_out / _MV_OUTS) >= 2 * sms)):
        return "fma", 1, max(d_in, 1)
    return ("tc",) + mm_q_tc_split(M, n, d_in, d_out, sms, dtype)


def ff_q_plan(M: int, n: int, d_in: int, d_ff: int, d_out: int, sms: int,
              dtype: torch.dtype):
    """(kernel, split, span) of ``dyad_ff_fused_q``: ``"tc"``, the
    tensor-core megakernel's payload instantiation, for bf16 x at every row
    count (d_in up to 256), with :func:`ff_tc_split`'s ranges for its
    128-output blocks (one range per 64-column hidden tile at the serving
    rows, so a row's bits do not depend on M); else ``"fma"``, the FMA
    kernel, with :func:`ff_split`'s."""
    if dtype != torch.bfloat16 or d_in > _FF_TC_MAX_IN:
        return ("fma",) + ff_split(M, n, d_ff, d_out, sms)
    return ("tc",) + ff_tc_split(M, n, d_ff, d_out, sms, out=_FF_TC_Q_OUT)


def _check_payload(name: str, q: torch.Tensor, s: torch.Tensor) -> None:
    """A payload of int8 or fp8 (never a dequantized or cast weight) and
    its fp32 (n, rows) scales, both contiguous on the payload's device."""
    if q.dtype not in _PAYLOADS:
        raise TypeError(f"{name}: weight payload dtype {q.dtype}; want int8 "
                        "or float8_e4m3fn")
    if s.dtype != torch.float32 or tuple(s.shape) != tuple(q.shape[:2]):
        raise TypeError(f"{name}: scales {s.dtype} {tuple(s.shape)}; want "
                        f"float32 {tuple(q.shape[:2])}")
    if q.device != s.device or not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{name}: payloads and scales must be contiguous, "
                         "on one device")


def _qmm(x, q, s):
    """``s[g, o] * sum_k x[b, g, k] q[g, o, k]`` in fp32 (fp64 for fp64)."""
    f = _acc(x.dtype)
    return torch.einsum("bgk,gok->bgo", x.to(f), q.to(f)) * s.to(f)[None]


def dyad_mm_blocks_q_plain(x1, x2, w1, w2, s1, s2):
    """The quantized forward kernel's function in plain torch: (M, n,
    d_out) in x1's dtype, each component's fp32 sum times its scale."""
    return (_qmm(x1, w1, s1) + _qmm(x2, w2, s2)).to(x1.dtype)


def dyad_mm_blocks_two_q_plain(x1, x2, w1, w2, s1, s2):
    """The quantized two-output kernel's function in plain torch: ``(z1,
    z2)``, each (M, n, d_out) in x1's dtype."""
    return _qmm(x1, w1, s1).to(x1.dtype), _qmm(x2, w2, s2).to(x1.dtype)


def _check_mm_q(name, x1, x2, w1, w2, s1, s2):
    _check_views(name, x1, x2)
    M, n, d_in = x1.shape
    if (x2.shape != x1.shape or w1.dim() != 3 or w1.shape[0] != n
            or w1.shape[2] != d_in or w2.shape != w1.shape
            or w1.dtype != w2.dtype or w1.device != x1.device):
        raise ValueError(f"{name}: x {tuple(x1.shape)}/{tuple(x2.shape)} vs "
                         f"w {tuple(w1.shape)}/{tuple(w2.shape)} "
                         f"{w1.dtype}/{w2.dtype} on {w1.device}")


def dyad_mm_blocks_q(x1, x2, w1, w2, s1, s2):
    """:func:`dyad_mm_blocks` over quantized weights (each wrapper of this
    section raises for a payload that is not int8 or fp8, on either
    device).  x1, x2: (M, n, d_in) input views (any strides; the IT/DT
    ``x2`` is the stride-n view), fp32 or bf16; w1, w2: (n, d_out, d_in)
    int8 or fp8 payloads; s1, s2: (n, d_out) fp32 scales.  Returns (M, n,
    d_out) in x's dtype.  :func:`mm_q_plan` picks the kernel: the tensor
    cores (bf16 products for bf16 x, two tf32 products a pair for fp32),
    but FMA for some decode rows."""
    for q, s in ((w1, s1), (w2, s2)):
        _check_payload("dyad_mm_blocks_q", q, s)
    if x1.device.type == "cpu":
        return dyad_mm_blocks_q_plain(x1, x2, w1, w2, s1, s2)
    _check_mm_q("dyad_mm_blocks_q", x1, x2, w1, w2, s1, s2)
    M, n, d_in = x1.shape
    d_out = w1.shape[1]
    dev = x1.device
    out = torch.empty(M, n, d_out, dtype=x1.dtype, device=dev)
    kernel, split, krows = mm_q_plan(M, n, d_in, d_out, sm_count(dev),
                                     x1.dtype)
    # the tensor-core route adds both components' scaled partials in a
    # second pass
    part = (torch.empty(split, 2, n, M, d_out, dtype=torch.float32,
                        device=dev) if kernel == "tc" else None)
    err = build.entry("dyad_mm_q")(
        build.ptr(x1), build.ptr(x2), build.ptr(w1), build.ptr(w2),
        build.ptr(s1), build.ptr(s2), build.ptr(out), build.ptr(part), M, n,
        d_in, d_out, split, krows, *x1.stride(), *x2.stride(),
        *out.stride(), _DTYPES[x1.dtype], _PAYLOADS[w1.dtype],
        int(kernel == "tc"), build.stream(dev))
    build.check(err, "dyad_mm_blocks_q")
    dyad_mm_blocks_q.launches += 1
    return out


dyad_mm_blocks_q.launches = 0


def dyad_mm_blocks_two_q(x1, x2, w1, w2, s1, s2):
    """:func:`dyad_mm_blocks_two` over quantized weights (arguments as
    :func:`dyad_mm_blocks_q`).  Returns ``(z1, z2)``, each (M, n, d_out)
    in x's dtype; on CUDA ``z2`` is a view of a contiguous (M, d_out, n)
    buffer, so the OT/DT ``ref.combine`` reshapes it for free."""
    for q, s in ((w1, s1), (w2, s2)):
        _check_payload("dyad_mm_blocks_two_q", q, s)
    if x1.device.type == "cpu":
        return dyad_mm_blocks_two_q_plain(x1, x2, w1, w2, s1, s2)
    _check_mm_q("dyad_mm_blocks_two_q", x1, x2, w1, w2, s1, s2)
    M, n, d_in = x1.shape
    d_out = w1.shape[1]
    dev = x1.device
    z1 = torch.empty(M, n, d_out, dtype=x1.dtype, device=dev)
    z2 = _permuted_out(M, n, d_out, x1)
    kernel, split, krows = mm_q_plan(M, n, d_in, d_out, sm_count(dev),
                                     x1.dtype)
    part = (torch.empty(split, 2, n, M, d_out, dtype=torch.float32,
                        device=dev) if split > 1 else None)
    err = build.entry("dyad_mm_two_q")(
        build.ptr(x1), build.ptr(x2), build.ptr(w1), build.ptr(w2),
        build.ptr(s1), build.ptr(s2), build.ptr(z1), build.ptr(z2),
        build.ptr(part), M, n, d_in, d_out, split, krows, *x1.stride(),
        *x2.stride(), *z1.stride(), *z2.stride(), _DTYPES[x1.dtype],
        _PAYLOADS[w1.dtype], int(kernel == "tc"), build.stream(dev))
    build.check(err, "dyad_mm_blocks_two_q")
    dyad_mm_blocks_two_q.launches += 1
    return z1, z2


dyad_mm_blocks_two_q.launches = 0


def _check_ff_q_args(wg1, wg2, sg1, sg2, act: str) -> None:
    _check_ff_args(wg1, wg2, act)
    if act == "swiglu" and (sg1 is None or sg2 is None):
        raise ValueError("sg1/sg2 must be passed when act='swiglu'")


def dyad_ff_fused_q_plain(x1, x2, wu1, wu2, wd1, wd2, su1, su2, sd1, sd2, *,
                          wg1=None, wg2=None, sg1=None, sg2=None,
                          act: str = "gelu"):
    """The quantized megakernel's function in plain torch: ``(z1, z2)``,
    each (M, n, d_out) in x1's dtype.  Each up (and gate) component's fp32
    sum is scaled before the activation, the hidden is rounded to x's
    dtype before the down products, and each down sum is scaled, as the
    TPU kernel does."""
    _check_ff_q_args(wg1, wg2, sg1, sg2, act)
    u = _qmm(x1, wu1, su1) + _qmm(x2, wu2, su2)
    if act == "swiglu":
        h = torch.nn.functional.silu(_qmm(x1, wg1, sg1)
                                     + _qmm(x2, wg2, sg2)) * u
    else:
        h = ref.ACTS[act](u)
    h = h.to(x1.dtype)
    return _qmm(h, wd1, sd1).to(x1.dtype), _qmm(h, wd2, sd2).to(x1.dtype)


def dyad_ff_fused_q(x1, x2, wu1, wu2, wd1, wd2, su1, su2, sd1, sd2, *,
                    wg1=None, wg2=None, sg1=None, sg2=None,
                    act: str = "gelu"):
    """:func:`dyad_ff_fused` over quantized weights; the hidden stays on
    chip.

    x1, x2:   (M, n, d_in) IT input views, fp32 or bf16;
    wu*, wg*: (n, d_ff_b, d_in) int8 or fp8 payloads with su*, sg* (n,
              d_ff_b) fp32 scales (the gate's exactly when ``act ==
              "swiglu"``);
    wd*:      (n, d_out, d_ff_b) payloads with sd* (n, d_out) scales.
    Every payload has one dtype.  Returns ``(z1, z2)``, each (M, n, d_out)
    in x's dtype, ``z2`` a view of a contiguous (M, d_out, n) buffer on
    CUDA; the caller applies ``ref.combine``."""
    _check_ff_q_args(wg1, wg2, sg1, sg2, act)
    gated = act == "swiglu"
    ups = ((wu1, su1), (wu2, su2)) + (((wg1, sg1), (wg2, sg2)) if gated
                                      else ())
    downs = ((wd1, sd1), (wd2, sd2))
    for q, s in ups + downs:
        _check_payload("dyad_ff_fused_q", q, s)
    if x1.device.type == "cpu":
        return dyad_ff_fused_q_plain(x1, x2, wu1, wu2, wd1, wd2, su1, su2,
                                     sd1, sd2, wg1=wg1, wg2=wg2, sg1=sg1,
                                     sg2=sg2, act=act)
    _check_views("dyad_ff_fused_q", x1, x2)
    M, n, d_in = x1.shape
    d_ff = wu1.shape[1]
    d_out = wd1.shape[1]
    if (x2.shape != x1.shape
            or any(q.shape != (n, d_ff, d_in) for q, _ in ups)
            or any(q.shape != (n, d_out, d_ff) for q, _ in downs)
            or any(q.dtype != wu1.dtype or q.device != x1.device
                   for q, _ in ups + downs)):
        raise ValueError(f"dyad_ff_fused_q: x {tuple(x1.shape)}, up "
                         f"{tuple(wu1.shape)}, down {tuple(wd1.shape)}, "
                         f"payloads {[q.dtype for q, _ in ups + downs]}")
    dev = x1.device
    z1 = torch.empty(M, n, d_out, dtype=x1.dtype, device=dev)
    z2 = _permuted_out(M, n, d_out, x1)
    kernel, split, span = ff_q_plan(M, n, d_in, d_ff, d_out, sm_count(dev),
                                    x1.dtype)
    part = (torch.empty(split, 2, M, n, d_out, dtype=torch.float32,
                        device=dev) if split > 1 else None)
    err = build.entry("dyad_ff_q")(
        build.ptr(x1), build.ptr(x2), build.ptr(wu1), build.ptr(wu2),
        build.ptr(wg1), build.ptr(wg2), build.ptr(wd1), build.ptr(wd2),
        build.ptr(su1), build.ptr(su2), build.ptr(sg1), build.ptr(sg2),
        build.ptr(sd1), build.ptr(sd2), build.ptr(z1), build.ptr(z2),
        build.ptr(part), M, n, d_in, d_ff, d_out, split, span, *x1.stride(),
        *x2.stride(), *z1.stride(), *z2.stride(), _ACT_CODES[act],
        _DTYPES[x1.dtype], _PAYLOADS[wu1.dtype], int(kernel == "tc"),
        build.stream(dev))
    build.check(err, "dyad_ff_fused_q")
    dyad_ff_fused_q.launches += 1
    return z1, z2


dyad_ff_fused_q.launches = 0
