"""The port's CUDA kernels against their plain versions, and the wrappers'
routing.  Imports torch and the port only, so it also runs on a machine
without JAX.

Tests marked ``gpu`` need a CUDA card and skip without one; run them on
the card with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_kernels_cuda.py``.  The others check, on the CPU, that a
CPU tensor takes the plain version and leaves the launch counter alone.

Tolerance: 2e-5 (fp32) and 2e-2 (bf16) times max(|plain|, 1).  The fp32
routes of ``flash_prefill``, ``flash_prefill_grads``, ``dyad_mm_dgrad_two``,
``dyad_mm_dgrad``, ``dyad_mm_wgrad``, ``dyad_mm_blocks_two`` and of
``dyad_mm_blocks`` past the decode rows run on split TF32 (three tf32
products a pair), and those of ``dyad_mm_blocks_q`` and
``dyad_mm_blocks_two_q`` on the tensor cores with x split (two tf32
products a pair, the payload exact in tf32): they are also held against
their plain versions run in float64, at most F64_GATE times the plain fp32
versions' error, and on operands +-(1 + 2^-12), whose low bits one TF32
product drops, within SPLIT_REL of float64."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dyad_mm, flash_attn, ops  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
F64_GATE, SPLIT_REL = 4.0, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * scale, (err, TOL[dtype] * scale)


def _randn(gen, *shape, device, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device=device).to(dtype)


WRAPPERS = (dyad_mm.dyad_mm_blocks, dyad_mm.dyad_mm_dgrad_two,
            dyad_mm.dyad_mm_wgrad, flash_attn.flash_prefill,
            flash_attn.flash_prefill_grads, flash_attn.flash_decode,
            dyad_mm.dyad_mm_blocks_two, dyad_mm.dyad_mm_dgrad,
            dyad_mm.dyad_ff_fused)


def test_cpu_tensors_take_the_plain_versions():
    gen = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    counts = [w.launches for w in WRAPPERS]
    x, w = _randn(gen, 4, 32, device=cpu), _randn(gen, 4, 8, 8, device=cpu)
    assert torch.equal(dyad_mm.dyad_mm_blocks(x, w, w),
                       dyad_mm.dyad_mm_blocks_plain(x, w, w))
    q = _randn(gen, 1, 5, 2, 1, 16, device=cpu)
    kv = _randn(gen, 1, 7, 2, 16, device=cpu)
    assert torch.equal(flash_attn.flash_prefill(q, kv, kv)[0],
                       flash_attn.flash_prefill_plain(q, kv, kv)[0])
    assert torch.equal(flash_attn.flash_decode(q[:, :1], kv, kv, 3),
                       flash_attn.flash_decode_plain(q[:, :1], kv, kv, 3))
    z = _randn(gen, 4, 4, 8, device=cpu)
    x3 = x.reshape(4, 4, 8)
    for got, want in (
            (dyad_mm.dyad_mm_dgrad_two(z, z, w, w),
             dyad_mm.dyad_mm_dgrad_two_plain(z, z, w, w)),
            (dyad_mm.dyad_mm_wgrad(x3, x3, z, z),
             dyad_mm.dyad_mm_wgrad_plain(x3, x3, z, z))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    o, lse = flash_attn.flash_prefill(q, kv, kv, save_lse=True)
    got = flash_attn.flash_prefill_grads(q, kv, kv, o, lse, o)
    want = flash_attn.flash_prefill_grads_plain(q, kv, kv, o, lse, o)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for got, want in (
            (dyad_mm.dyad_mm_blocks_two(x3, x3, w, w),
             dyad_mm.dyad_mm_blocks_two_plain(x3, x3, w, w)),
            (dyad_mm.dyad_ff_fused(x3, x3, w, w, w, w, act="gelu"),
             dyad_mm.dyad_ff_fused_plain(x3, x3, w, w, w, w, act="gelu"))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(dyad_mm.dyad_mm_dgrad(z, z, w, w),
                       dyad_mm.dyad_mm_dgrad_plain(z, z, w, w))
    assert counts == [w.launches for w in WRAPPERS]


def test_other_devices_raise():
    x = torch.zeros(2, 8, device="meta")
    w = torch.zeros(2, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dyad_mm.dyad_mm_blocks(x, w, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,n,d_in,d_out,variant", [
    (1024, 4, 192, 768, "it"), (8, 4, 768, 192, "it"),
    (64, 2, 129, 130, "it"), (13, 3, 7, 5, "ot"), (10, 2, 33, 17, "dt"),
    (3, 3, 7, 5, "it"), (5, 2, 129, 130, "dt"), (1, 4, 768, 192, "ot"),
    # Qwen3-0.6B's up (and gate) and down at the training rows
    (4096, 4, 256, 768, "it"), (4096, 4, 768, 256, "it"),
    # OPT-125m's up and down at the training rows (fp32: split TF32)
    (4096, 4, 192, 768, "it"), (4096, 4, 768, 192, "ot")])
def test_dyad_mm_kernel_matches_plain(cuda, M, n, d_in, d_out, variant,
                                      dtype):
    gen = torch.Generator(device=cuda).manual_seed(M + d_in)
    x = _randn(gen, M, n * d_in, device=cuda, dtype=dtype)
    w1 = (_randn(gen, n, d_out, d_in, device=cuda) / d_in ** 0.5).to(dtype)
    w2 = (_randn(gen, n, d_out, d_in, device=cuda) / d_in ** 0.5).to(dtype)
    before = dyad_mm.dyad_mm_blocks.launches
    got = dyad_mm.dyad_mm_blocks(x, w1, w2, variant)
    torch.cuda.synchronize()
    assert dyad_mm.dyad_mm_blocks.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, n, d_out)
    _close(got, dyad_mm.dyad_mm_blocks_plain(x, w1, w2, variant), dtype)


# dyad_mm_blocks off the tensor-core tiles (bf16 past the decode rows:
# 128 x 128, 64 deep): (M, n, d_in, d_out, variant, pad, offset), x a view
# of (M, n * d_in + pad) rows from column ``offset``.  Ragged rows and dims
# at n 2, 3 and 4 (at n 4 the stride-n x2 loads 16-byte runs; an odd d_in
# gathers every operand), the smallest row count the tiles take, rows off
# a multiple of 8 elements and a start off 16 bytes (x gathered)
TC_EDGE_SHAPES = [
    (9, 4, 256, 768, "it", 0, 0), (300, 3, 200, 130, "dt", 0, 0),
    (200, 4, 136, 72, "it", 0, 0), (129, 4, 72, 136, "ot", 0, 0),
    (130, 2, 129, 130, "ot", 0, 0), (77, 4, 65, 33, "dt", 0, 0),
    (150, 4, 64, 96, "it", 3, 0), (150, 2, 40, 24, "ot", 5, 0),
    (100, 4, 64, 64, "dt", 8, 1), (140, 3, 24, 200, "it", 1, 0),
    # the fp32 stages (32 deep) and 16-byte runs (4 fp32): d_in a multiple
    # of 4 off the stage, one element into a second stage, rows padded to a
    # multiple of 4 elements (fp32 copies, bf16 gathers) and a start 4
    # elements in (16 bytes in fp32)
    (129, 4, 36, 129, "it", 0, 0), (40, 2, 33, 64, "ot", 0, 0),
    (256, 4, 32, 128, "dt", 4, 0), (70, 3, 100, 50, "it", 8, 4)]


def _x_view(gen, M, n, d_in, pad, off, device, dtype, draw=None):
    rows = (draw or _randn)(gen, M, n * d_in + pad, device=device,
                            dtype=dtype)
    return rows[:, off:off + n * d_in]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,n,d_in,d_out,variant,pad,off", TC_EDGE_SHAPES)
def test_dyad_mm_kernel_tile_edges(cuda, M, n, d_in, d_out, variant, pad,
                                   off, dtype):
    gen = torch.Generator(device=cuda).manual_seed(M + d_out)
    x = _x_view(gen, M, n, d_in, pad, off, cuda, dtype)
    assert x.stride(0) == n * d_in + pad
    w1 = (_randn(gen, n, d_out, d_in, device=cuda) / d_in ** 0.5).to(dtype)
    w2 = (_randn(gen, n, d_out, d_in, device=cuda) / d_in ** 0.5).to(dtype)
    before = dyad_mm.dyad_mm_blocks.launches
    got = dyad_mm.dyad_mm_blocks(x, w1, w2, variant)
    torch.cuda.synchronize()
    assert dyad_mm.dyad_mm_blocks.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, n, d_out)
    _close(got, dyad_mm.dyad_mm_blocks_plain(x, w1, w2, variant), dtype)


def _randint(gen, *shape, device, dtype=torch.bfloat16):
    """Integers in [-2, 2]: bf16 holds them exactly, and every product
    and fp32 sum of a few thousand of them is exact in any order."""
    return torch.randint(-2, 3, shape, generator=gen, device=device).to(
        dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("M,n,d_in,d_out,variant,pad,off", [
    (4096, 4, 256, 768, "it", 0, 0), (4096, 4, 256, 768, "ot", 0, 0),
    (4096, 4, 256, 768, "dt", 0, 0), (4096, 4, 768, 256, "it", 0, 0),
    *TC_EDGE_SHAPES])
def test_dyad_mm_bf16_integer_inputs_are_exact(cuda, M, n, d_in, d_out,
                                               variant, pad, off):
    """The tensor-core route (both operands K-major, the components fused
    into one accumulator) on integer-valued bf16 inputs: the fp32 sums
    are exact, so the result is the plain version's, summed in fp32 and
    rounded once, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(M + d_in)
    x = _x_view(gen, M, n, d_in, pad, off, cuda, torch.bfloat16,
                draw=_randint)
    w1, w2 = (_randint(gen, n, d_out, d_in, device=cuda) for _ in range(2))
    got = dyad_mm.dyad_mm_blocks(x, w1, w2, variant)
    want = dyad_mm.dyad_mm_blocks_plain(x.float(), w1.float(), w2.float(),
                                        variant).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,K,G,h,causal,window,q_off,k_off", [
    (8, 128, 160, 12, 1, 64, True, None, 0, 0),
    (3, 20, 28, 2, 2, 16, True, 9, [0, 4, 30], [0, 2, 40]),
    (2, 37, 37, 1, 4, 128, False, None, 0, 0),
    (1, 8, 16, 2, 2, 16, True, None, 0, 20),         # all rows masked
    (8, 512, 512, 8, 2, 128, True, None, 0, 0),     # Qwen3-0.6B's training
    (2, 70, 70, 2, 2, 80, True, None, 0, 0),        # h 80: padded to 128
    # S < T with per-batch offsets and a window (batch 2's first rows
    # fully masked)
    (3, 40, 100, 2, 2, 128, True, 48, [60, 10, 0], [0, 5, 20]),
    (2, 33, 33, 3, 2, 16, True, 5, 3, 3),           # h 16: padded to 64
    (2, 100, 100, 2, 4, 64, True, 40, 0, 0),        # G 4, a window
    # OPT-125m's training attention (fp32: split TF32)
    (8, 512, 512, 12, 1, 64, True, None, 0, 0),
    # Qwen3-0.6B's serving prefill (B 8, 128 prompt tokens of a 160-slot
    # cache): the shape its fp32 cache runs the fp32 route at
    (8, 128, 160, 8, 2, 128, True, None, 0, 0),
    # h 96 and 32 padded, odd h (every row off 16 bytes), many key tiles
    (2, 130, 200, 2, 2, 96, True, None, 70, 0),
    (2, 65, 130, 2, 1, 17, False, None, 0, 0),
    (3, 150, 150, 1, 2, 32, True, 100, [0, 7, 50], [0, 0, 10]),
])
def test_flash_prefill_kernel_matches_plain(cuda, B, S, T, K, G, h, causal,
                                            window, q_off, k_off, dtype):
    gen = torch.Generator(device=cuda).manual_seed(S + T)
    q = _randn(gen, B, S, K, G, h, device=cuda, dtype=dtype)
    k = _randn(gen, B, T, K, h, device=cuda, dtype=dtype)
    v = _randn(gen, B, T, K, h, device=cuda, dtype=dtype)
    if isinstance(q_off, list):
        q_off = torch.tensor(q_off, device=cuda)
        k_off = torch.tensor(k_off, device=cuda)
    kw = dict(causal=causal, window=window, save_lse=True)
    before = flash_attn.flash_prefill.launches
    o, lse = flash_attn.flash_prefill(q, k, v, q_off, k_off, **kw)
    po, plse = flash_attn.flash_prefill_plain(q, k, v, q_off, k_off, **kw)
    torch.cuda.synchronize()
    assert flash_attn.flash_prefill.launches == before + 1
    assert o.dtype == dtype and bool(torch.isfinite(o.float()).all())
    _close(o, po, dtype)
    live = plse > -1e29
    if live.any():
        _close(lse[live], plse[live], dtype)
    # a row with no live key: m + log(max(l, 1e-30)) = -1e30, bit for bit
    assert torch.equal(lse[~live], plse[~live])
    assert bool((o[(~live).reshape(B, K, S, G).permute(0, 2, 1, 3)]
                 == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("view", ["unaligned", "aligned"])
def test_flash_prefill_bf16_reads_strided_views(cuda, h, view):
    """q, k and v as views into wider tensors, against the plain version on
    the same views: strides off a multiple of 8 elements (the tensor-core
    kernel stages them element by element), or 16-byte aligned strides of
    views that are not contiguous (q permuted, k and v halves of wider
    rows), which cp.async copies."""
    gen = torch.Generator(device=cuda).manual_seed(h)
    B, S, K, G = 2, 90, 2, 2
    bf16 = torch.bfloat16
    if view == "unaligned":
        q = _randn(gen, B, S, K, G, h + 3, device=cuda,
                   dtype=bf16)[..., 1:h + 1]
        k, v = (_randn(gen, B, S, K, h + 5, device=cuda, dtype=bf16)[..., :h]
                for _ in range(2))
    else:
        q = _randn(gen, B, K, G, S, h, device=cuda,
                   dtype=bf16).permute(0, 3, 1, 2, 4)
        k, v = (_randn(gen, B, S, K, 2 * h, device=cuda, dtype=bf16)[..., h:]
                for _ in range(2))
    before = flash_attn.flash_prefill.launches
    o, lse = flash_attn.flash_prefill(q, k, v, save_lse=True)
    po, plse = flash_attn.flash_prefill_plain(q, k, v, save_lse=True)
    torch.cuda.synchronize()
    assert flash_attn.flash_prefill.launches == before + 1
    _close(o, po, bf16)
    _close(lse, plse, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("h", [64, 128, 80])
@pytest.mark.parametrize("view", ["unaligned", "aligned"])
def test_flash_prefill_fp32_reads_strided_views(cuda, h, view):
    """The split-TF32 route on q, k and v as views into wider tensors:
    strides off a multiple of 4 elements (staged element by element) or
    16-byte aligned strides of views that are not contiguous (copied by
    cp.async), against the plain version on the same views."""
    gen = torch.Generator(device=cuda).manual_seed(h + 1)
    B, S, K, G = 2, 90, 2, 2
    if view == "unaligned":
        q = _randn(gen, B, S, K, G, h + 3, device=cuda)[..., 1:h + 1]
        k, v = (_randn(gen, B, S, K, h + 5, device=cuda)[..., :h]
                for _ in range(2))
    else:
        q = _randn(gen, B, K, G, S, h, device=cuda).permute(0, 3, 1, 2, 4)
        k, v = (_randn(gen, B, S, K, 2 * h, device=cuda)[..., h:]
                for _ in range(2))
    o, lse = flash_attn.flash_prefill(q, k, v, save_lse=True)
    po, plse = flash_attn.flash_prefill_plain(q, k, v, save_lse=True)
    torch.cuda.synchronize()
    _close(o, po, torch.float32)
    _close(lse, plse, torch.float32)


def _tf32_case(kernel, shape, draw):
    """(kernel call, plain version over given operands, the operands, which
    of them a product reads) of a split-TF32 case, both calls returning a
    tuple of outputs: dyad_mm_blocks (M, n, d_in, d_out, variant),
    flash_prefill (B, S, K, G, h, window, causal), dyad_mm_dgrad_two (M, n,
    d_in, d_out, "it" for z2 = z1 or "dt" for the strided z2),
    dyad_mm_dgrad (M, n, d_in, d_out; z2 the OT's stride-n z2bar),
    dyad_mm_wgrad (M, n, d_in, d_out, "it" for x2 the stride-n view and z2
    = z1, or "ot" for x2 = x1 and z2 the stride-n z2bar; fp32 out) or
    flash_prefill_grads (B, S, T, K, G, h, window, q_off, k_off; causal),
    dyad_mm_blocks_two (M, n, d_in, d_out, "ot" for x2 = x1 or "dt" for
    the stride-n x2) or dyad_mm_blocks_q and dyad_mm_blocks_two_q (M, n,
    d_in, d_out, payload, "it" or "ot" x2; on the tensor-core route),
    operands from ``draw`` (flash_prefill_grads' o and lse, which no
    product reads, from the plain fp32 forward; the quantized GEMMs'
    payloads and scales quantized from drawn weights, the payloads read as
    they are: exact in tf32)."""
    if kernel == "dyad_mm_blocks_two":
        M, n, d_in, d_out, view = shape
        x = draw(M, n * d_in)
        x1 = x.reshape(M, n, d_in)
        x2 = x1 if view == "ot" else x.reshape(M, d_in, n).transpose(1, 2)
        ops = (x1, x2, draw(n, d_out, d_in), draw(n, d_out, d_in))
        return (lambda: dyad_mm.dyad_mm_blocks_two(*ops),
                lambda *t: dyad_mm.dyad_mm_blocks_two_plain(*t), ops,
                (True,) * 4)
    if kernel in ("dyad_mm_blocks_q", "dyad_mm_blocks_two_q"):
        from repro_torch import quant

        M, n, d_in, d_out, qdtype, view = shape
        x = draw(M, n * d_in)
        x1 = x.reshape(M, n, d_in)
        x2 = x1 if view == "ot" else x.reshape(M, d_in, n).transpose(1, 2)
        (q1, s1), (q2, s2) = (quant.quantize_dyad_weight(
            draw(n, d_out, d_in), qdtype) for _ in range(2))
        assert dyad_mm.mm_q_plan(M, n, d_in, d_out,
                                 dyad_mm.sm_count(x.device),
                                 torch.float32)[0] == "tc"
        ops = (x1, x2, q1, q2, s1, s2)
        read = (True, True, False, False, False, False)
        if kernel == "dyad_mm_blocks_q":
            return (lambda: (dyad_mm.dyad_mm_blocks_q(*ops),),
                    lambda *t: (dyad_mm.dyad_mm_blocks_q_plain(*t),), ops,
                    read)
        return (lambda: dyad_mm.dyad_mm_blocks_two_q(*ops),
                lambda *t: dyad_mm.dyad_mm_blocks_two_q_plain(*t), ops, read)
    if kernel == "dyad_mm_blocks":
        M, n, d_in, d_out, var = shape
        ops = (draw(M, n * d_in), draw(n, d_out, d_in), draw(n, d_out, d_in))
        return (lambda: (dyad_mm.dyad_mm_blocks(*ops, var),),
                lambda *t: (dyad_mm.dyad_mm_blocks_plain(*t, var),), ops,
                (True,) * 3)
    if kernel == "dyad_mm_dgrad_two":
        M, n, d_in, d_out, zl = shape
        g = draw(M, n * d_out)
        z1 = g.reshape(M, n, d_out)
        z2 = z1 if zl == "it" else g.reshape(M, d_out, n).transpose(1, 2)
        ops = (z1, z2, draw(n, d_out, d_in), draw(n, d_out, d_in))
        return (lambda: dyad_mm.dyad_mm_dgrad_two(*ops),
                lambda *t: dyad_mm.dyad_mm_dgrad_two_plain(*t), ops,
                (True,) * 4)
    if kernel == "dyad_mm_dgrad":
        M, n, d_in, d_out = shape
        g = draw(M, n * d_out)
        ops = (g.reshape(M, n, d_out), g.reshape(M, d_out, n).transpose(1, 2),
               draw(n, d_out, d_in), draw(n, d_out, d_in))
        return (lambda: (dyad_mm.dyad_mm_dgrad(*ops),),
                lambda *t: (dyad_mm.dyad_mm_dgrad_plain(*t),), ops,
                (True,) * 4)
    if kernel == "dyad_mm_wgrad":
        M, n, d_in, d_out, view = shape
        x, g = draw(M, n * d_in), draw(M, n * d_out)
        x1, z1 = x.reshape(M, n, d_in), g.reshape(M, n, d_out)
        ops = ((x1, x.reshape(M, d_in, n).transpose(1, 2), z1, z1)
               if view == "it" else
               (x1, x1, z1, g.reshape(M, d_out, n).transpose(1, 2)))
        return (lambda: dyad_mm.dyad_mm_wgrad(*ops),
                lambda *t: dyad_mm.dyad_mm_wgrad_plain(*t), ops,
                (True,) * 4)
    if kernel == "flash_prefill_grads":
        B, S, T, K, G, h, window, q_off, k_off = shape
        dev = draw(1).device
        q_off, k_off = (torch.tensor(o, device=dev) if isinstance(o, list)
                        else o for o in (q_off, k_off))
        kw = dict(causal=True, window=window)
        q, k, v = draw(B, S, K, G, h), draw(B, T, K, h), draw(B, T, K, h)
        o, lse = flash_attn.flash_prefill_plain(q, k, v, q_off, k_off,
                                                save_lse=True, **kw)
        ops = (q, k, v, o, lse, draw(B, S, K, G, h))
        return (lambda: flash_attn.flash_prefill_grads(*ops, q_off, k_off,
                                                       **kw),
                lambda *t: flash_attn.flash_prefill_grads_plain(
                    *t, q_off, k_off, **kw), ops,
                (True, True, True, False, False, True))
    B, S, K, G, h, window, causal = shape
    ops = (draw(B, S, K, G, h), draw(B, S, K, h), draw(B, S, K, h))
    kw = dict(causal=causal, window=window)
    return (lambda: flash_attn.flash_prefill(*ops, **kw)[:1],
            lambda *t: flash_attn.flash_prefill_plain(*t, **kw)[:1], ops,
            (True,) * 3)


SPLIT_CASES = [
    ("dyad_mm_blocks", (1024, 4, 192, 768, "it")),   # OPT-125m's up
    ("dyad_mm_blocks", (4096, 4, 768, 192, "it")),   # its down, training
    ("dyad_mm_blocks", (77, 3, 65, 130, "ot")),
    ("dyad_mm_blocks", (300, 4, 36, 129, "dt")),
    ("flash_prefill", (8, 512, 12, 1, 64, None, True)),   # OPT training
    ("flash_prefill", (2, 256, 2, 2, 128, None, True)),
    ("flash_prefill", (2, 150, 2, 2, 80, 40, True)),
    ("flash_prefill", (2, 37, 2, 2, 16, None, False)),
    # OPT-125m's up and down dx at the training rows, the IT cotangent
    # view and the DT strided z2; a ragged shape
    ("dyad_mm_dgrad_two", (4096, 4, 192, 768, "it")),
    ("dyad_mm_dgrad_two", (4096, 4, 768, 192, "it")),
    ("dyad_mm_dgrad_two", (4096, 4, 192, 768, "dt")),
    ("dyad_mm_dgrad_two", (77, 3, 65, 130, "dt")),
    # OPT-125m's up and down OT dx at the training rows (the stride-n
    # z2bar), and their weight cotangents with the IT and the OT views; a
    # ragged shape of each (the wgrad's rows split)
    ("dyad_mm_dgrad", (4096, 4, 192, 768)),
    ("dyad_mm_dgrad", (4096, 4, 768, 192)),
    ("dyad_mm_dgrad", (77, 3, 65, 130)),
    ("dyad_mm_wgrad", (4096, 4, 192, 768, "it")),
    ("dyad_mm_wgrad", (4096, 4, 768, 192, "it")),
    ("dyad_mm_wgrad", (4096, 4, 192, 768, "ot")),
    ("dyad_mm_wgrad", (4096, 4, 768, 192, "ot")),
    ("dyad_mm_wgrad", (77, 3, 65, 130, "ot")),
    # OPT-125m's training attention, h 128, h 80 with G 2 and a window,
    # S < T with per-batch offsets (batch 2's first 20 queries sit before
    # its first key: zero gradients)
    ("flash_prefill_grads", (8, 512, 512, 12, 1, 64, None, 0, 0)),
    ("flash_prefill_grads", (2, 256, 256, 2, 2, 128, None, 0, 0)),
    ("flash_prefill_grads", (2, 150, 150, 2, 2, 80, 40, 0, 0)),
    ("flash_prefill_grads", (3, 40, 100, 2, 2, 64, None, [60, 10, 0],
                             [0, 5, 20])),
    # OPT-125m's OT and DT forward at the training rows, up and down (x2 =
    # x1 copied, and the stride-n x2 gathered), and a ragged shape
    ("dyad_mm_blocks_two", (4096, 4, 192, 768, "ot")),
    ("dyad_mm_blocks_two", (4096, 4, 768, 192, "ot")),
    ("dyad_mm_blocks_two", (4096, 4, 192, 768, "dt")),
    ("dyad_mm_blocks_two", (4096, 4, 768, 192, "dt")),
    ("dyad_mm_blocks_two", (77, 3, 65, 130, "dt")),
    ("dyad_mm_blocks_two", (77, 4, 65, 130, "dt")),
    # the quantized GEMMs on fp32 x at OPT-125m's quantized prefill rows,
    # up and down over int8 and fp8 payloads, and a ragged shape
    ("dyad_mm_blocks_q", (1024, 4, 192, 768, "int8", "it")),
    ("dyad_mm_blocks_q", (1024, 4, 768, 192, "int8", "it")),
    ("dyad_mm_blocks_q", (1024, 4, 192, 768, "fp8", "it")),
    ("dyad_mm_blocks_q", (1024, 4, 768, 192, "fp8", "ot")),
    ("dyad_mm_blocks_q", (77, 3, 65, 130, "int8", "it")),
    ("dyad_mm_blocks_two_q", (1024, 4, 192, 768, "int8", "ot")),
    ("dyad_mm_blocks_two_q", (1024, 4, 768, 192, "int8", "it")),
    ("dyad_mm_blocks_two_q", (1024, 4, 192, 768, "fp8", "it")),
    ("dyad_mm_blocks_two_q", (1024, 4, 768, 192, "fp8", "ot")),
    ("dyad_mm_blocks_two_q", (77, 3, 65, 130, "fp8", "it")),
]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,shape", SPLIT_CASES)
def test_split_tf32_error_against_float64(cuda, kernel, shape):
    """The split-TF32 routes' largest error against the plain version run
    in float64 is at most F64_GATE times the plain fp32 version's (with
    allow_tf32 off) against the same product."""
    gen = torch.Generator(device=cuda).manual_seed(len(str(shape)))
    call, plain, ops, _ = _tf32_case(
        kernel, shape, lambda *s: _randn(gen, *s, device=cuda))
    exact = plain(*(t.double() for t in ops))
    for got, fp32, want in zip(call(), plain(*ops), exact):
        err = float((got.double() - want).abs().max())
        ref = float((fp32.double() - want).abs().max())
        assert err <= F64_GATE * ref, (err, ref)


def _tf32(t):
    """t rounded to TF32 as cvt.rna.tf32.f32 rounds it."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_every_payload_value_is_a_tf32_value(qdtype):
    """The premise of the fp32-x quantized GEMMs' two-product scheme: every
    int8 value and every finite e4m3 value equals its TF32 rounding, so
    the payload converted to fp32 is wgmma's tf32 operand as it is and
    needs no low term.  For int8 also the kernel's conversion, byte ^ 0x80
    as the low byte of 2^23's mantissa less 2^23 + 128, gives the value."""
    b = torch.arange(256, dtype=torch.int32)
    if qdtype == "int8":
        v = b.to(torch.uint8).view(torch.int8).float()
        magic = (b ^ 0x80) | 0x4B000000
        assert torch.equal(magic.view(torch.float32) - 8388736.0, v)
    else:
        v = b.to(torch.uint8).view(torch.float8_e4m3fn).float()
        v = v[torch.isfinite(v)]
        assert v.numel() == 254
    assert torch.equal(_tf32(v), v)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,shape", SPLIT_CASES)
def test_split_tf32_keeps_the_bits_one_tf32_product_drops(cuda, kernel,
                                                          shape):
    """On operands +-(1 + 2^-12), whose 2^-12 lies below TF32's 10-bit
    mantissa, the split routes are within SPLIT_REL of float64, where one
    TF32 product (operands rounded to TF32) is off by about 5e-4."""
    gen = torch.Generator(device=cuda).manual_seed(len(str(shape)) + 1)

    def draw(*s):
        sign = torch.randint(0, 2, s, generator=gen, device=cuda) * 2 - 1
        return sign.float() * (1 + 2.0 ** -12)

    call, plain, ops, product = _tf32_case(kernel, shape, draw)
    exact = plain(*(t.double() for t in ops))
    one = plain(*((_tf32(t) if p else t).double()
                  for t, p in zip(ops, product)))
    for got, want, tf32 in zip(call(), exact, one):
        scale = float(want.abs().max())
        assert float((tf32 - want).abs().max()) / scale > 1e-4
        assert float((got.double() - want).abs().max()) / scale <= SPLIT_REL


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,shape", SPLIT_CASES)
def test_split_tf32_gives_the_same_bits_every_run(cuda, kernel, shape):
    """No atomics in the split routes: five runs, another shape launched
    between, bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(len(str(shape)) + 2)
    draw = lambda *s: _randn(gen, *s, device=cuda)  # noqa: E731
    call = _tf32_case(kernel, shape, draw)[0]
    other = _tf32_case(kernel, {
        "dyad_mm_blocks": (9, 2, 40, 24, "it"),
        "dyad_mm_dgrad_two": (9, 2, 40, 24, "it"),
        "dyad_mm_dgrad": (9, 2, 40, 24),
        "dyad_mm_wgrad": (9, 2, 40, 24, "ot"),
        "flash_prefill_grads": (1, 70, 70, 1, 1, 64, None, 0, 0),
        "dyad_mm_blocks_two": (9, 2, 40, 24, "dt"),
        "dyad_mm_blocks_q": (9, 2, 40, 24, "int8", "ot"),
        "dyad_mm_blocks_two_q": (9, 2, 40, 24, "fp8", "it"),
    }.get(kernel, (1, 70, 1, 1, 64, None, True)), draw)[0]
    first = call()
    for _ in range(4):
        other()
        assert all(torch.equal(a, b) for a, b in zip(first, call()))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,K,G,h,window,q_off,k_off", [
    (8, 512, 8, 2, 128, None, 0, 0),        # Qwen3-0.6B's training shape
    (3, 75, 2, 4, 64, 16, [0, 5, 90], [0, 0, 3]),
])
def test_flash_prefill_bf16_gives_the_same_bits_every_run(
        cuda, B, S, K, G, h, window, q_off, k_off):
    """The tensor-core forward: five runs, o and lse bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q = _randn(gen, B, S, K, G, h, device=cuda, dtype=torch.bfloat16)
    k, v = (_randn(gen, B, S, K, h, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    if isinstance(q_off, list):
        q_off = torch.tensor(q_off, device=cuda)
        k_off = torch.tensor(k_off, device=cuda)
    kw = dict(causal=True, window=window, save_lse=True)
    first = flash_attn.flash_prefill(q, k, v, q_off, k_off, **kw)
    for _ in range(4):
        again = flash_attn.flash_prefill(q, k, v, q_off, k_off, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("window", [None, 70])
def test_flash_prefill_bf16_exact_sums_match_bitwise(cuda, h, window):
    """The tensor-core forward on inputs whose sums are exact: k = 0, so
    every valid score is 0 and p is exactly 1 (in bf16 too), and v in
    {-1, 0, 1}: o = (sum of v) / l, summed in fp32 and divided once, must be
    the plain version's bits, and lse = log(l) within 1e-6 relative."""
    gen = torch.Generator(device=cuda).manual_seed(h)
    B, S, K, G = 2, 200, 2, 2
    q = _randn(gen, B, S, K, G, h, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(B, S, K, h, device=cuda, dtype=torch.bfloat16)
    v = torch.randint(-1, 2, (B, S, K, h), generator=gen,
                      device=cuda).to(torch.bfloat16)
    kw = dict(causal=True, window=window, save_lse=True)
    o, lse = flash_attn.flash_prefill(q, k, v, **kw)
    po, plse = flash_attn.flash_prefill_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, po)
    assert bool(((lse - plse).abs() <= 1e-6 * plse.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,K,G,h,idx,window", [
    (8, 160, 12, 1, 64, 143, None),
    (4, 64, 3, 2, 64, [70, 150, 64, 200], 48),
    (3, 10, 2, 8, 16, [5, 20, 16], 7),
    (2, 300, 1, 4, 128, [0, 299], None),
])
def test_flash_decode_kernel_matches_plain(cuda, B, L, K, G, h, idx, window,
                                           dtype):
    gen = torch.Generator(device=cuda).manual_seed(L + G)
    q = _randn(gen, B, 1, K, G, h, device=cuda, dtype=dtype)
    k = _randn(gen, B, L, K, h, device=cuda, dtype=dtype)
    v = _randn(gen, B, L, K, h, device=cuda, dtype=dtype)
    if isinstance(idx, list):
        idx = torch.tensor(idx, device=cuda)
    before = flash_attn.flash_decode.launches
    got = flash_attn.flash_decode(q, k, v, idx, window=window)
    torch.cuda.synchronize()
    assert flash_attn.flash_decode.launches == before + 1
    _close(got, flash_attn.flash_decode_plain(q, k, v, idx, window=window),
           dtype)


def _ring_inputs(device, seed, B, L, K, G, h, q_dtype, cache_dtype):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = _randn(gen, B, 1, K, G, h, device=device, dtype=q_dtype)
    k = _randn(gen, B, L, K, h, device=device, dtype=cache_dtype)
    v = _randn(gen, B, L, K, h, device=device, dtype=cache_dtype)
    return q, k, v


def _ring_split_case(case, span):
    """(L, idxs, window) of a split-edge case of the ring decode, whose
    splits are blocks of ``span`` ring slots: L = 4 spans + 16 slots (the
    last split a partial one) but where named."""
    L = 4 * span + 16
    return {
        # unwrapped: a split's last slot, the next split's first, the last
        # slot, the first step
        "edges": (L, [span - 1, span, 2 * span - 1, 2 * span, L - 1, 0],
                  None),
        # wrapped rings, idx past one and two laps
        "wrapped": (L, [L, L + span - 1, L + span, 2 * L + 3, 3 * L - 1],
                    None),
        # the window's run of slots crosses the wrap point (its leading
        # splits at the ring's end, a gap in a tile), or empties the
        # ring's leading splits
        "window_wrap": (L, [L + 5, 2 * L + span, L + 3 * span + 5, L + 40],
                        span + 7),
        # a window of all but 10 slots: the dead run sits inside a tile,
        # live rows on both sides of it
        "window_gap": (L, [L + 70, 2 * L + 8, 3 * L - 20], L - 10),
        # L not a multiple of the span
        "l_not_multiple": (3 * span + 7, [3 * span + 6, 3 * span + 9,
                                          7 * span + 20, 40], None),
        # one slot in one split beside one in every split
        "one_and_every": (L, [5, L - 1, 3 * L], None),
        # the first step of each slot: one live key
        "idx0": (L, [0, 0, 1], None),
    }[case]


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["edges", "wrapped", "window_wrap",
                                  "window_gap", "l_not_multiple",
                                  "one_and_every", "idx0"])
def test_flash_decode_split_edges_match_plain(cuda, case, q_dtype,
                                              cache_dtype):
    """The kernel splits each slot's ring into blocks of RING_SPAN slots
    and merges them in the launch: every edge of that split, before and
    after the wrap and under a window, matches the plain version, for
    every pair of q and cache dtypes, at Qwen3's KV heads (K 8, G 2, h
    128)."""
    span = flash_attn.RING_SPAN
    L, idxs, window = _ring_split_case(case, span)
    q, k, v = _ring_inputs(cuda, 19, len(idxs), L, 8, 2, 128, q_dtype,
                           cache_dtype)
    idx = torch.tensor(idxs, dtype=torch.int32, device=cuda)
    before = flash_attn.flash_decode.launches
    got = flash_attn.flash_decode(q, k, v, idx, window=window)
    torch.cuda.synchronize()
    assert flash_attn.flash_decode.launches == before + 1
    assert got.dtype == q_dtype and got.shape == q.shape
    want = flash_attn.flash_decode_plain(q, k, v, idx, window=window)
    exact = q_dtype == cache_dtype == torch.float32
    _close(got, want, torch.float32 if exact else torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_slot_bits_do_not_depend_on_the_batch(cuda,
                                                           cache_dtype):
    """Each slot of a batch of 8 (one split to every split, wrapped or
    not) gives the same bits alone as in the batch."""
    span = flash_attn.RING_SPAN
    L = 512
    idxs = [0, span - 1, span, 2 * span + 3, 300, 511, 600, 1500]
    q, k, v = _ring_inputs(cuda, 23, 8, L, 8, 2, 128, torch.bfloat16,
                           cache_dtype)
    idx = torch.tensor(idxs, dtype=torch.int32, device=cuda)
    for window in (None, 200):
        batch = flash_attn.flash_decode(q, k, v, idx, window=window)
        for i in range(len(idxs)):
            alone = flash_attn.flash_decode(q[i:i + 1], k[i:i + 1],
                                            v[i:i + 1], idx[i:i + 1],
                                            window=window)
            assert torch.equal(alone, batch[i:i + 1]), (window, i)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_repeats_bitwise(cuda, cache_dtype):
    """Two calls give the same bits, also with a launch of another batch
    and ring length between them: the block that merges a slot's splits
    resets its counter."""
    q, k, v = _ring_inputs(cuda, 29, 4, 512, 8, 2, 128, torch.bfloat16,
                           cache_dtype)
    idx = torch.tensor([511, 130, 64, 900], dtype=torch.int32, device=cuda)
    first = flash_attn.flash_decode(q, k, v, idx)
    q2, k2, v2 = _ring_inputs(cuda, 31, 3, 160, 8, 2, 128, torch.bfloat16,
                              cache_dtype)
    flash_attn.flash_decode(q2, k2, v2, 143, window=100)
    again = flash_attn.flash_decode(q, k, v, idx)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert int(flash_attn._paged_counters[q.device].abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,idxs,window", [
    (160, [143, 0, 37, 159], None),          # rows past idx: never written
    (512, [600, 1000, 520, 70], 150),        # windows across the wrap
    (512, [582, 1000, 520, 70], 502),        # dead runs inside a tile
])
def test_flash_decode_dead_rows_are_never_read(cuda, L, idxs, window,
                                               cache_dtype):
    """NaN in every ring slot that holds no live position (past idx, or
    outside the window, which in a wrapped ring leaves a gap inside a
    tile) moves no bit of the output against clean dead rows."""
    q, k, v = _ring_inputs(cuda, 37, len(idxs), L, 8, 2, 128,
                           torch.bfloat16, cache_dtype)
    idx = torch.tensor(idxs, dtype=torch.int32, device=cuda)
    clean = flash_attn.flash_decode(q, k, v, idx, window=window)
    j = torch.arange(L, device=cuda)
    iv = idx.long()[:, None]
    pos = iv - torch.remainder(iv - j, L)
    dead = pos < 0
    if window is not None:
        dead |= iv - pos >= window
    assert bool(dead.any())
    k[dead] = float("nan")
    v[dead] = float("nan")
    got = flash_attn.flash_decode(q, k, v, idx, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("h", [128, 80])
def test_flash_decode_rows_off_16_bytes_match_plain(cuda, h):
    """A cache whose rows do not start on 16 bytes (a view one element
    into a wider buffer) goes element by element, and matches the plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(41)
    B, L, K, G = 3, 200, 4, 2
    q = _randn(gen, B, 1, K, G, h, device=cuda)
    k = _randn(gen, B, L, K, h + 1, device=cuda)[..., 1:]
    v = _randn(gen, B, L, K, h + 1, device=cuda)[..., 1:]
    idx = torch.tensor([199, 250, 5], dtype=torch.int32, device=cuda)
    got = flash_attn.flash_decode(q, k, v, idx, window=120)
    torch.cuda.synchronize()
    _close(got, flash_attn.flash_decode_plain(q, k, v, idx, window=120),
           torch.float32)


@pytest.mark.gpu
def test_flash_decode_entry_refuses_a_short_workspace(cuda, monkeypatch):
    """The C entry works out the grid's splits itself and refuses a
    workspace sized for fewer (cudaErrorInvalidValue, 1) instead of
    writing past it."""
    q, k, v = _ring_inputs(cuda, 43, 2, 512, 8, 2, 128, torch.bfloat16,
                           torch.float32)
    monkeypatch.setattr(flash_attn, "paged_splits", lambda *a: 1)
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        flash_attn.flash_decode(q, k, v, 511)


@pytest.mark.gpu
def test_flash_decode_wrapper_raises(cuda):
    q, k, v = _ring_inputs(cuda, 47, 2, 64, 2, 2, 64, torch.float32,
                           torch.float32)
    with pytest.raises(TypeError):
        flash_attn.flash_decode(q.half(), k, v, 3)
    with pytest.raises(TypeError):
        flash_attn.flash_decode(q, k.to(torch.int8), v.to(torch.int8), 3)
    with pytest.raises(TypeError):
        flash_attn.flash_decode(q, k, v.bfloat16(), 3)
    with pytest.raises(ValueError):
        flash_attn.flash_decode(q, k.cpu(), v.cpu(), 3)
    with pytest.raises(ValueError):
        flash_attn.flash_decode(q, k[:, :0], v[:, :0], 3)


@pytest.mark.gpu
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.zeros(4, 32, device=cuda, dtype=torch.float16)
    w = torch.zeros(4, 8, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        dyad_mm.dyad_mm_blocks(x, w, w)
    z = x.reshape(4, 4, 8)
    with pytest.raises(TypeError):
        dyad_mm.dyad_mm_dgrad_two(z, z, w, w)
    with pytest.raises(TypeError):
        dyad_mm.dyad_mm_wgrad(z, z, z, z)
    with pytest.raises(ValueError, match="unsupported device"):
        dyad_mm.dyad_mm_wgrad(z.float(), z.float().cpu(), z.float(),
                              z.float())
    with pytest.raises(TypeError):
        dyad_mm.dyad_mm_blocks_two(z, z, w, w)
    with pytest.raises(TypeError):
        dyad_mm.dyad_mm_dgrad(z, z, w, w)
    with pytest.raises(TypeError):
        dyad_mm.dyad_ff_fused(z, z, w, w, w, w)
    # bf16 activations take bf16 or fp32 weights, not a mix
    zb = z.bfloat16()
    with pytest.raises(TypeError):
        dyad_mm.dyad_ff_fused(zb, zb, w.float(), w.bfloat16(), w.float(),
                              w.float())
    q = torch.zeros(1, 1, 1, 9, 16, device=cuda)
    kv = torch.zeros(1, 4, 1, 16, device=cuda)
    with pytest.raises(NotImplementedError):
        flash_attn.flash_decode(q, kv, kv, 0)


DGRAD_SHAPES = [
    # (M, n, d_in, d_out): the OPT-125m training up/down, then ragged, then
    # Qwen3-0.6B's up/gate and down at the training rows (bf16 in its step)
    (4096, 4, 192, 768), (4096, 4, 768, 192), (129, 2, 13, 130),
    (7, 3, 5, 3), (100, 1, 64, 65), (4096, 4, 256, 768),
    (4096, 4, 768, 256)]

# shapes off the tensor-core tiles: ragged rows and dims on unaligned
# strides (every operand gathered), 16-byte aligned strides with ragged
# copies (n 2; n 4, whose stride-n views load 16-byte runs, over a split
# of ragged row ranges in the wgrad)
TC_SHAPES = [(300, 3, 200, 130), (200, 2, 136, 72), (200, 4, 136, 72)]


def _it_views(x, g, n):
    """The IT operands the backward passes: x1, the stride-n x2 and the
    shared cotangent view."""
    M = x.shape[0]
    x1 = x.reshape(M, n, -1)
    x2 = x.reshape(M, -1, n).transpose(1, 2)
    z = g.reshape(M, n, -1)
    return x1, x2, z


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,n,d_in,d_out", DGRAD_SHAPES + TC_SHAPES)
def test_dyad_dgrad_two_kernel_matches_plain(cuda, M, n, d_in, d_out,
                                             dtype):
    gen = torch.Generator(device=cuda).manual_seed(M + d_in)
    g = _randn(gen, M, n * d_out, device=cuda, dtype=dtype)
    w1 = (_randn(gen, n, d_out, d_in, device=cuda) / d_out ** 0.5).to(dtype)
    w2 = (_randn(gen, n, d_out, d_in, device=cuda) / d_out ** 0.5).to(dtype)
    z = g.reshape(M, n, d_out)
    # IT: one cotangent view for both components; DT: a strided z2
    z2 = g.reshape(M, d_out, n).transpose(1, 2)
    for za, zb in ((z, z), (z, z2)):
        before = dyad_mm.dyad_mm_dgrad_two.launches
        dx1, dx2 = dyad_mm.dyad_mm_dgrad_two(za, zb, w1, w2)
        torch.cuda.synchronize()
        assert dyad_mm.dyad_mm_dgrad_two.launches == before + 1
        p1, p2 = dyad_mm.dyad_mm_dgrad_two_plain(za, zb, w1, w2)
        assert dx1.dtype == dtype and dx2.shape == (M, n, d_in)
        _close(dx1, p1, dtype)
        _close(dx2, p2, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("M,n,d_in,d_out", [
    (4096, 4, 256, 768), (4096, 4, 768, 256), *TC_SHAPES, (100, 1, 64, 65)])
def test_dyad_dgrad_two_bf16_integer_inputs_are_exact(cuda, M, n, d_in,
                                                      d_out):
    """The tensor-core route (z K-major, w N-major, the components apart,
    dx2 written permuted) on integer-valued bf16 inputs, IT and DT
    cotangents: bit for bit the plain version (fp32 sums, one rounding)."""
    gen = torch.Generator(device=cuda).manual_seed(M + d_out)
    g = _randint(gen, M, n * d_out, device=cuda)
    w1, w2 = (_randint(gen, n, d_out, d_in, device=cuda) for _ in range(2))
    z = g.reshape(M, n, d_out)
    for zb in (z, g.reshape(M, d_out, n).transpose(1, 2)):
        got = dyad_mm.dyad_mm_dgrad_two(z, zb, w1, w2)
        want = dyad_mm.dyad_mm_dgrad_two_plain(z, zb, w1, w2)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# the wgrad shapes: DGRAD_SHAPES, TC_SHAPES and a split row reduction
WGRAD_SHAPES = DGRAD_SHAPES + TC_SHAPES + [(2048, 1, 64, 65)]


def _wgrad_views(x, g, n, view):
    """(x1, x2, z1, z2) as the backward passes them: IT (x1, the stride-n
    x2, one cotangent view) or the OT down projection (one contiguous
    input for both, the cotangent's block view and its stride-n z2bar)."""
    x1, x2, z = _it_views(x, g, n)
    if view == "it":
        return x1, x2, z, z
    M = g.shape[0]
    return x1, x1, z, g.reshape(M, -1, n).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("view", ["it", "ot"])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("M,n,d_in,d_out", WGRAD_SHAPES)
def test_dyad_wgrad_kernel_matches_plain(cuda, M, n, d_in, d_out, dtype,
                                         out_dtype, view):
    gen = torch.Generator(device=cuda).manual_seed(M + d_out)
    x = _randn(gen, M, n * d_in, device=cuda, dtype=dtype)
    g = _randn(gen, M, n * d_out, device=cuda, dtype=dtype)
    x1, x2, z1, z2 = _wgrad_views(x, g, n, view)
    before = dyad_mm.dyad_mm_wgrad.launches
    dw1, dw2 = dyad_mm.dyad_mm_wgrad(x1, x2, z1, z2, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert dyad_mm.dyad_mm_wgrad.launches == before + 1
    p1, p2 = dyad_mm.dyad_mm_wgrad_plain(x1, x2, z1, z2,
                                         out_dtype=out_dtype)
    assert dw1.dtype == out_dtype and dw2.shape == (n, d_out, d_in)
    _close(dw1, p1, dtype)
    _close(dw2, p2, dtype)
    # the split row reduction is fixed: a second call is bitwise equal
    again = dyad_mm.dyad_mm_wgrad(x1, x2, z1, z2, out_dtype=out_dtype)
    assert torch.equal(again[0], dw1) and torch.equal(again[1], dw2)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,n,d_in,d_out", [
    (4096, 4, 256, 768), (4096, 4, 768, 256), (2048, 1, 64, 65)])
def test_dyad_wgrad_bf16_gives_the_same_bits_every_run(cuda, M, n, d_in,
                                                       d_out, out_dtype):
    """The tensor-core wgrad at Qwen3's shapes (no split) and at a split
    one: five runs of each view, bitwise equal (no atomics; the partials
    add in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(M + d_in)
    x = _randn(gen, M, n * d_in, device=cuda, dtype=torch.bfloat16)
    g = _randn(gen, M, n * d_out, device=cuda, dtype=torch.bfloat16)
    for view in ("it", "ot"):
        args = _wgrad_views(x, g, n, view)
        first = dyad_mm.dyad_mm_wgrad(*args, out_dtype=out_dtype)
        for _ in range(4):
            again = dyad_mm.dyad_mm_wgrad(*args, out_dtype=out_dtype)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,K,G,h,causal,window,q_off,k_off", [
    (2, 512, 512, 4, 1, 64, True, None, 0, 0),      # the training shape
    (3, 20, 20, 2, 2, 16, True, 9, [0, 4, 30], [0, 2, 40]),
    (2, 37, 37, 1, 4, 128, False, None, 0, 0),
    (1, 8, 8, 2, 2, 16, True, None, 0, 20),         # all rows masked
    (2, 33, 33, 3, 2, 32, True, 5, 3, 3),
    (8, 512, 512, 8, 2, 128, True, None, 0, 0),     # Qwen3-0.6B's training
    (2, 70, 70, 2, 2, 80, True, None, 0, 0),        # h 80: padded to 128
    (2, 100, 100, 2, 4, 64, True, 40, 0, 0),        # G 4, a window
    (2, 40, 100, 2, 2, 64, True, None, 60, 0),      # S < T: a cached prefix
])
def test_flash_prefill_grads_kernel_matches_plain(cuda, B, S, T, K, G, h,
                                                  causal, window, q_off,
                                                  k_off, dtype):
    gen = torch.Generator(device=cuda).manual_seed(S + h)
    q = _randn(gen, B, S, K, G, h, device=cuda, dtype=dtype)
    k = _randn(gen, B, T, K, h, device=cuda, dtype=dtype)
    v = _randn(gen, B, T, K, h, device=cuda, dtype=dtype)
    do = _randn(gen, B, S, K, G, h, device=cuda, dtype=dtype)
    if isinstance(q_off, list):
        q_off = torch.tensor(q_off, device=cuda)
        k_off = torch.tensor(k_off, device=cuda)
    kw = dict(causal=causal, window=window)
    o, lse = flash_attn.flash_prefill_plain(q, k, v, q_off, k_off,
                                            save_lse=True, **kw)
    before = flash_attn.flash_prefill_grads.launches
    got = flash_attn.flash_prefill_grads(q, k, v, o, lse, do, q_off, k_off,
                                         **kw)
    torch.cuda.synchronize()
    assert flash_attn.flash_prefill_grads.launches == before + 1
    want = flash_attn.flash_prefill_grads_plain(q, k, v, o, lse, do, q_off,
                                                k_off, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dtype and bool(torch.isfinite(a.float()).all())
        _close(a, b, dtype)


@pytest.mark.gpu
def test_flash_prefill_grads_bf16_reads_strided_views(cuda):
    """q, do, k and v as views whose strides are off a multiple of 8
    elements (the tensor-core kernels stage them element by element, not
    by cp.async), against the plain version on the same views."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    B, S, K, G, h = 2, 90, 2, 2, 64
    bf16 = torch.bfloat16
    q, do = (_randn(gen, B, S, K, G, h + 3, device=cuda,
                    dtype=bf16)[..., 1:h + 1] for _ in range(2))
    k, v = (_randn(gen, B, S, K, h + 5, device=cuda, dtype=bf16)[..., :h]
            for _ in range(2))
    o, lse = flash_attn.flash_prefill_plain(q, k, v, save_lse=True)
    got = flash_attn.flash_prefill_grads(q, k, v, o, lse, do)
    want = flash_attn.flash_prefill_grads_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _close(a, b, bf16)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,K,G,h,window,q_off,k_off", [
    (8, 512, 8, 2, 128, None, 0, 0),        # Qwen3-0.6B's training shape
    (3, 75, 2, 4, 64, 16, [0, 5, 90], [0, 0, 3]),
])
def test_flash_prefill_grads_bf16_gives_the_same_bits_every_run(
        cuda, B, S, K, G, h, window, q_off, k_off):
    """The tensor-core backward has no atomics: five runs, bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    bf16 = torch.bfloat16
    q, do = (_randn(gen, B, S, K, G, h, device=cuda, dtype=bf16)
             for _ in range(2))
    k, v = (_randn(gen, B, S, K, h, device=cuda, dtype=bf16)
            for _ in range(2))
    if isinstance(q_off, list):
        q_off = torch.tensor(q_off, device=cuda)
        k_off = torch.tensor(k_off, device=cuda)
    kw = dict(causal=True, window=window)
    o, lse = flash_attn.flash_prefill(q, k, v, q_off, k_off, save_lse=True,
                                      **kw)
    first = flash_attn.flash_prefill_grads(q, k, v, o, lse, do, q_off,
                                           k_off, **kw)
    for _ in range(4):
        again = flash_attn.flash_prefill_grads(q, k, v, o, lse, do, q_off,
                                               k_off, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def _exact_grads_inputs(gen, B, S, K, G, h, zero, device):
    """Inputs whose bf16 backward has exact fp32 sums: lse = 0 and k = 0
    (or q = 0), so every score is 0 and p is exactly 1 on the valid pairs;
    q (or k), v, o and do in {-1, 0, 1}, so dv = sum do, and at h 64 (scale
    1/8) ds = (dP - delta) / 8 with |dP - delta| <= 128 is exact in bf16,
    and dk = sum ds q, dq = sum ds k are exact."""
    def draw(*shape):
        return torch.randint(-1, 2, shape, generator=gen,
                             device=device).to(torch.bfloat16)

    q, o, do = (draw(B, S, K, G, h) for _ in range(3))
    k, v = draw(B, S, K, h), draw(B, S, K, h)
    (k if zero == "k" else q).zero_()
    lse = torch.zeros(B, K, S * G, device=device)
    return q, k, v, o, lse, do


@pytest.mark.gpu
@pytest.mark.parametrize("h,zero,exact", [
    (64, "k", ("dq", "dk", "dv")), (64, "q", ("dq", "dk", "dv")),
    (128, "k", ("dv",)), (128, "q", ("dv",))])
def test_flash_prefill_grads_bf16_integer_inputs_are_exact(cuda, h, zero,
                                                           exact):
    """The tensor-core backward (p and ds rounded to bf16 in registers and
    fed back as wgmma's A) on inputs whose sums are exact: the grads are
    the plain version's, summed in fp32 and rounded once, bit for bit.  At
    h 128 the scale is not a power of two, so only dv is exact there."""
    gen = torch.Generator(device=cuda).manual_seed(h)
    args = _exact_grads_inputs(gen, 2, 200, 2, 2, h, zero, cuda)
    got = flash_attn.flash_prefill_grads(*args)
    want = flash_attn.flash_prefill_grads_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if name in exact:
            assert torch.equal(a, b), name
        else:
            _close(a, b, torch.bfloat16)


@pytest.mark.gpu
def test_train_step_on_the_card_runs_the_kernels(cuda, monkeypatch):
    """One OPT smoke train step on the card: every kernel of the training
    path launches, and the kernel backward equals the plain one forced
    with REPRO_KERNEL_BWD=xla on the same params and batch."""
    from repro_torch import configs, tree
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamW, schedule
    from repro_torch.train import step as step_lib

    cfg = configs.get("opt125m", smoke=True,
                      linear=configs.linear_cfg("dyad_it_4_kernel"))
    opt = AdamW(lr=schedule.constant(1e-3))
    batch = SyntheticLM(cfg.vocab_size, 64, 4, device="cuda").batch(0)
    grads = {}
    for route in ("pallas", "xla"):
        monkeypatch.setenv("REPRO_KERNEL_BWD", route)
        state = step_lib.init_train_state(
            cfg, opt, torch.Generator(device=cuda).manual_seed(0), device=cuda)
        for w in WRAPPERS:
            w.launches = 0
        metrics, grads[route] = step_lib.loss_and_grads(
            cfg, state["params"], batch)
        torch.cuda.synchronize()
        launches = [w.launches for w in WRAPPERS]
        n = cfg.n_layers
        want = ([2 * n, 2 * n, 2 * n, n, n, 0, 0, 0, 0] if route == "pallas"
                else [2 * n, 0, 0, n, 0, 0, 0, 0, 0])
        assert launches == want, (route, launches)
        assert bool(torch.isfinite(metrics["loss"]))
    for a, b in zip(tree.leaves(grads["pallas"]), tree.leaves(grads["xla"])):
        _close(a, b, torch.float32)


# -- the ff megakernel slice: dyad_mm_blocks_two, dyad_mm_dgrad, dyad_ff_fused

TWO_SHAPES = [
    # (M, n, d_in, d_out): Qwen3-0.6B's split-route down projection at the
    # training rows, OPT-125m's OT/DT up and down, then ragged
    (4096, 4, 768, 256), (4096, 4, 192, 768), (8, 4, 768, 192),
    (129, 2, 13, 130), (7, 3, 5, 3),
    # n 4 off the tiles (fp32: the four blocks' cluster writes z2)
    (200, 4, 136, 72), (77, 4, 65, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,n,d_in,d_out", TWO_SHAPES)
def test_dyad_blocks_two_kernel_matches_plain(cuda, M, n, d_in, d_out,
                                              dtype):
    gen = torch.Generator(device=cuda).manual_seed(M + d_out)
    x = _randn(gen, M, n * d_in, device=cuda, dtype=dtype)
    w1 = (_randn(gen, n, d_out, d_in, device=cuda) / d_in ** 0.5).to(dtype)
    w2 = (_randn(gen, n, d_out, d_in, device=cuda) / d_in ** 0.5).to(dtype)
    x1 = x.reshape(M, n, d_in)
    # OT: x2 = x1; DT: the stride-n view
    for xb in (x1, x.reshape(M, d_in, n).transpose(1, 2)):
        before = dyad_mm.dyad_mm_blocks_two.launches
        z1, z2 = dyad_mm.dyad_mm_blocks_two(x1, xb, w1, w2)
        torch.cuda.synchronize()
        assert dyad_mm.dyad_mm_blocks_two.launches == before + 1
        p1, p2 = dyad_mm.dyad_mm_blocks_two_plain(x1, xb, w1, w2)
        assert z1.dtype == dtype and z2.shape == (M, n, d_out)
        _close(z1, p1, dtype)
        _close(z2, p2, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("M,n,d_in,d_out", [
    # Qwen3-0.6B's split-route down at the training and decode rows; off
    # the tensor-core tiles: n 3 (the stride-n x2 gathered element by
    # element) and n 4 (its 16-byte runs)
    (4096, 4, 768, 256), (8, 4, 768, 256), (300, 3, 200, 130),
    (200, 4, 136, 72)])
def test_dyad_blocks_two_bf16_integer_inputs_are_exact(cuda, M, n, d_in,
                                                       d_out):
    """The bf16 route (the tensor-core mainloop, both operands K-major,
    the components apart) on integer-valued inputs, x2 = x1 (OT) and the
    stride-n view (DT): the fp32 sums are exact, so the result is the
    plain version's, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(M + d_in)
    x = _randint(gen, M, n * d_in, device=cuda)
    w1, w2 = (_randint(gen, n, d_out, d_in, device=cuda) for _ in range(2))
    x1 = x.reshape(M, n, d_in)
    for xb in (x1, x.reshape(M, d_in, n).transpose(1, 2)):
        before = dyad_mm.dyad_mm_blocks_two.launches
        got = dyad_mm.dyad_mm_blocks_two(x1, xb, w1, w2)
        torch.cuda.synchronize()
        assert dyad_mm.dyad_mm_blocks_two.launches == before + 1
        want = dyad_mm.dyad_mm_blocks_two_plain(x1, xb, w1, w2)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_dyad_blocks_two_bf16_gives_the_same_bits_every_run(cuda):
    """No atomics on the tensor-core route: Qwen3's split-route down with
    the stride-n x2, twice, the same bits."""
    M, n, d_in, d_out = 4096, 4, 768, 256
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _randn(gen, M, n * d_in, device=cuda, dtype=torch.bfloat16)
    w1, w2 = ((_randn(gen, n, d_out, d_in, device=cuda) / d_in ** 0.5).to(
        torch.bfloat16) for _ in range(2))
    x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2)
    before = dyad_mm.dyad_mm_blocks_two.launches
    a = dyad_mm.dyad_mm_blocks_two(x1, x2, w1, w2)
    b = dyad_mm.dyad_mm_blocks_two(x1, x2, w1, w2)
    torch.cuda.synchronize()
    assert dyad_mm.dyad_mm_blocks_two.launches == before + 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,n,d_in,d_out", [
    # Qwen3-0.6B's down dh at the training rows; OPT-125m's OT dx
    (4096, 4, 768, 256), (4096, 4, 192, 768), (129, 2, 13, 130),
    (7, 3, 5, 3),
    # off the tensor-core tiles: exactly one tile, ragged rows and dims on
    # unaligned strides, 16-byte aligned strides with ragged copies
    (128, 4, 128, 64), (300, 3, 200, 130), (200, 2, 136, 72),
    (200, 4, 136, 72)])
def test_dyad_dgrad_fused_kernel_matches_plain(cuda, M, n, d_in, d_out,
                                               dtype):
    gen = torch.Generator(device=cuda).manual_seed(M + d_in)
    g = _randn(gen, M, n * d_out, device=cuda, dtype=dtype)
    w1 = (_randn(gen, n, d_out, d_in, device=cuda) / d_out ** 0.5).to(dtype)
    w2 = (_randn(gen, n, d_out, d_in, device=cuda) / d_out ** 0.5).to(dtype)
    # the OT cotangent views: block-contiguous z1, the stride-n z2bar
    z1 = g.reshape(M, n, d_out)
    z2 = g.reshape(M, d_out, n).transpose(1, 2)
    before = dyad_mm.dyad_mm_dgrad.launches
    dx = dyad_mm.dyad_mm_dgrad(z1, z2, w1, w2)
    torch.cuda.synchronize()
    assert dyad_mm.dyad_mm_dgrad.launches == before + 1
    assert dx.dtype == dtype and dx.shape == (M, n, d_in)
    _close(dx, dyad_mm.dyad_mm_dgrad_plain(z1, z2, w1, w2), dtype)


FF_SHAPES = [
    # (M, n, d_in_b, d_ff_b, d_out_b): Qwen3-0.6B at the training, prefill,
    # prefill-chunk and decode rows (bf16: the tensor-core kernel unsplit,
    # then split into 2, 12 and 12 ranges), then ragged edges, an output
    # wider than a tile, and a 2-block layer on Qwen3's d_model (d_in_b 512,
    # past the tensor-core kernel's resident x: bf16 on the FMA kernel)
    (4096, 4, 256, 768, 256), (1024, 4, 256, 768, 256),
    (128, 4, 256, 768, 256), (8, 4, 256, 768, 256), (3, 2, 129, 130, 17),
    (45, 3, 33, 200, 300), (64, 2, 512, 768, 512)]


def _ff_case(cuda, M, n, d_in, d_ff, d_out, dtype, act, wdtype=None):
    gen = torch.Generator(device=cuda).manual_seed(M + d_ff)
    x = _randn(gen, M, n * d_in, device=cuda, dtype=dtype)
    x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2)
    n_up = 4 if act == "swiglu" else 2
    ups = [(_randn(gen, n, d_ff, d_in, device=cuda) / d_in ** 0.5).to(
        wdtype or dtype) for _ in range(n_up)]
    downs = [(_randn(gen, n, d_out, d_ff, device=cuda) / d_ff ** 0.5).to(
        wdtype or dtype) for _ in range(2)]
    gs = ups[2:] if act == "swiglu" else [None, None]
    return (x1, x2, ups[0], ups[1], downs[0], downs[1], *gs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "swiglu"])
@pytest.mark.parametrize("M,n,d_in,d_ff,d_out", FF_SHAPES)
def test_dyad_ff_fused_kernel_matches_plain(cuda, M, n, d_in, d_ff, d_out,
                                            act, dtype):
    args = _ff_case(cuda, M, n, d_in, d_ff, d_out, dtype, act)
    # bf16 up to d_in_b 256 takes the tensor-core kernel, the rest FMA
    kernel = dyad_mm.ff_plan(M, n, d_in, d_ff, d_out, dyad_mm.sm_count(cuda),
                             dtype)[0]
    assert kernel == ("tc" if dtype == torch.bfloat16 and d_in <= 256
                      else "fma")
    before = dyad_mm.dyad_ff_fused.launches
    z1, z2 = dyad_mm.dyad_ff_fused(*args, act=act)
    torch.cuda.synchronize()
    assert dyad_mm.dyad_ff_fused.launches == before + 1
    p1, p2 = dyad_mm.dyad_ff_fused_plain(*args, act=act)
    assert z1.dtype == dtype and z2.shape == (M, n, d_out)
    _close(z1, p1, dtype)
    _close(z2, p2, dtype)
    # the hidden split adds its partials in a fixed order: same bits again
    again = dyad_mm.dyad_ff_fused(*args, act=act)
    assert torch.equal(again[0], z1) and torch.equal(again[1], z2)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4096, 8])
def test_dyad_ff_fused_rounds_fp32_weights_in_kernel(cuda, M):
    """bf16 activations with the fp32 params: the C entry's cast (one
    launch into the wrapper's scratch) gives the same bits as casting the
    weights to bf16 before the call, unsplit (M 4096) and split (M 8)."""
    args = _ff_case(cuda, M, 4, 256, 768, 256, torch.bfloat16, "swiglu",
                    wdtype=torch.float32)
    got = dyad_mm.dyad_ff_fused(*args, act="swiglu")
    cast = [a if a is None or i < 2 else a.bfloat16()
            for i, a in enumerate(args)]
    want = dyad_mm.dyad_ff_fused(*cast, act="swiglu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("M", [4096, 128])
def test_dyad_ff_fused_bf16_relu_integer_inputs_are_exact(cuda, M):
    """Qwen3-0.6B's widths with relu on integers in [-2, 2] (the fp32
    params, as the main path hands them over): the up sums are exact in
    fp32, the hidden rounds to bf16 the same way on both sides and the
    down sums stay below 2^24, so the tensor-core kernel (unsplit at
    M 4096, split at 128) gives the plain version's bits."""
    n, d_in, d_ff, d_out = 4, 256, 768, 256
    assert dyad_mm.ff_plan(M, n, d_in, d_ff, d_out, dyad_mm.sm_count(cuda),
                           torch.bfloat16)[0] == "tc"
    gen = torch.Generator(device=cuda).manual_seed(M)
    x = _randint(gen, M, n * d_in, device=cuda)
    x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2)
    ws = [_randint(gen, n, d_ff, d_in, device=cuda, dtype=torch.float32)
          for _ in range(2)] + [
        _randint(gen, n, d_out, d_ff, device=cuda, dtype=torch.float32)
        for _ in range(2)]
    before = dyad_mm.dyad_ff_fused.launches
    got = dyad_mm.dyad_ff_fused(x1, x2, *ws, act="relu")
    torch.cuda.synchronize()
    assert dyad_mm.dyad_ff_fused.launches == before + 1
    want = dyad_mm.dyad_ff_fused_plain(x1, x2, *ws, act="relu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_dyad_ff_fused_bf16_rows_keep_their_bits_at_every_serving_M(cuda):
    """At Qwen3's serving rows (up to 320) the tensor-core kernel splits
    the hidden into the same one-tile ranges, so a row's result has the
    same bits whether it is computed among 8, 128 or 300 rows (a decode
    step, a prefill chunk, a one-shot prompt)."""
    n, d_in, d_ff, d_out = 4, 256, 768, 256
    args = _ff_case(cuda, 300, n, d_in, d_ff, d_out, torch.bfloat16,
                    "swiglu", wdtype=torch.float32)
    x = args[0].reshape(300, n * d_in)
    outs = []
    for M in (8, 128, 300):
        xm = x[:M]
        z1, z2 = dyad_mm.dyad_ff_fused(
            xm.reshape(M, n, d_in), xm.reshape(M, d_in, n).transpose(1, 2),
            *args[2:], act="swiglu")
        outs.append((z1[:8], z2[:8]))
    torch.cuda.synchronize()
    for z1, z2 in outs[1:]:
        assert torch.equal(z1, outs[0][0]) and torch.equal(z2, outs[0][1])


@pytest.mark.gpu
@pytest.mark.parametrize("pad,off", [(8, 0), (3, 0), (8, 1)])
def test_dyad_ff_fused_bf16_reads_strided_views(cuda, pad, off):
    """x1 and x2 as views into a wider buffer: rows of n * d_in + pad from
    column off (16-byte aligned rows copied and gathered in 16-byte runs;
    rows off a multiple of 8 elements or a start off 16 bytes gathered
    element by element), at Qwen3's widths on the tensor-core kernel."""
    M, n, d_in, d_ff, d_out = 1024, 4, 256, 768, 256
    gen = torch.Generator(device=cuda).manual_seed(pad + off)
    rows = _randn(gen, M, n * d_in + pad, device=cuda, dtype=torch.bfloat16)
    x = rows[:, off:off + n * d_in]
    x1 = x.as_strided((M, n, d_in), (x.stride(0), d_in, 1))
    x2 = x.as_strided((M, n, d_in), (x.stride(0), 1, n))
    ws = _ff_case(cuda, M, n, d_in, d_ff, d_out, torch.bfloat16, "swiglu",
                  wdtype=torch.float32)[2:]
    before = dyad_mm.dyad_ff_fused.launches
    z1, z2 = dyad_mm.dyad_ff_fused(x1, x2, *ws, act="swiglu")
    torch.cuda.synchronize()
    assert dyad_mm.dyad_ff_fused.launches == before + 1
    p1, p2 = dyad_mm.dyad_ff_fused_plain(x1, x2, *ws, act="swiglu")
    _close(z1, p1, torch.bfloat16)
    _close(z2, p2, torch.bfloat16)


@pytest.mark.gpu
def test_qwen3_train_step_on_the_card_runs_the_kernels(cuda, monkeypatch):
    """One Qwen3 smoke train step with the megakernel on the card: every
    kernel of the path launches the expected number of times, and the
    kernel backward equals the plain one forced with REPRO_KERNEL_BWD=xla
    on the same params and batch."""
    from repro_torch import configs, tree
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamW, schedule
    from repro_torch.train import step as step_lib

    cfg = configs.get("qwen3_0_6b", smoke=True,
                      linear=configs.linear_cfg("dyad_it_4_kernel_ffused"))
    opt = AdamW(lr=schedule.constant(1e-3))
    batch = SyntheticLM(cfg.vocab_size, 64, 4, device="cuda").batch(0)
    grads = {}
    for route in ("pallas", "xla"):
        monkeypatch.setenv("REPRO_KERNEL_BWD", route)
        state = step_lib.init_train_state(
            cfg, opt, torch.Generator(device=cuda).manual_seed(0), device=cuda)
        for w in WRAPPERS:
            w.launches = 0
        metrics, grads[route] = step_lib.loss_and_grads(
            cfg, state["params"], batch)
        torch.cuda.synchronize()
        launches = [w.launches for w in WRAPPERS]
        n = cfg.n_layers
        # blocks, dgrad_two, wgrad, prefill, prefill_grads, decode,
        # blocks_two, dgrad, ff_fused
        want = ([2 * n, 2 * n, 3 * n, n, n, 0, 0, n, n] if route == "pallas"
                else [0, 0, 0, n, 0, 0, 0, 0, n])
        assert launches == want, (route, launches)
        assert bool(torch.isfinite(metrics["loss"]))
    for a, b in zip(tree.leaves(grads["pallas"]), tree.leaves(grads["xla"])):
        _close(a, b, torch.float32)


# -- flash_decode_paged (fp pools) and its int8-pool variant -----------------


def _paged_inputs(device, seed, B, K, G, h, P, NB, idxs, q_dtype,
                  pool_dtype):
    """Random q and pools with per-slot block tables drawn as a permutation
    of the non-scratch pages (two spare pages, so the tables are not the
    identity layout).  int8 pools are quantized fp32 pools with their
    per-row scales."""
    from repro_torch import quant

    gen = torch.Generator(device=device).manual_seed(seed)
    NP = 1 + B * NB + 2
    q = _randn(gen, B, K, G, h, device=device, dtype=q_dtype)
    pk = _randn(gen, NP, P, K, h, device=device)
    pv = _randn(gen, NP, P, K, h, device=device)
    perm = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(
        seed))[:B * NB] + 1
    bt = perm.reshape(B, NB).to(torch.int32).to(device)
    idx = torch.tensor(idxs, dtype=torch.int32, device=device)
    scales = {}
    if pool_dtype == torch.int8:
        pk, sk = quant.quantize_kv_rows(pk)
        pv, sv = quant.quantize_kv_rows(pv)
        scales = {"scales_k": sk, "scales_v": sv}
    else:
        pk, pv = pk.to(pool_dtype), pv.to(pool_dtype)
    return q, pk, pv, bt, idx, scales


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,G,h,P,NB,idxs,l_real,window", [
    # Qwen3's decode shape: 8 slots, contexts 1 to 512
    (8, 8, 2, 128, 16, 32, [0, 15, 16, 100, 255, 300, 480, 511], None,
     None),
    (3, 2, 2, 64, 8, 5, [5, 36, 20], 37, None),      # P does not divide
    (1, 2, 2, 64, 4, 3, [11], 12, 5),                 # sliding window
    (2, 2, 4, 64, 16, 1, [0, 7], None, None),         # one page; idx = 0
    (2, 1, 1, 128, 16, 4, [63, 17], None, None),      # G = 1
    # head dims padded to the instantiated 32, 64 and 128: the smoke
    # configs' 16, 32, 80, and an odd one that loads element by element
    (2, 2, 2, 16, 16, 3, [0, 40], None, None),
    (2, 2, 2, 32, 8, 4, [31, 5], None, None),
    (3, 2, 2, 80, 16, 4, [63, 10, 33], None, 20),
    (1, 2, 2, 33, 8, 3, [20], None, None),
])
def test_flash_decode_paged_kernel_matches_plain(cuda, B, K, G, h, P, NB,
                                                 idxs, l_real, window,
                                                 q_dtype, pool_dtype):
    q, pk, pv, bt, idx, scales = _paged_inputs(
        cuda, B + P + NB, B, K, G, h, P, NB, idxs, q_dtype, pool_dtype)
    kw = dict(l_real=l_real, window=window, **scales)
    counted = (flash_attn.flash_decode_paged_int8 if scales
               else flash_attn.flash_decode_paged)
    other = (flash_attn.flash_decode_paged if scales
             else flash_attn.flash_decode_paged_int8)
    before, before_other = counted.launches, other.launches
    got = flash_attn.flash_decode_paged(q[:, None], pk, pv, bt, idx, **kw)
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    assert other.launches == before_other
    assert got.shape == (B, 1, K, G, h) and got.dtype == q_dtype
    want = flash_attn.flash_decode_paged_plain(q[:, None], pk, pv, bt, idx,
                                               **kw)
    # fp32 bound only where nothing is bf16: a bf16 q makes a bf16 output,
    # and the plain version rounds p to a bf16 pool's dtype for P.V
    exact = q_dtype == torch.float32 and pool_dtype != torch.bfloat16
    _close(got, want, torch.float32 if exact else torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8])
def test_flash_decode_paged_scratch_poison_is_isolated(cuda, pool_dtype):
    """Scratch page 0, every unreferenced page and the live pages past
    each slot's write index hold huge values: the output does not move
    by one bit, since rows past idx are never read."""
    B, K, G, h, P, NB = 3, 8, 2, 128, 16, 6
    idxs = [2, 40, 95]
    q, pk, pv, bt, idx, scales = _paged_inputs(
        cuda, 7, B, K, G, h, P, NB, idxs, torch.bfloat16, pool_dtype)
    want = flash_attn.flash_decode_paged(q, pk, pv, bt, idx, **scales)
    live = set(bt.flatten().tolist())
    dead = [p for p in range(pk.shape[0]) if p not in live]
    for b, i in enumerate(idxs):
        dead += bt[b, i // P + 1:].tolist()
    assert 0 in dead
    big = 127 if pool_dtype == torch.int8 else 1e30
    for t in (pk, pv):
        t[dead] = big
    for s in scales.values():
        s[dead] = 1e30
    got = flash_attn.flash_decode_paged(q, pk, pv, bt, idx, **scales)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got.float()).all())


def _split_case(case, span):
    """(NB, idxs, l_real, window) of a split-edge case at 16-row pages:
    NB * P = 4 spans + 16 keys, so the last split is a partial one."""
    NB = span // 4 + 1
    last = NB * 16 - 1
    return NB, {
        # a split's last key, the next split's first, the last key of NB * P
        "edges": ([span - 1, span, last, 2 * span - 1, 2 * span, 0], None,
                  None),
        # the window empties the leading splits of each slot
        "window_leading": ([last, 3 * span + 5, 2 * span], None, span + 7),
        # one slot in a single split beside one in every split
        "one_and_every": ([5, last], None, None),
        # l_real cuts the last split short of NB * P
        "l_real": ([last, span, 3 * span + 6], 3 * span + 7, None),
    }[case]


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["edges", "window_leading",
                                  "one_and_every", "l_real"])
def test_flash_decode_paged_split_edges_match_plain(cuda, case, q_dtype,
                                                    pool_dtype):
    """The kernel splits each slot's keys into blocks of PAGED_SPAN keys
    and merges them in the launch: every edge of that split matches the
    plain version at the tolerances above."""
    span = flash_attn.PAGED_SPAN[pool_dtype]
    NB, (idxs, l_real, window) = _split_case(case, span)
    q, pk, pv, bt, idx, scales = _paged_inputs(
        cuda, 13, len(idxs), 8, 2, 128, 16, NB, idxs, q_dtype, pool_dtype)
    kw = dict(l_real=l_real, window=window, **scales)
    got = flash_attn.flash_decode_paged(q, pk, pv, bt, idx, **kw)
    torch.cuda.synchronize()
    want = flash_attn.flash_decode_paged_plain(q, pk, pv, bt, idx, **kw)
    exact = q_dtype == torch.float32 and pool_dtype != torch.bfloat16
    _close(got, want, torch.float32 if exact else torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8])
def test_flash_decode_paged_slot_bits_do_not_depend_on_the_batch(
        cuda, pool_dtype):
    """Each slot of a batch of 8 (one split to every split of a 512-key
    table) gives the same bits alone as in the batch."""
    span = flash_attn.PAGED_SPAN[pool_dtype]
    idxs = [0, span - 1, span, 2 * span + 3, 200, 300, 480, 511]
    q, pk, pv, bt, idx, scales = _paged_inputs(
        cuda, 11, 8, 8, 2, 128, 16, 32, idxs, torch.bfloat16, pool_dtype)
    batch = flash_attn.flash_decode_paged(q, pk, pv, bt, idx, **scales)
    for i in range(len(idxs)):
        alone = flash_attn.flash_decode_paged(
            q[i:i + 1], pk, pv, bt[i:i + 1], idx[i:i + 1], **scales)
        assert torch.equal(alone, batch[i:i + 1]), i


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8])
def test_flash_decode_paged_repeats_bitwise(cuda, pool_dtype):
    """Two calls give the same bits, also with another launch between
    them: the block that merges a slot's splits resets its counter."""
    idxs = [511, 130, 64, 300]
    q, pk, pv, bt, idx, scales = _paged_inputs(
        cuda, 17, 4, 8, 2, 128, 16, 32, idxs, torch.bfloat16, pool_dtype)
    first = flash_attn.flash_decode_paged(q, pk, pv, bt, idx, **scales)
    flash_attn.flash_decode_paged(q, pk, pv, bt, idx.flip(0), window=100,
                                  **scales)
    again = flash_attn.flash_decode_paged(q, pk, pv, bt, idx, **scales)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert int(flash_attn._paged_counters[q.device].abs().sum()) == 0


@pytest.mark.gpu
def test_flash_decode_paged_entry_refuses_a_short_workspace(cuda,
                                                            monkeypatch):
    """The C entry works out the grid's splits itself and refuses a
    workspace sized for fewer (cudaErrorInvalidValue, 1) instead of
    writing past it."""
    q, pk, pv, bt, idx, _ = _paged_inputs(
        cuda, 5, 2, 8, 2, 128, 16, 32, [511, 300], torch.bfloat16,
        torch.float32)
    monkeypatch.setattr(flash_attn, "paged_splits", lambda *a: 2)
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        flash_attn.flash_decode_paged(q, pk, pv, bt, idx)


@pytest.mark.gpu
def test_flash_decode_paged_wrapper_raises(cuda):
    q, pk, pv, bt, idx, scales = _paged_inputs(
        cuda, 3, 2, 2, 2, 64, 4, 2, [1, 5], torch.float32, torch.int8)
    with pytest.raises(ValueError, match="together"):
        flash_attn.flash_decode_paged(q, pk, pv, bt, idx,
                                      scales_k=scales["scales_k"])
    with pytest.raises(TypeError):
        flash_attn.flash_decode_paged(q, pk, pv, bt, idx)    # int8, no scales
    # any head dim up to 128 runs; past it the wrapper names the limit
    q, pk, pv, bt, idx, _ = _paged_inputs(
        cuda, 3, 2, 2, 2, 160, 4, 2, [1, 5], torch.float32, torch.float32)
    with pytest.raises(NotImplementedError, match="head dim"):
        flash_attn.flash_decode_paged(q, pk, pv, bt, idx)
    q, pk, pv, bt, idx, _ = _paged_inputs(
        cuda, 3, 2, 2, 2, 16, 4, 2, [1, 5], torch.float32, torch.float32)
    with pytest.raises(ValueError):
        flash_attn.flash_decode_paged(q, pk.cpu(), pv.cpu(), bt, idx)


@pytest.mark.gpu
@pytest.mark.parametrize("quant_kv", [None, "int8"])
def test_smoke_paged_serve_runs_the_kernel(cuda, capsys, quant_kv):
    """The launcher's paged smoke serve (head dim 16) on the card: every
    decode step goes through the paged decode kernel, no request faults
    and no rung of the ladder is taken."""
    from repro_torch.launch import serve

    counted = (flash_attn.flash_decode_paged_int8 if quant_kv
               else flash_attn.flash_decode_paged)
    before = counted.launches
    serve.main(["--arch", "qwen3_0_6b", "--smoke", "--engine", "continuous",
                "--page-size", "16", "--device", "cuda"]
               + (["--quant-kv", quant_kv] if quant_kv else []))
    torch.cuda.synchronize()
    out = capsys.readouterr().out
    assert counted.launches > before
    assert "[serve] paged:" in out and "demoted=[]" in out


def test_cpu_paged_decode_takes_the_plain_version():
    q, pk, pv, bt, idx, scales = _paged_inputs(
        torch.device("cpu"), 5, 2, 2, 2, 16, 4, 3, [3, 9], torch.float32,
        torch.int8)
    counts = (flash_attn.flash_decode_paged.launches,
              flash_attn.flash_decode_paged_int8.launches)
    got = ops.flash_decode_paged(q, pk, pv, bt, idx, **scales)
    want = flash_attn.flash_decode_paged_plain(q, pk, pv, bt, idx, **scales)
    assert torch.equal(got, want)
    assert torch.equal(flash_attn.flash_decode_paged_int8(
        q, pk, pv, scales["scales_k"], scales["scales_v"], bt, idx), want)
    assert counts == (flash_attn.flash_decode_paged.launches,
                      flash_attn.flash_decode_paged_int8.launches)


# -- the quantized-weight kernels ------------------------------------------

Q_WRAPPERS = (dyad_mm.dyad_mm_blocks_q, dyad_mm.dyad_mm_blocks_two_q,
              dyad_mm.dyad_ff_fused_q)
PAYLOADS = ["int8", "fp8"]


def _qweight(gen, shape, qdtype, device, scale=1.0):
    """(payload, scales) of a weight at the init scale, times ``scale``."""
    from repro_torch import quant

    w = _randn(gen, *shape, device=device) * (scale / shape[-1] ** 0.5)
    return quant.quantize_dyad_weight(w, qdtype)


def _mm_q_case(device, M, n, d_in, d_out, dtype, qdtype, view):
    gen = torch.Generator(device=device).manual_seed(M + d_in + d_out)
    x = _randn(gen, M, n * d_in, device=device, dtype=dtype)
    x1 = x.reshape(M, n, d_in)
    x2 = x.reshape(M, d_in, n).transpose(1, 2) if view == "it" else x1
    (q1, s1), (q2, s2) = (_qweight(gen, (n, d_out, d_in), qdtype, device)
                          for _ in range(2))
    return x1, x2, q1, q2, s1, s2


def test_cpu_quant_tensors_take_the_plain_versions():
    cpu = torch.device("cpu")
    counts = [w.launches for w in Q_WRAPPERS]
    for qdtype in PAYLOADS:
        args = _mm_q_case(cpu, 5, 2, 12, 8, torch.float32, qdtype, "it")
        assert torch.equal(dyad_mm.dyad_mm_blocks_q(*args),
                           dyad_mm.dyad_mm_blocks_q_plain(*args))
        got = dyad_mm.dyad_mm_blocks_two_q(*args)
        want = dyad_mm.dyad_mm_blocks_two_q_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        x1, x2, q1, q2, s1, s2 = args
        qd, sd = _qweight(torch.Generator().manual_seed(1), (2, 3, 8),
                          qdtype, cpu)
        got = dyad_mm.dyad_ff_fused_q(x1, x2, q1, q2, qd, qd, s1, s2, sd, sd)
        want = dyad_mm.dyad_ff_fused_q_plain(x1, x2, q1, q2, qd, qd, s1, s2,
                                             sd, sd)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts == [w.launches for w in Q_WRAPPERS]


# (M, n, d_in_b, d_out_b): OPT-125m's up and down at decode and prefill
# rows, Qwen3-0.6B's up, then ragged edges (odd rows, dims off the tile
# and off a multiple of 4), then Qwen3's split-route down at decode and
# prefill-chunk rows and its up at prefill-chunk rows, then decode rows
# too wide for the decode kernel's shared memory
Q_MM_SHAPES = [(8, 4, 192, 768), (1024, 4, 768, 192), (8, 4, 256, 768),
               (77, 3, 129, 67), (5, 2, 70, 131), (8, 4, 768, 256),
               (128, 4, 768, 256), (128, 4, 256, 768), (8, 2, 3300, 70)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qdtype", PAYLOADS)
@pytest.mark.parametrize("M,n,d_in,d_out", Q_MM_SHAPES)
def test_dyad_mm_q_kernels_match_plain(cuda, M, n, d_in, d_out, qdtype,
                                       dtype):
    # both dtypes take the tensor cores but at decode rows whose x views
    # fit the decode kernel's shared memory: fp32 x always stays on the
    # FMA decode kernel there, bf16 x where that kernel fills two waves
    # (Qwen3's and OPT's up at M 8)
    sms = dyad_mm.sm_count(cuda)
    kernel = dyad_mm.mm_q_plan(M, n, d_in, d_out, sms, dtype)[0]
    fma = M <= 8 and 8 * M * d_in <= 200 * 1024 and (
        dtype == torch.float32 or n * -(-d_out // 8) >= 2 * sms)
    assert kernel == ("fma" if fma else "tc")
    for view in ("it", "ot"):
        args = _mm_q_case(cuda, M, n, d_in, d_out, dtype, qdtype, view)
        before = [w.launches for w in Q_WRAPPERS]
        out = dyad_mm.dyad_mm_blocks_q(*args)
        z1, z2 = dyad_mm.dyad_mm_blocks_two_q(*args)
        torch.cuda.synchronize()
        assert [w.launches for w in Q_WRAPPERS] == [before[0] + 1,
                                                   before[1] + 1, before[2]]
        assert out.dtype == dtype and out.shape == (M, n, d_out)
        _close(out, dyad_mm.dyad_mm_blocks_q_plain(*args), dtype)
        p1, p2 = dyad_mm.dyad_mm_blocks_two_q_plain(*args)
        _close(z1, p1, dtype)
        _close(z2, p2, dtype)
        # the split partials add in a fixed order: the same bits again
        assert torch.equal(dyad_mm.dyad_mm_blocks_q(*args), out)
        again = dyad_mm.dyad_mm_blocks_two_q(*args)
        assert torch.equal(again[0], z1) and torch.equal(again[1], z2)


def _exact_payload(shape, qdtype, device, salt=0):
    """A payload of ``shape`` (n, rows, k) covering every int8 value (each
    row the 256 values along k) or every finite e4m3 value (each row one
    binade, exponent e = (row + block + salt) % 16, every mantissa and
    sign along k; e 15's NaN code replaced by 448's), and e."""
    n, rows, k = shape
    g = torch.arange(n, device=device)[:, None, None]
    r = torch.arange(rows, device=device)[None, :, None]
    kk = torch.arange(k, device=device)[None, None, :]
    if qdtype == "int8":
        q = ((kk + 7 * r + 13 * g + salt) % 256 - 128).to(torch.int8)
        return q, None
    e = (r + g + salt) % 16
    m = kk % 8
    m = torch.where((e == 15) & (m == 7), torch.full_like(m, 6), m)
    byte = ((kk // 8) % 2) << 7 | (e << 3) | m
    return byte.to(torch.uint8).view(torch.float8_e4m3fn), e[..., 0]


def _pow2_scales(n, rows, c, device):
    """Scales 2^0 .. 2^-3, by (row + block + c) % 4."""
    o = torch.arange(rows, device=device)[None, :]
    g = torch.arange(n, device=device)[:, None]
    return torch.exp2(-((o + g + c) % 4).float()).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", PAYLOADS)
@pytest.mark.parametrize("M,n,d_in,d_out,dtype", [
    (8, 4, 768, 256, torch.bfloat16), (128, 4, 768, 256, torch.bfloat16),
    (128, 4, 256, 768, torch.bfloat16), (128, 4, 768, 256, torch.float32),
    (1024, 4, 192, 768, torch.float32), (1024, 4, 768, 192, torch.float32)])
def test_dyad_mm_q_bf16_exact_payloads_match_bitwise(cuda, M, n, d_in,
                                                     d_out, dtype, qdtype):
    """Payloads covering every int8 or finite e4m3 value, power-of-two
    scales and x in [-2, 2] (bf16 x, or fp32 x, whose tf32 hi is x and lo
    0): each component's sum stays below 2^24 of its row's quantum (int8
    768 x 2 x 128; fp8 one binade a row, 768 x 2 x 16) and the scales
    within 8x, so the tensor-core route (its k split and second pass
    included) gives the plain version's bits, at Qwen3's split-route
    shapes and OPT-125m's quantized prefill rows."""
    gen = torch.Generator(device=cuda).manual_seed(M + d_in)
    x = _randint(gen, M, n * d_in, device=cuda, dtype=dtype)
    x1 = x.reshape(M, n, d_in)
    q1 = _exact_payload((n, d_out, d_in), qdtype, cuda)[0]
    q2 = (_exact_payload((n, d_out, d_in), qdtype, cuda, 5)[0]
          if qdtype == "int8" else q1.view(torch.uint8).flip(-1)
          .contiguous().view(torch.float8_e4m3fn))
    s1, s2 = (_pow2_scales(n, d_out, c, cuda) for c in (0, 1))
    assert dyad_mm.mm_q_plan(M, n, d_in, d_out, dyad_mm.sm_count(cuda),
                             dtype)[0] == "tc"
    for x2 in (x.reshape(M, d_in, n).transpose(1, 2), x1):
        args = (x1, x2, q1, q2, s1, s2)
        assert torch.equal(dyad_mm.dyad_mm_blocks_q(*args),
                           dyad_mm.dyad_mm_blocks_q_plain(*args))
        got = dyad_mm.dyad_mm_blocks_two_q(*args)
        want = dyad_mm.dyad_mm_blocks_two_q_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qdtype", PAYLOADS)
@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "swiglu"])
@pytest.mark.parametrize("M,n,d_in,d_ff,d_out", FF_SHAPES[1:])
def test_dyad_ff_fused_q_kernel_matches_plain(cuda, M, n, d_in, d_ff, d_out,
                                              act, qdtype, dtype):
    gen = torch.Generator(device=cuda).manual_seed(M + d_ff)
    x = _randn(gen, M, n * d_in, device=cuda, dtype=dtype)
    x1, x2 = x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2)
    ups = [_qweight(gen, (n, d_ff, d_in), qdtype, cuda, 4.0)
           for _ in range(4 if act == "swiglu" else 2)]
    downs = [_qweight(gen, (n, d_out, d_ff), qdtype, cuda) for _ in range(2)]
    gate = (dict(wg1=ups[2][0], wg2=ups[3][0], sg1=ups[2][1], sg2=ups[3][1])
            if act == "swiglu" else {})
    args = (x1, x2, ups[0][0], ups[1][0], downs[0][0], downs[1][0],
            ups[0][1], ups[1][1], downs[0][1], downs[1][1])
    # bf16 up to d_in_b 256 takes the tensor-core kernel, the rest FMA
    kernel = dyad_mm.ff_q_plan(M, n, d_in, d_ff, d_out,
                               dyad_mm.sm_count(cuda), dtype)[0]
    assert kernel == ("tc" if dtype == torch.bfloat16 and d_in <= 256
                      else "fma")
    before = dyad_mm.dyad_ff_fused_q.launches
    z1, z2 = dyad_mm.dyad_ff_fused_q(*args, act=act, **gate)
    torch.cuda.synchronize()
    assert dyad_mm.dyad_ff_fused_q.launches == before + 1
    p1, p2 = dyad_mm.dyad_ff_fused_q_plain(*args, act=act, **gate)
    assert z1.dtype == dtype and z2.shape == (M, n, d_out)
    _close(z1, p1, dtype)
    _close(z2, p2, dtype)
    # the hidden split adds its partials in a fixed order: same bits again
    again = dyad_mm.dyad_ff_fused_q(*args, act=act, **gate)
    assert torch.equal(again[0], z1) and torch.equal(again[1], z2)


def _ff_q_exact_case(cuda, M, qdtype):
    """Qwen3's ff widths with relu: each row of x one +-1, placed so that
    one component at most feeds each block's up sum; payloads covering
    every int8 or finite e4m3 value; up scales that make each hidden value
    a multiple of 2^-7 (int8) or 1/16 (fp8) below 1, exact in bf16; down
    sums below 768 x 128 (int8) or 768 x 2^8 (fp8) of their quantum."""
    n, d_in, d_ff, d_out = 4, 256, 768, 256
    m = torch.arange(M, device=cuda)
    b = m % n
    k = (m * 37 + 1) % d_in
    k = torch.where(k % n == b, (k + 1) % d_in, k)
    x = torch.zeros(M, n * d_in, device=cuda)
    x[m, b * d_in + k] = torch.where((m // 3) % 2 == 0, 1.0, -1.0)
    x = x.to(torch.bfloat16)
    ups, su = [], []
    for c in range(2):
        q, e = _exact_payload((n, d_ff, d_in), qdtype, cuda, 3 * c)
        ups.append(q)
        su.append(torch.full((n, d_ff), 2.0 ** -7, device=cuda)
                  if e is None else
                  torch.exp2(torch.where(e > 0, 6 - e, 5).float()))
    downs = [_exact_payload((n, d_out, d_ff), qdtype, cuda, c)[0]
             for c in range(2)]
    return (x.reshape(M, n, d_in), x.reshape(M, d_in, n).transpose(1, 2),
            ups[0], ups[1], downs[0], downs[1], su[0], su[1],
            _pow2_scales(n, d_out, 0, cuda), _pow2_scales(n, d_out, 1, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", PAYLOADS)
@pytest.mark.parametrize("M", [128, 1024])
def test_dyad_ff_fused_q_bf16_exact_payloads_match_bitwise(cuda, M, qdtype):
    """The tensor-core megakernel over payloads covering every int8 or
    finite e4m3 value (split into the serving rows' 12 ranges at M 128,
    unsplit at 1024), on sums that are exact: the plain version's bits."""
    assert dyad_mm.ff_q_plan(M, 4, 256, 768, 256, dyad_mm.sm_count(cuda),
                             torch.bfloat16)[0] == "tc"
    args = _ff_q_exact_case(cuda, M, qdtype)
    before = dyad_mm.dyad_ff_fused_q.launches
    got = dyad_mm.dyad_ff_fused_q(*args, act="relu")
    torch.cuda.synchronize()
    assert dyad_mm.dyad_ff_fused_q.launches == before + 1
    want = dyad_mm.dyad_ff_fused_q_plain(*args, act="relu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _ff_q_case(cuda, x1, x2, qdtype, act, seed):
    """dyad_ff_fused_q's weights at Qwen3's widths for views x1, x2."""
    n, d_in, d_ff, d_out = 4, 256, 768, 256
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ups = [_qweight(gen, (n, d_ff, d_in), qdtype, cuda, 4.0)
           for _ in range(4 if act == "swiglu" else 2)]
    downs = [_qweight(gen, (n, d_out, d_ff), qdtype, cuda) for _ in range(2)]
    gate = (dict(wg1=ups[2][0], wg2=ups[3][0], sg1=ups[2][1], sg2=ups[3][1])
            if act == "swiglu" else {})
    return (x1, x2, ups[0][0], ups[1][0], downs[0][0], downs[1][0],
            ups[0][1], ups[1][1], downs[0][1], downs[1][1]), gate


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", PAYLOADS)
def test_dyad_ff_fused_q_bf16_rows_keep_their_bits_at_every_serving_M(
        cuda, qdtype):
    """At Qwen3's quantized serving rows (up to 128: decode steps, prefill
    chunks) the tensor-core kernel splits the hidden into the same
    one-tile ranges, so a row's result has the same bits among 8, 64 or
    128 rows."""
    n, d_in = 4, 256
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _randn(gen, 128, n * d_in, device=cuda, dtype=torch.bfloat16)
    outs = []
    for M in (8, 64, 128):
        assert dyad_mm.ff_q_plan(M, n, d_in, 768, 256, dyad_mm.sm_count(cuda),
                                 torch.bfloat16) == ("tc", 12, 64)
        xm = x[:M]
        args, gate = _ff_q_case(cuda, xm.reshape(M, n, d_in),
                                xm.reshape(M, d_in, n).transpose(1, 2),
                                qdtype, "swiglu", 3)
        z1, z2 = dyad_mm.dyad_ff_fused_q(*args, act="swiglu", **gate)
        outs.append((z1[:8], z2[:8]))
    torch.cuda.synchronize()
    for z1, z2 in outs[1:]:
        assert torch.equal(z1, outs[0][0]) and torch.equal(z2, outs[0][1])


@pytest.mark.gpu
@pytest.mark.parametrize("pad,off", [(16, 0), (3, 0), (8, 1)])
def test_dyad_ff_fused_q_bf16_reads_strided_views(cuda, pad, off):
    """x1 and x2 as views into a wider buffer (rows of n * d_in + pad from
    column off: copied and gathered in 16-byte runs, or element by
    element), at Qwen3's widths on the tensor-core kernel, int8."""
    M, n, d_in = 128, 4, 256
    gen = torch.Generator(device=cuda).manual_seed(pad + off)
    rows = _randn(gen, M, n * d_in + pad, device=cuda, dtype=torch.bfloat16)
    x = rows[:, off:off + n * d_in]
    x1 = x.as_strided((M, n, d_in), (x.stride(0), d_in, 1))
    x2 = x.as_strided((M, n, d_in), (x.stride(0), 1, n))
    args, gate = _ff_q_case(cuda, x1, x2, "int8", "swiglu", pad)
    z1, z2 = dyad_mm.dyad_ff_fused_q(*args, act="swiglu", **gate)
    p1, p2 = dyad_mm.dyad_ff_fused_q_plain(*args, act="swiglu", **gate)
    _close(z1, p1, torch.bfloat16)
    _close(z2, p2, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("pad,off", [(16, 0), (3, 0)])
def test_dyad_mm_q_bf16_reads_strided_views(cuda, pad, off):
    """The tensor-core quantized GEMM on x views into a wider buffer, at
    Qwen3's split-route down (M 128), fp8."""
    M, n, d_in, d_out = 128, 4, 768, 256
    gen = torch.Generator(device=cuda).manual_seed(pad)
    rows = _randn(gen, M, n * d_in + pad, device=cuda, dtype=torch.bfloat16)
    x = rows[:, off:off + n * d_in]
    x1 = x.as_strided((M, n, d_in), (x.stride(0), d_in, 1))
    x2 = x.as_strided((M, n, d_in), (x.stride(0), 1, n))
    (q1, s1), (q2, s2) = (_qweight(gen, (n, d_out, d_in), "fp8", cuda)
                          for _ in range(2))
    args = (x1, x2, q1, q2, s1, s2)
    _close(dyad_mm.dyad_mm_blocks_q(*args),
           dyad_mm.dyad_mm_blocks_q_plain(*args), torch.bfloat16)
    got = dyad_mm.dyad_mm_blocks_two_q(*args)
    want = dyad_mm.dyad_mm_blocks_two_q_plain(*args)
    _close(got[0], want[0], torch.bfloat16)
    _close(got[1], want[1], torch.bfloat16)


@pytest.mark.gpu
def test_quant_wrappers_raise_on_the_card(cuda):
    args = list(_mm_q_case(cuda, 8, 2, 16, 8, torch.float32, "int8", "it"))
    bad = list(args)
    bad[2] = args[2].float()
    with pytest.raises(TypeError, match="payload"):
        dyad_mm.dyad_mm_blocks_q(*bad)
    bad = list(args)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError, match="one device"):
        dyad_mm.dyad_mm_blocks_two_q(*bad)
    bad = list(args)
    bad[3] = args[3].view(torch.float8_e4m3fn)
    with pytest.raises(ValueError):
        dyad_mm.dyad_mm_blocks_q(*bad)
