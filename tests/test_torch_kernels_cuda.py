"""The port's CUDA kernels against their plain versions, and the wrappers'
routing.  Imports torch and the port only, so it also runs on a machine
without JAX.

Tests marked ``gpu`` need a CUDA card and skip without one; run them on
the card with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_kernels_cuda.py``.  The others check, on the CPU, that a
CPU tensor takes the plain version and leaves the launch counter alone.

Tolerance: 2e-5 (fp32) and 2e-2 (bf16) times max(|plain|, 1)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dyad_mm, flash_attn, ops  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
    (3, 3, 7, 5, "it"), (5, 2, 129, 130, "dt"), (1, 4, 768, 192, "ot")])
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,K,G,h,causal,window,q_off,k_off", [
    (8, 128, 160, 12, 1, 64, True, None, 0, 0),
    (3, 20, 28, 2, 2, 16, True, 9, [0, 4, 30], [0, 2, 40]),
    (2, 37, 37, 1, 4, 128, False, None, 0, 0),
    (1, 8, 16, 2, 2, 16, True, None, 0, 20),         # all rows masked
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
    o, lse = flash_attn.flash_prefill(q, k, v, q_off, k_off, **kw)
    po, plse = flash_attn.flash_prefill_plain(q, k, v, q_off, k_off, **kw)
    torch.cuda.synchronize()
    _close(o, po, dtype)
    live = plse > -1e29
    if live.any():
        _close(lse[live], plse[live], dtype)
    assert bool((lse[~live] <= -1e29).all())
    assert bool((o[(~live).reshape(B, K, S, G).permute(0, 2, 1, 3)]
                 == 0).all())


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
    # (M, n, d_in, d_out): the OPT-125m training up/down, then ragged
    (4096, 4, 192, 768), (4096, 4, 768, 192), (129, 2, 13, 130),
    (7, 3, 5, 3), (100, 1, 64, 65)]


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
@pytest.mark.parametrize("M,n,d_in,d_out", DGRAD_SHAPES)
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
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("M,n,d_in,d_out", DGRAD_SHAPES)
def test_dyad_wgrad_kernel_matches_plain(cuda, M, n, d_in, d_out, dtype,
                                         out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(M + d_out)
    x = _randn(gen, M, n * d_in, device=cuda, dtype=dtype)
    g = _randn(gen, M, n * d_out, device=cuda, dtype=dtype)
    x1, x2, z = _it_views(x, g, n)
    before = dyad_mm.dyad_mm_wgrad.launches
    dw1, dw2 = dyad_mm.dyad_mm_wgrad(x1, x2, z, z, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert dyad_mm.dyad_mm_wgrad.launches == before + 1
    p1, p2 = dyad_mm.dyad_mm_wgrad_plain(x1, x2, z, z, out_dtype=out_dtype)
    assert dw1.dtype == out_dtype and dw2.shape == (n, d_out, d_in)
    _close(dw1, p1, dtype)
    _close(dw2, p2, dtype)
    # the split row reduction is fixed: a second call is bitwise equal
    again = dyad_mm.dyad_mm_wgrad(x1, x2, z, z, out_dtype=out_dtype)
    assert torch.equal(again[0], dw1) and torch.equal(again[1], dw2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,K,G,h,causal,window,q_off,k_off", [
    (2, 512, 4, 1, 64, True, None, 0, 0),           # the training shape
    (3, 20, 2, 2, 16, True, 9, [0, 4, 30], [0, 2, 40]),
    (2, 37, 1, 4, 128, False, None, 0, 0),
    (1, 8, 2, 2, 16, True, None, 0, 20),            # all rows masked
    (2, 33, 3, 2, 32, True, 5, 3, 3),
])
def test_flash_prefill_grads_kernel_matches_plain(cuda, B, S, K, G, h, causal,
                                                  window, q_off, k_off,
                                                  dtype):
    gen = torch.Generator(device=cuda).manual_seed(S + h)
    T = S
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
    (129, 2, 13, 130), (7, 3, 5, 3)]


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,n,d_in,d_out", [
    # Qwen3-0.6B's down dh at the training rows; OPT-125m's OT dx
    (4096, 4, 768, 256), (4096, 4, 192, 768), (129, 2, 13, 130),
    (7, 3, 5, 3)])
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
    # (M, n, d_in_b, d_ff_b, d_out_b): Qwen3-0.6B at the training, prefill
    # and decode rows, then ragged edges and an output wider than a tile
    (4096, 4, 256, 768, 256), (1024, 4, 256, 768, 256),
    (8, 4, 256, 768, 256), (3, 2, 129, 130, 17), (45, 3, 33, 200, 300)]


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
    """bf16 activations with the fp32 params: the same bits as casting
    the weights to bf16 before the call."""
    args = _ff_case(cuda, M, 4, 256, 768, 256, torch.bfloat16, "swiglu",
                    wdtype=torch.float32)
    got = dyad_mm.dyad_ff_fused(*args, act="swiglu")
    cast = [a if a is None or i < 2 else a.bfloat16()
            for i, a in enumerate(args)]
    want = dyad_mm.dyad_ff_fused(*cast, act="swiglu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
