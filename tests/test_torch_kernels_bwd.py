"""Port parity for the backward: the plain versions of ``dyad_mm_dgrad_two``,
``dyad_mm_wgrad`` and ``flash_prefill_grads`` against the JAX Pallas
kernels in interpret mode (as ``tests/test_kernels.py`` and
``tests/test_flash_attn.py`` run them), and the gradients of
``ops.dyad_mm`` / ``ops.flash_attention`` on each backward route against
``jax.grad`` of the reference ops.  Inputs come from numpy with a seed;
fp32 on the CPU, where every wrapper takes its plain version.

Tolerance: 1e-5 x max(|reference|, 1) x max(1, sqrt(L / 128)) for a
contraction of length L: the sums run in another order than the tiled
Pallas kernels (ROADMAP C.1 measured 4e-7 relative at L = 129), and the
rounding error of a sum grows with the square root of its length.
``torch.autograd.gradcheck`` runs in float64 with its own defaults."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attn as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.dyad_mm import dyad_mm_dgrad_two as j_dgrad_two  # noqa: E402
from repro.kernels.dyad_mm import dyad_mm_wgrad as j_wgrad  # noqa: E402
from repro_torch.kernels import dyad_mm, flash_attn, ops  # noqa: E402


def _close(got, want, L=1):
    tol = 1e-5 * max(1.0, math.sqrt(L / 128))
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- dgrad_two / wgrad ------------------------------------------------------------

BWD_SHAPES = [
    # (M, n, d_in, d_out): ragged and prime dims, past-lane dims
    (129, 2, 13, 17),
    (8, 4, 16, 32),
    (13, 3, 7, 5),
    (64, 2, 129, 130),
]


@pytest.mark.parametrize("M,n,d_in,d_out", BWD_SHAPES)
def test_dgrad_two_and_wgrad_plain_match_pallas(M, n, d_in, d_out):
    rng = np.random.default_rng(M + d_in + d_out)
    x1, x2 = (rng.standard_normal((M, n, d_in)).astype(np.float32)
              for _ in range(2))
    z1, z2 = (rng.standard_normal((M, n, d_out)).astype(np.float32)
              for _ in range(2))
    w1, w2 = (rng.standard_normal((n, d_out, d_in)).astype(np.float32)
              for _ in range(2))
    before = (dyad_mm.dyad_mm_dgrad_two.launches,
              dyad_mm.dyad_mm_wgrad.launches)
    got = dyad_mm.dyad_mm_dgrad_two(_t(z1), _t(z2), _t(w1), _t(w2))
    want = j_dgrad_two(*map(jnp.asarray, (z1, z2, w1, w2)), interpret=True)
    for a, b in zip(got, want):
        assert a.shape == (M, n, d_in)
        _close(a, b, d_out)
    got = dyad_mm.dyad_mm_wgrad(_t(x1), _t(x2), _t(z1), _t(z2))
    want = j_wgrad(*map(jnp.asarray, (x1, x2, z1, z2)), interpret=True)
    for a, b in zip(got, want):
        assert a.shape == (n, d_out, d_in)
        _close(a, b, M)
    # CPU tensors: the plain versions, no launch
    assert before == (dyad_mm.dyad_mm_dgrad_two.launches,
                      dyad_mm.dyad_mm_wgrad.launches)


def test_wgrad_plain_casts_once_to_out_dtype():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((64, 2, 32)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((64, 2, 32)).astype(np.float32))
    xb, zb = x.bfloat16(), z.bfloat16()
    dw1, _ = dyad_mm.dyad_mm_wgrad(xb, xb, zb, zb, out_dtype=torch.float32)
    assert dw1.dtype == torch.float32
    exact = torch.einsum("bgo,bgi->goi", zb.double(), xb.double())
    # only the bf16 input rounding remains: the sum ran in fp32
    assert float((dw1.double() - exact).abs().max()) < 1e-4


def test_wgrad_split_covers_the_rows():
    for M, n, d_in, d_out in [(4096, 4, 192, 768), (4096, 4, 768, 192),
                              (129, 2, 13, 17), (1, 1, 1, 1), (0, 2, 8, 8)]:
        split, rows = dyad_mm.wgrad_split(M, n, d_in, d_out)
        assert rows % 32 == 0 and split >= 1
        assert (split - 1) * rows < max(M, 1) <= split * rows
    # OPT-125m up/down on the split-TF32 kernel: 192 tiles of 64 x 96 on
    # 264 block slots, so the rows split four ways (3 waves of 32 stages)
    assert dyad_mm.wgrad_split(4096, 4, 192, 768) == (4, 1024)
    assert dyad_mm.wgrad_split(4096, 4, 768, 192) == (4, 1024)


def _tf32_tiles(n, d_in, d_out):
    a, b = ((d_in, d_out) if dyad_mm.wgrad_orient(d_in, d_out)
            else (d_out, d_in))
    return (2 * n * -(-a // dyad_mm._TF32_TILE_A)
            * -(-b // dyad_mm._TF32_TILE_B))


def _waves_x_stages(tiles, split, stages):
    """Waves of blocks on the card's slots x stages a block."""
    return -(-tiles * split // dyad_mm._TF32_SLOTS) * stages


@pytest.mark.parametrize("M,n,d_in,d_out", [
    (4096, 4, 192, 768), (4096, 4, 768, 192), (4096, 4, 256, 768),
    (4096, 4, 768, 256), (1024, 4, 192, 768), (2048, 1, 64, 65),
    (129, 2, 13, 130), (300, 3, 200, 130), (77, 3, 65, 130),
    (4096, 16, 768, 768), (1, 1, 1, 1), (0, 2, 8, 8)])
def test_wgrad_split_covers_the_rows_on_the_split_tf32_tiles(M, n, d_in,
                                                             d_out):
    """The fp32 plan: ranges that cover M in steps of the kernel's 32
    rows, no split where the tiles alone fill the card's two blocks an
    SM, at most _WGRAD_MAX_SPLIT ranges, and among those the split whose
    blocks fill whole waves best (the fewest waves x stages a block)."""
    split, rows = dyad_mm.wgrad_split(M, n, d_in, d_out)
    assert rows % dyad_mm._WGRAD_ROWS == 0 and split >= 1
    assert (split - 1) * rows < max(M, 1) <= split * rows
    assert split <= dyad_mm._WGRAD_MAX_SPLIT
    tiles = _tf32_tiles(n, d_in, d_out)
    if tiles >= dyad_mm._TF32_SLOTS:
        assert split == 1
        return
    chunks = max(1, -(-M // dyad_mm._WGRAD_ROWS))
    best = min(_waves_x_stages(tiles, s, -(-chunks // s))
               for s in range(1, min(chunks, dyad_mm._WGRAD_MAX_SPLIT) + 1))
    assert _waves_x_stages(tiles, split,
                           rows // dyad_mm._WGRAD_ROWS) == best


@pytest.mark.parametrize("d_in,d_out,x_strided,z_strided,x_as_a", [
    # OPT-125m's up and down: 3 x 8 or 12 x 2 tiles of 64 x 96 either way,
    # so the stride-n view decides (the IT x2, the OT z2bar), else the
    # narrower side
    (192, 768, True, False, True), (192, 768, False, True, False),
    (768, 192, True, False, True), (768, 192, False, True, False),
    (192, 768, False, False, True), (768, 192, False, False, False),
    # Qwen3-0.6B's up and down: 4 x 8 tiles against 12 x 3, whatever the
    # views
    (256, 768, False, True, True), (768, 256, True, False, False),
    (64, 64, False, False, True), (13, 130, False, True, True),
    (130, 13, True, False, False)])
def test_wgrad_orient_takes_the_fewer_tiles(d_in, d_out, x_strided,
                                            z_strided, x_as_a):
    assert dyad_mm.wgrad_orient(d_in, d_out, x_strided, z_strided) is x_as_a


def test_wgrad_split_covers_the_rows_on_the_tensor_core_tiles():
    tile_o, tile_i, step = (dyad_mm._TC_TILE_O, dyad_mm._TC_TILE_I,
                            dyad_mm._TC_ROWS)
    for M, n, d_in, d_out in [(4096, 4, 256, 768), (4096, 4, 768, 256),
                              (129, 2, 13, 130), (100, 1, 64, 65),
                              (1, 1, 1, 1), (0, 2, 8, 8)]:
        split, rows = dyad_mm.wgrad_split(M, n, d_in, d_out, bf16=True)
        assert rows % step == 0 and split >= 1
        assert (split - 1) * rows < max(M, 1) <= split * rows
        tiles = 2 * n * -(-d_out // tile_o) * -(-d_in // tile_i)
        # split only while every range still finds an idle SM
        assert split == 1 or split * tiles <= dyad_mm._SMS
    # Qwen3-0.6B up/gate and down: 96 tiles of 128 x 128 fill 96 of 132
    # SMs, so the rows are not split and no partials are written
    assert dyad_mm.wgrad_split(4096, 4, 256, 768, bf16=True) == (1, 4096)
    assert dyad_mm.wgrad_split(4096, 4, 768, 256, bf16=True) == (1, 4096)
    # a small grid splits: 4 tiles, 2048 rows in 32 stages of 64
    assert dyad_mm.wgrad_split(2048, 1, 64, 65, bf16=True) == (32, 64)


# -- flash_prefill_grads ----------------------------------------------------------

FLASH = [
    # (B, S, T, K, G, h, causal, window, q_off, k_off)
    (2, 37, 37, 2, 1, 16, True, None, 0, 0),
    (2, 37, 37, 2, 2, 16, True, 7, 0, 0),           # GQA, windowed
    (2, 29, 29, 1, 2, 8, False, None, 0, 0),
    (1, 24, 40, 2, 2, 16, True, None, 16, 0),       # scalar offsets, S < T
    (3, 20, 28, 2, 2, 8, True, 9, [0, 4, 30], [0, 2, 40]),   # per batch
]


def _flash_inputs(case):
    B, S, T, K, G, h, causal, window, q_off, k_off = case
    rng = np.random.default_rng(S + T + G + h)
    q = rng.standard_normal((B, S, K, G, h)).astype(np.float32)
    k = rng.standard_normal((B, T, K, h)).astype(np.float32)
    v = rng.standard_normal((B, T, K, h)).astype(np.float32)
    do = rng.standard_normal((B, S, K, G, h)).astype(np.float32)
    return q, k, v, do, np.asarray(q_off), np.asarray(k_off)


@pytest.mark.parametrize("case", FLASH)
def test_flash_prefill_grads_plain_matches_pallas(case):
    causal, window = case[6], case[7]
    q, k, v, do, q_off, k_off = _flash_inputs(case)
    kw = dict(causal=causal, window=window)
    jo, jlse = jfa.flash_prefill(*map(jnp.asarray, (q, k, v)),
                                 jnp.asarray(q_off), jnp.asarray(k_off),
                                 save_lse=True, interpret=True, **kw)
    want = jfa.flash_prefill_grads(
        *map(jnp.asarray, (q, k, v)), jo, jlse, jnp.asarray(do),
        jnp.asarray(q_off), jnp.asarray(k_off), interpret=True, **kw)
    before = flash_attn.flash_prefill_grads.launches
    got = flash_attn.flash_prefill_grads(
        _t(q), _t(k), _t(v), _t(jo), _t(jlse), _t(do), _t(q_off),
        _t(k_off), **kw)
    assert flash_attn.flash_prefill_grads.launches == before
    T, h = k.shape[1], q.shape[-1]
    for a, b, L in zip(got, want, (T, q.shape[1] * q.shape[3], h)):
        assert a.shape == b.shape
        _close(a, b, max(L, h))


def test_flash_grads_of_fully_masked_rows_are_zero():
    """Queries before every key: lse is the clamped -1e30 and every
    gradient is exactly zero, not NaN."""
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((1, 8, 2, 2, 16)).astype(np.float32))
    kv = _t(rng.standard_normal((1, 16, 2, 16)).astype(np.float32))
    o, lse = flash_attn.flash_prefill(q, kv, kv, 0, 20, save_lse=True)
    assert bool((lse < -1e29).all())
    for g in flash_attn.flash_prefill_grads(q, kv, kv, o, lse,
                                            torch.ones_like(q), 0, 20):
        assert torch.equal(g, torch.zeros_like(g))


# -- the autograd ops against jax.grad ------------------------------------------------


def _dyad_inputs(seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w1 = rng.standard_normal((4, 8, 12)).astype(np.float32)
    w2 = rng.standard_normal((4, 8, 12)).astype(np.float32)
    r = rng.standard_normal((2, 5, 32)).astype(np.float32)
    return x, w1, w2, r


def _port_dyad_grads(x, w1, w2, r, variant, use_kernel_bwd=True):
    ts = [_t(a).requires_grad_() for a in (x, w1, w2)]
    y = ops.dyad_mm(*ts, variant=variant, use_kernel_bwd=use_kernel_bwd)
    # r None: y.sum(), whose cotangent reaches backward expanded (stride 0)
    (y.sum() if r is None else (y * _t(r)).sum()).backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("variant", ["it", "ot", "dt"])
@pytest.mark.parametrize("route", ["plain", "xla", "einsumbwd"])
def test_dyad_mm_grads_match_jax(variant, route, monkeypatch):
    """plain: the default CPU route (``_bwd_direct``); xla: the same, forced
    with REPRO_KERNEL_BWD=xla; einsumbwd: the einsum VJP oracle."""
    if route == "xla":
        monkeypatch.setenv("REPRO_KERNEL_BWD", "xla")
    x, w1, w2, r = _dyad_inputs()
    kernel_bwd = route != "einsumbwd"
    jr = jnp.asarray(r)
    want = jax.grad(lambda *a: jnp.sum(jops.dyad_mm(
        *a, variant=variant, use_kernel_bwd=kernel_bwd) * jr),
        argnums=(0, 1, 2))(*map(jnp.asarray, (x, w1, w2)))
    got = _port_dyad_grads(x, w1, w2, r, variant, kernel_bwd)
    for a, b in zip(got, want):
        _close(a, b, 10)


def test_dyad_mm_grads_match_the_pallas_backward(monkeypatch):
    """The port's CPU route against the reference's interpret-mode Pallas
    backward (dgrad_two + wgrad), forced with REPRO_KERNEL_BWD=pallas on
    the JAX side only."""
    x, w1, w2, r = _dyad_inputs(12)
    monkeypatch.setenv("REPRO_KERNEL_BWD", "pallas")
    jr = jnp.asarray(r)
    want = jax.grad(lambda *a: jnp.sum(jops.dyad_mm(*a) * jr),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (x, w1, w2)))
    monkeypatch.delenv("REPRO_KERNEL_BWD")
    for a, b in zip(_port_dyad_grads(x, w1, w2, r, "it"), want):
        _close(a, b, 10)


def test_dyad_mm_expanded_cotangent():
    x, w1, w2, _ = _dyad_inputs(13)
    want = jax.grad(lambda *a: jnp.sum(jops.dyad_mm(*a)),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (x, w1, w2)))
    for a, b in zip(_port_dyad_grads(x, w1, w2, None, "it"), want):
        _close(a, b, 10)


def test_forcing_the_kernel_backward_on_cpu_raises(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BWD", "pallas")
    x, w1, w2, r = _dyad_inputs()
    with pytest.raises(RuntimeError, match="REPRO_KERNEL_BWD=pallas"):
        _port_dyad_grads(x, w1, w2, r, "it")
    q = torch.zeros(1, 4, 1, 1, 8, requires_grad=True)
    kv = torch.zeros(1, 4, 1, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="REPRO_KERNEL_BWD=pallas"):
        ops.flash_attention(q, kv, kv).sum().backward()


@pytest.mark.parametrize("variant", ["it", "ot", "dt"])
def test_dyad_mm_gradcheck_fp64(variant):
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(*s, generator=gen, dtype=torch.float64,
                        requires_grad=True)
            for s in ((3, 12), (2, 5, 6), (2, 5, 6))]
    for kernel_bwd in (True, False):
        assert torch.autograd.gradcheck(
            lambda *a: ops.dyad_mm(*a, variant=variant,
                                   use_kernel_bwd=kernel_bwd), args)


@pytest.mark.parametrize("case", [FLASH[1], FLASH[3], FLASH[4]])
@pytest.mark.parametrize("route", ["plain", "einsumbwd"])
def test_flash_attention_grads_match_jax(case, route):
    causal, window = case[6], case[7]
    q, k, v, do, q_off, k_off = _flash_inputs(case)
    kernel_bwd = route == "plain"
    jdo = jnp.asarray(do)
    want = jax.grad(lambda *a: jnp.sum(jops.flash_attention(
        *a, jnp.asarray(q_off), jnp.asarray(k_off), causal=causal,
        window=window, use_kernel_bwd=kernel_bwd) * jdo),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*ts, _t(q_off), _t(k_off), causal=causal,
                              window=window, use_kernel_bwd=kernel_bwd)
    (out * _t(do)).sum().backward()
    for t, b in zip(ts, want):
        _close(t.grad, b, k.shape[1])


def test_flash_attention_gradcheck_fp64():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(1, 5, 2, 2, 4, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    k, v = (torch.randn(1, 6, 2, 4, generator=gen, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, 1, 0, window=4),
        (q, k, v))
