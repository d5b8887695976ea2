"""Port parity for the kernels' plain versions: ``dyad_mm_blocks``,
``flash_prefill`` and ``flash_decode`` of ``repro_torch.kernels`` against
the JAX Pallas kernels run in interpret mode (as ``tests/test_kernels.py``
and ``tests/test_flash_attn.py`` run them) and against the einsum oracles
of both packages.  All inputs come from numpy with a seed; fp32 on the CPU,
where each wrapper takes its plain version.

Tolerance: 1e-5 times max(|reference|, 1).  The sums run in another order
than the tiled Pallas kernels (ROADMAP C.1 measured 4e-7 relative)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attn as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dyad_mm import dyad_mm_blocks as j_dyad_mm_blocks  # noqa: E402
from repro_torch.kernels import dyad_mm, flash_attn, ops, ref  # noqa: E402

TOL = 1e-5


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _np(t):
    return t.detach().numpy()


# -- dyad_mm_blocks -------------------------------------------------------------

DYAD_SHAPES = [
    # (M, n, d_in, d_out)
    (8, 4, 16, 32),
    (10, 2, 33, 17),          # odd k, prime o
    (13, 3, 7, 5),            # everything prime
    (64, 2, 129, 130),        # just past 128: the reference pads these
]


@pytest.mark.parametrize("variant", ["it", "ot"])
@pytest.mark.parametrize("M,n,d_in,d_out", DYAD_SHAPES)
def test_dyad_mm_blocks_plain_matches_pallas(M, n, d_in, d_out, variant):
    rng = np.random.default_rng(M + n + d_in)
    x = rng.standard_normal((M, n * d_in)).astype(np.float32)
    w1 = rng.standard_normal((n, d_out, d_in)).astype(np.float32)
    w2 = rng.standard_normal((n, d_out, d_in)).astype(np.float32)
    before = dyad_mm.dyad_mm_blocks.launches
    got = dyad_mm.dyad_mm_blocks(torch.from_numpy(x), torch.from_numpy(w1),
                                 torch.from_numpy(w2), variant)
    assert dyad_mm.dyad_mm_blocks.launches == before   # CPU: plain route
    x1, x2 = jref.block_views(jnp.asarray(x), n, variant)
    want = j_dyad_mm_blocks(x1, x2, jnp.asarray(w1), jnp.asarray(w2),
                            interpret=True)
    assert got.shape == (M, n, d_out)
    _close(_np(got), want)
    # the flat sum equals the einsum oracle for IT (one output layout)
    if variant == "it":
        _close(_np(got.reshape(M, -1)),
               jref.dyad_mm_ref(jnp.asarray(x), jnp.asarray(w1),
                                jnp.asarray(w2), variant="it"))


@pytest.mark.parametrize("variant", ["it", "ot", "dt"])
def test_ops_dyad_mm_matches_jax_op(variant):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w1 = rng.standard_normal((4, 8, 12)).astype(np.float32)
    w2 = rng.standard_normal((4, 8, 12)).astype(np.float32)
    got = ops.dyad_mm(torch.from_numpy(x), torch.from_numpy(w1),
                      torch.from_numpy(w2), variant=variant)
    want = jops.dyad_mm(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                        variant=variant)
    _close(_np(got), want)
    _close(_np(ref.dyad_mm_ref(torch.from_numpy(x), torch.from_numpy(w1),
                               torch.from_numpy(w2), variant=variant)), want)


def test_ref_views_round_trip():
    """``unview`` inverts ``block_views``; ``split_cotangent`` mirrors
    ``combine`` — the same re-views as the reference's oracles."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 24)).astype(np.float32)
    for variant in ("it", "ot", "dt"):
        tx = torch.from_numpy(x)
        x1, x2 = ref.block_views(tx, 4, variant)
        j1, j2 = jref.block_views(jnp.asarray(x), 4, variant)
        np.testing.assert_array_equal(_np(x1), np.asarray(j1))
        np.testing.assert_array_equal(_np(x2), np.asarray(j2))
        np.testing.assert_array_equal(
            _np(ref.unview(x1, x2, variant)),
            np.asarray(jref.unview(j1, j2, variant)))
        z1, z2 = ref.split_cotangent(tx, 4, variant)
        np.testing.assert_array_equal(
            _np(ref.combine(z1, z2, variant)),
            np.asarray(jref.combine(*jref.split_cotangent(
                jnp.asarray(x), 4, variant), variant)))


# -- flash_prefill --------------------------------------------------------------


def _qkv(rng, B, S, T, K, G, h):
    return (rng.standard_normal((B, S, K, G, h)).astype(np.float32),
            rng.standard_normal((B, T, K, h)).astype(np.float32),
            rng.standard_normal((B, T, K, h)).astype(np.float32))


PREFILL = [
    # (B, S, T, K, G, h, causal, window, q_off, k_off)
    (2, 37, 37, 2, 1, 16, True, None, 0, 0),
    (2, 37, 37, 2, 2, 16, True, 7, 0, 0),
    (2, 37, 37, 1, 4, 16, False, None, 0, 0),
    (1, 24, 40, 2, 2, 16, True, None, 0, 0),       # cache prefill: S < T
    (3, 20, 28, 2, 2, 8, True, 9, [0, 4, 30], [0, 2, 40]),   # per-batch
]


@pytest.mark.parametrize("case", PREFILL)
def test_flash_prefill_plain_matches_pallas(case):
    B, S, T, K, G, h, causal, window, q_off, k_off = case
    rng = np.random.default_rng(S + T + G)
    q, k, v = _qkv(rng, B, S, T, K, G, h)
    qo = np.asarray(q_off, np.int32)
    ko = np.asarray(k_off, np.int32)
    before = flash_attn.flash_prefill.launches
    got, lse = flash_attn.flash_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qo) if qo.ndim else q_off,
        torch.from_numpy(ko) if ko.ndim else k_off,
        causal=causal, window=window, save_lse=True)
    assert flash_attn.flash_prefill.launches == before
    want, wlse = jfa.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qo),
        jnp.asarray(ko), causal=causal, window=window, save_lse=True,
        block_q=16, block_k=128, interpret=True)
    _close(_np(got), want)
    assert lse.shape == (B, K, S * G)
    _close(_np(lse), wlse)
    # and against the einsum oracles, with the same positions
    qpos = qo.reshape(-1, 1) + np.arange(S)
    kpos = ko.reshape(-1, 1) + np.arange(T)
    oracle = jref.sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(qpos), jnp.asarray(kpos),
                           causal=causal, window=window)
    _close(_np(got), oracle)
    _close(_np(ref.sdpa_ref(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(qpos),
                            torch.from_numpy(kpos), causal=causal,
                            window=window)), oracle)


def test_flash_prefill_fully_masked_row_is_zero():
    """Queries before every key (k_off past q): each row is fully masked
    and gives exactly 0, with lse at the -1e30 floor, as the Pallas kernel."""
    rng = np.random.default_rng(21)
    q, k, v = _qkv(rng, 1, 8, 16, 2, 2, 16)
    got, lse = flash_attn.flash_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0, 20,
        causal=True, save_lse=True)
    want, wlse = jfa.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, 20, causal=True,
        save_lse=True, block_q=8, block_k=128, interpret=True)
    assert np.all(_np(got) == 0.0) and np.all(np.asarray(want) == 0.0)
    assert np.all(_np(lse) <= -1e29) and np.all(np.asarray(wlse) <= -1e29)


# -- flash_decode ---------------------------------------------------------------


def _ring_kpos(idx, L):
    j = np.arange(L)
    kpos = idx - (idx - j) % L
    return np.where(kpos >= 0, kpos, -(10 ** 9))


@pytest.mark.parametrize("L,idxs,window,G", [
    (8, [3], None, 2),            # scalar idx, unwrapped
    (8, [11], 8, 2),              # scalar idx, wrapped ring
    (8, [3, 11], 8, 1),           # per-slot idx, mixed wrap state
    (10, [5, 20, 16], 7, 4),      # odd L, wrapped, windowed
    (40, [0, 39], None, 2),       # first and last slot of a long cache
])
def test_flash_decode_plain_matches_pallas(L, idxs, window, G):
    B, K, h = len(idxs), 2, 16
    rng = np.random.default_rng(L + sum(idxs))
    q = rng.standard_normal((B, 1, K, G, h)).astype(np.float32)
    k = rng.standard_normal((B, L, K, h)).astype(np.float32)
    v = rng.standard_normal((B, L, K, h)).astype(np.float32)
    idx_np = np.asarray(idxs, np.int32)
    t_idx = idxs[0] if B == 1 else torch.from_numpy(idx_np)
    before = flash_attn.flash_decode.launches
    got = flash_attn.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), t_idx, window=window)
    assert flash_attn.flash_decode.launches == before
    j_idx = jnp.int32(idxs[0]) if B == 1 else jnp.asarray(idx_np)
    want = jfa.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            j_idx, window=window, block_k=128,
                            interpret=True)
    assert got.shape == q.shape
    _close(_np(got), want)
    oracle = np.concatenate([
        np.asarray(jref.sdpa_ref(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), jnp.array([idxs[b]]),
            jnp.asarray(_ring_kpos(idxs[b], L)), causal=True,
            window=window)) for b in range(B)])
    _close(_np(got), oracle)


def test_attn_route(monkeypatch):
    monkeypatch.delenv("REPRO_KERNEL_ATTN", raising=False)
    assert ops.attn_route(torch.device("cpu")) == "xla"
    assert ops.attn_route(torch.device("cuda")) == "flash"
    monkeypatch.setenv("REPRO_KERNEL_ATTN", "flash")
    assert ops.attn_route(torch.device("cpu")) == "flash"
    monkeypatch.setenv("REPRO_KERNEL_ATTN", "xla")
    assert ops.attn_route(torch.device("cuda")) == "xla"
