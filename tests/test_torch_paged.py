"""Port parity for the paged KV cache and its pieces: the paged decode
kernel's plain version (fp and int8 pools) against the JAX kernel in
interpret mode, ``quant.quantize_kv_rows`` bit for bit, the page
allocator's properties and guards, the cache layouts, per-slot positions
(RoPE, OPT's learned table, the attention's per-slot and paged branches)
against the JAX layers, the model's paged decode against its dense
per-slot decode bit for bit, and the serving report line.

Tolerances: the paged decode 2e-5 (fp32) and 2e-2 (bf16) absolute, as
``tests/test_paged_kv.py`` holds the JAX kernel; layers and logits 1e-5 x
max(|reference|, 1) in fp32."""
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import quant as jquant  # noqa: E402
from repro.kernels import flash_attn as jfa  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers.rotary import apply_rope as japply_rope  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import errors, quant  # noqa: E402
from repro_torch.kernels import flash_attn as tfa  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers.rotary import apply_rope  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.serve.engine import PageAllocator  # noqa: E402
from test_torch_continuous import _model  # noqa: E402


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


# -- the paged decode kernel's plain version ----------------------------------


def _paged_case(P, l_real, idxs, seed=0, K=2, G=2, h=16):
    """Numpy q and pools, per-slot block tables drawn as a permutation of
    the non-scratch pages (two spare pages: not the identity layout)."""
    B = len(idxs)
    NB = -(-l_real // P)
    NP = 1 + B * NB + 2
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, K, G, h)).astype(np.float32)
    pk = rng.standard_normal((NP, P, K, h)).astype(np.float32)
    pv = rng.standard_normal((NP, P, K, h)).astype(np.float32)
    bt = rng.permutation(np.arange(1, NP))[:B * NB].reshape(B, NB)
    return q, pk, pv, bt.astype(np.int32), np.asarray(idxs, np.int32)


@pytest.mark.parametrize("P,l_real,idxs,window,dtype", [
    (4, 16, [3, 15], None, "float32"),       # dividing pages, mixed fill
    (8, 37, [5, 36, 20], None, "float32"),   # P does not divide l_real
    (4, 12, [11], 5, "float32"),             # sliding window
    (16, 16, [0, 7], None, "bfloat16"),      # single page; idx = 0
])
def test_paged_decode_plain_matches_jax_kernel(P, l_real, idxs, window,
                                               dtype):
    q, pk, pv, bt, idx = _paged_case(P, l_real, idxs)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa.flash_decode_paged(
        jnp.asarray(q, jd), jnp.asarray(pk, jd), jnp.asarray(pv, jd),
        jnp.asarray(bt), jnp.asarray(idx), l_real=l_real, window=window,
        interpret=True)
    got = tfa.flash_decode_paged(
        torch.from_numpy(q).to(td), torch.from_numpy(pk).to(td),
        torch.from_numpy(pv).to(td), torch.from_numpy(bt),
        torch.from_numpy(idx), l_real=l_real, window=window)
    assert got.shape == q.shape and got.dtype == td
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


def test_paged_decode_plain_scratch_garbage_isolated():
    """Scratch page 0, every unreferenced page and the live pages past
    the write index's block poisoned with 1e30: the output is unchanged,
    since masked probabilities are exact zeros."""
    P, idxs = 4, [2]
    q, pk, pv, bt, idx = (torch.from_numpy(a) for a in
                          _paged_case(P, 16, idxs))
    want = tfa.flash_decode_paged_plain(q, pk, pv, bt, idx)
    poison = pk.clone()
    live = set(bt.flatten().tolist())
    dead = [p for p in range(pk.shape[0]) if p not in live]
    dead += bt[0, idxs[0] // P + 1:].tolist()
    poison[dead] = 1e30
    assert torch.equal(tfa.flash_decode_paged_plain(q, poison, pv, bt, idx),
                       want)


@pytest.mark.parametrize("window", [None, 7])
def test_int8_paged_decode_plain_matches_jax_kernel(window):
    """The int8-pool variant (scores scaled per key column, probabilities
    per value row) on the case of ``tests/test_quant.py``, against the
    JAX int8 kernel, and against the plain version on dequantized fp32
    pools."""
    rng = np.random.default_rng(0)
    B, K, G, h, P, NB = 3, 2, 2, 64, 8, 5
    NP = 1 + B * NB
    q = rng.normal(size=(B, K, G, h)).astype(np.float32)
    bt = np.arange(1, NP, dtype=np.int32).reshape(B, NB)
    idx = np.array([13, 37, 29], np.int32)
    kq, ks = jquant.quantize_kv_rows(
        jnp.asarray(rng.normal(size=(NP, P, K, h)), jnp.float32))
    vq, vs = jquant.quantize_kv_rows(
        jnp.asarray(rng.normal(size=(NP, P, K, h)), jnp.float32))
    want = jfa.flash_decode_paged(
        jnp.asarray(q), kq, vq, jnp.asarray(bt), jnp.asarray(idx),
        scales_k=ks, scales_v=vs, window=window, interpret=True)
    t = {n: torch.from_numpy(np.array(a)) for n, a in
         dict(q=q, kq=kq, ks=ks, vq=vq, vs=vs, bt=bt, idx=idx).items()}
    got = tfa.flash_decode_paged(t["q"], t["kq"], t["vq"], t["bt"],
                                 t["idx"], scales_k=t["ks"],
                                 scales_v=t["vs"], window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    deq = tfa.flash_decode_paged_plain(
        t["q"], quant.dequant(t["kq"], t["ks"], -1),
        quant.dequant(t["vq"], t["vs"], -1), t["bt"], t["idx"],
        window=window)
    np.testing.assert_allclose(got.numpy(), deq.numpy(), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="together"):
        tfa.flash_decode_paged(t["q"], t["kq"], t["vq"], t["bt"], t["idx"],
                               scales_k=t["ks"])


# -- quantization -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_rows_bitwise(dtype):
    """Payload and scales bit for bit, including halfway values (a row
    whose max is 127 has scale 1, so x.5 rounds half to even on both
    sides)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 3, 32)).astype(np.float32) * 3
    x[0, 0, 0, :8] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    x[0, 0, 1] = 0.0                                # an all-zero row
    jq, js = jquant.quantize_kv_rows(jnp.asarray(x, getattr(jnp, dtype)))
    tq, ts = quant.quantize_kv_rows(torch.from_numpy(x).to(
        getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (4, 5, 3)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


def test_quant_symmetric_codec():
    g = torch.tensor([[1.0, -4.0, 2.0], [0.5, 0.25, -0.125]])
    q, s = quant.quant_symmetric(g, axis=-1)
    assert s.shape == (2,) and q.dtype == torch.int8
    back = quant.dequant(q, s, -1)
    assert float((back - g).abs().max()) <= float(s.max()) / 2 + 1e-7
    q0, s0 = quant.quant_symmetric(g)
    assert s0.dim() == 0 and int(q0.abs().max()) == 127
    with pytest.raises(ValueError, match="unknown quantization dtype"):
        quant.resolve_dtype("int4")
    assert quant.resolve_dtype("int8") == (torch.int8, 127.0)
    assert quant.resolve_dtype("fp8") == (torch.float8_e4m3fn, 448.0)


def test_quant_enabled_switch(monkeypatch):
    monkeypatch.delenv("REPRO_KERNEL_QUANT", raising=False)
    assert quant.enabled()
    monkeypatch.setenv("REPRO_KERNEL_QUANT", "off")
    assert not quant.enabled()
    cfg = tconfigs.get("qwen3_0_6b", smoke=True).replace(kv_quant="int8")
    cache = tmodel.init_cache(cfg, 2, 16, torch.float32, "cpu", page_size=4,
                              n_pages=9)
    assert "scales_k" not in cache[0]["kv"]       # quant off: fp pools


# -- errors and the page allocator --------------------------------------------


def test_error_hierarchy_keeps_the_builtin_contracts():
    pairs = [(errors.AdmissionError, ValueError),
             (errors.DeadlineExceeded, TimeoutError),
             (errors.PageExhausted, RuntimeError),
             (errors.PageAccountingError, ValueError),
             (errors.NumericalFault, ArithmeticError),
             (errors.CheckpointIOError, RuntimeError)]
    for err, builtin in pairs:
        assert issubclass(err, builtin) and issubclass(err, errors.ReproError)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10 ** 6), n_pages=st.integers(2, 17))
def test_page_allocator_properties(seed, n_pages):
    """Random alloc/retain/release schedules: no page is handed out while
    referenced, refcounts never go negative, and draining every reference
    returns every page."""
    rng = random.Random(seed)
    pool = PageAllocator(n_pages)
    held = []
    for _ in range(rng.randrange(1, 60)):
        op = rng.random()
        if op < 0.45 and pool.free_pages:
            page = pool.alloc()
            assert 1 <= page < n_pages and held.count(page) == 0
            held.append(page)
        elif op < 0.65 and held:
            page = rng.choice(held)
            pool.retain(page)
            held.append(page)
        elif held:
            page = held.pop(rng.randrange(len(held)))
            assert pool.release(page) == (page not in held)
        assert (pool.refcount >= 0).all() and pool.refcount[0] == 0
        for page in set(held):
            assert pool.refcount[page] == held.count(page)
        assert pool.free_pages == n_pages - 1 - len(set(held))
    while held:
        pool.release(held.pop())
    assert pool.free_pages == n_pages - 1 and (pool.refcount == 0).all()


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_page_allocator_guards_under_random_schedules(seed):
    """Invalid releases sprinkled into random schedules raise and leave
    the pool unchanged; the valid accounting stays exact."""
    rng = random.Random(seed)
    pool = PageAllocator(rng.randrange(2, 12))
    held = []
    for _ in range(rng.randrange(1, 80)):
        op = rng.random()
        if op < 0.35 and pool.free_pages:
            held.append(pool.alloc())
        elif op < 0.55 and held:
            page = rng.choice(held)
            pool.retain(page)
            held.append(page)
        elif op < 0.8 and held:
            pool.release(held.pop(rng.randrange(len(held))))
        else:
            free_before = pool.free_pages
            victim = rng.randrange(pool.n_pages)
            if held.count(victim) == 0:
                with pytest.raises(errors.PageAccountingError):
                    pool.release(victim)
                assert pool.free_pages == free_before
    for page in held:
        pool.release(page)
    assert pool.free_pages == pool.n_pages - 1 and (pool.refcount == 0).all()


def test_page_allocator_errors():
    with pytest.raises(ValueError):
        PageAllocator(1)
    pool = PageAllocator(3)
    with pytest.raises(errors.PageAccountingError):
        pool.release(1)                 # never allocated
    with pytest.raises(errors.PageAccountingError):
        pool.retain(0)                  # the scratch page
    a, b = pool.alloc(), pool.alloc()
    assert {a, b} == {1, 2}
    with pytest.raises(errors.PageExhausted):
        pool.alloc()
    assert pool.release(a)
    with pytest.raises(errors.PageAccountingError):
        pool.release(a)                 # double release
    with pytest.raises(errors.PageAccountingError):
        pool.retain(a)                  # retain of a free page
    pool._free.append(b)                # a corrupt hand-back
    with pytest.raises(errors.PageAccountingError):
        while True:
            pool.alloc()


# -- cache layouts ------------------------------------------------------------


def test_paged_cache_layouts_match_reference():
    c = tattn.init_paged_kv_cache(2, 32, 2, 16, page_size=8, n_pages=9,
                                  quant="int8")
    j = jattn.init_paged_kv_cache(2, 32, 2, 16, page_size=8, n_pages=9,
                                  quant="int8")
    for name, leaf in j.items():
        assert tuple(c[name].shape) == leaf.shape, name
        assert str(c[name].dtype).split(".")[1] == str(leaf.dtype), name
    with pytest.raises(ValueError, match="int8"):
        tattn.init_paged_kv_cache(2, 32, 2, 16, page_size=8, n_pages=9,
                                  quant="fp8")
    d = tattn.init_paged_kv_cache(2, 32, 2, 16, page_size=8, n_pages=9)
    assert "scales_k" not in d and d["pages_k"].dtype == torch.bfloat16
    assert (d["block_table"] == 0).all() and d["idx"].shape == (2,)
    s = tattn.init_kv_cache(3, 8, 2, 16, per_slot=True)
    assert s["idx"].shape == (3,) and s["idx"].dtype == torch.int32
    assert tattn.init_kv_cache(3, 8, 2, 16)["idx"] == 0


def test_model_cache_shares_block_table_and_index_across_layers():
    cfg = tconfigs.get("qwen3_0_6b", smoke=True).replace(n_layers=3,
                                                         kv_quant="int8")
    cache = tmodel.init_cache(cfg, 2, 16, torch.float32, "cpu", page_size=4,
                              n_pages=9)
    assert all(lc["kv"]["block_table"] is cache[0]["kv"]["block_table"]
               and lc["kv"]["idx"] is cache[0]["kv"]["idx"] for lc in cache)
    assert cache[0]["kv"]["pages_k"].dtype == torch.int8
    assert cache[0]["kv"]["scales_k"].shape == (9, 4, cfg.n_kv_heads)
    assert cache[0]["kv"]["pages_k"] is not cache[1]["kv"]["pages_k"]
    dense = tmodel.init_cache(cfg, 2, 16, torch.float32, "cpu",
                              per_slot=True)
    assert all(lc["kv"]["idx"] is dense[0]["kv"]["idx"] for lc in dense)


# -- per-slot positions -------------------------------------------------------


def test_rope_per_slot_positions_match_jax():
    x = np.random.default_rng(0).standard_normal((3, 4, 2, 16)).astype(
        np.float32)
    pos = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [40, 41, 42, 43]])
    want = japply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _close(got.numpy(), want)


def test_learned_positions_per_slot_match_jax():
    """OPT reads its learned position table at each slot's own positions
    from a (B,) offset."""
    jcfg, jp, tcfg, tp = _model("opt125m")
    toks = np.random.default_rng(2).integers(0, 256, (3, 2)).astype(np.int32)
    off = np.array([0, 5, 11], np.int32)
    want, wpos = jmodel._embed_inputs(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                      offset=jnp.asarray(off))
    got, gpos = tmodel._embed_inputs(tcfg, tp, torch.from_numpy(toks).long(),
                                     offset=torch.from_numpy(off))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    _close(got.numpy(), want)


def _attn_pair(seed=3):
    jcfg = jconfigs.get("qwen3_0_6b", smoke=True)
    lin = jconfigs.linear_cfg("dense")
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg.d_model,
                              jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim,
                              lin, qk_norm=True)
    jp = jax.tree.map(lambda a: a * 1.5, jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    kw = dict(n_heads=jcfg.n_heads, n_kv=jcfg.n_kv_heads,
              head_dim=jcfg.head_dim, rope_theta=jcfg.rope_theta, flash=True)
    return jcfg, lin, jp, tp, kw


def _t(tree):
    return {k: (torch.from_numpy(np.array(v)) if hasattr(v, "shape")
                else v) for k, v in tree.items()}


@pytest.mark.parametrize("route", ["xla", "flash"])
@pytest.mark.parametrize("layout", ["per_slot", "paged", "paged_int8"])
def test_attention_cache_branches_match_jax(layout, route, monkeypatch):
    """A 3-token prefill at per-slot offsets [0, 4] then a decode step, on
    the per-slot dense ring and the paged pool (fp32 and int8), against
    the JAX attention on both routes (interpret-mode flash kernels)."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", route)
    jcfg, lin, jp, tp, kw = _attn_pair()
    tlin = tconfigs.linear_cfg("dense")
    B, L, K, h = 2, 16, jcfg.n_kv_heads, jcfg.head_dim
    rng = np.random.default_rng(5)
    if layout == "per_slot":
        jc = jattn.init_kv_cache(B, L, K, h, jnp.float32, per_slot=True)
    else:
        jc = jattn.init_paged_kv_cache(
            B, L, K, h, jnp.float32, page_size=4, n_pages=1 + 2 * B * 4,
            quant="int8" if layout == "paged_int8" else None)
        bt = rng.permutation(np.arange(1, 1 + 2 * B * 4))[:B * 4]
        jc["block_table"] = jnp.asarray(bt.reshape(B, 4), jnp.int32)
    jc["idx"] = jnp.asarray([0, 4], jnp.int32)
    tc = _t(jc)
    for S in (3, 1):
        x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
        want, jc = jattn.attention(jp, jnp.asarray(x), lin_cfg=lin,
                                   cache=jc, **kw)
        got, tc = tattn.attention(tp, torch.from_numpy(x), lin_cfg=tlin,
                                  cache=tc, **kw)
        _close(got.numpy(), want)
        np.testing.assert_array_equal(tc["idx"].numpy(),
                                      np.asarray(jc["idx"]))
    for name in jc:
        if name not in ("idx", "block_table"):
            _close(tc[name].float().numpy(),
                   np.asarray(jc[name], np.float32))


@pytest.mark.parametrize("route", ["xla", "flash"])
def test_model_paged_decode_equals_dense_per_slot_bitwise(route,
                                                          monkeypatch):
    """Through the model: block tables covering max_len exactly, the paged
    prefill and decode give logits bitwise equal to the dense per-slot
    cache's."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", route)
    _, _, cfg, params = _model()
    B, S, M, P = 2, 6, 16, 4
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)))
    cd = tmodel.init_cache(cfg, B, M, torch.float32, "cpu", per_slot=True)
    NB = M // P
    cp = tmodel.init_cache(cfg, B, M, torch.float32, "cpu", page_size=P,
                           n_pages=1 + B * NB)
    cp[0]["kv"]["block_table"].copy_(torch.arange(
        1, 1 + B * NB, dtype=torch.int32).reshape(B, NB))
    with torch.no_grad():
        ld, cd = tmodel.prefill(cfg, params, cd, toks)
        lp, cp = tmodel.prefill(cfg, params, cp, toks)
        assert torch.equal(ld, lp)
        tok = ld.argmax(-1)
        for _ in range(3):
            dd, cd = tmodel.decode_step(cfg, params, cd, tok)
            dp, cp = tmodel.decode_step(cfg, params, cp, tok)
            assert torch.equal(dd, dp)
            tok = dd.argmax(-1)


@pytest.mark.parametrize("route", ["xla", "flash"])
@pytest.mark.parametrize("layout", ["ring", "per_slot", "paged"])
def test_cache_index_work_is_built_once_per_step(layout, route,
                                                 monkeypatch):
    """Every layer reads one write index (and block table), so a step
    builds their index tensors once, in its first layer: the write rows,
    the gathered view's rows and the key positions.  Key positions are
    built on the plain route only: the flash kernels derive them."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", route)
    _, _, cfg, params = _model()
    assert cfg.n_layers > 1
    calls = {}
    for name in ("_key_positions", "_ring_rows", "_page_rows"):
        real = getattr(tattn, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(tattn, name, spy)
    B, M, P = 2, 16, 4
    kw = {"ring": {}, "per_slot": dict(per_slot=True),
          "paged": dict(page_size=P, n_pages=1 + B * M // P)}[layout]
    cache = tmodel.init_cache(cfg, B, M, torch.float32, "cpu", **kw)
    if layout == "paged":
        cache[0]["kv"]["block_table"].copy_(torch.arange(
            1, 1 + B * M // P, dtype=torch.int32).reshape(B, -1))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, 1)))
    with torch.no_grad():
        logits, _ = tmodel.decode_step(cfg, params, cache, toks)
    assert torch.isfinite(logits).all()
    plain = route == "xla"
    want = {"ring": {"_key_positions": 1} if plain else {},
            "per_slot": dict({"_ring_rows": 1},
                             **({"_key_positions": 1} if plain else {})),
            # the write's rows, and on the plain route the gathered view's
            "paged": ({"_page_rows": 2, "_key_positions": 1} if plain
                      else {"_page_rows": 1})}[layout]
    assert calls == want


def test_flash_route_refuses_per_batch_positions_without_a_cache(
        monkeypatch):
    """(B, S) positions with no cache: the reference takes its einsum path
    there, which the flash route must not do quietly."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", "flash")
    jcfg, _, _, tp, kw = _attn_pair()
    x = torch.zeros(2, 3, jcfg.d_model)
    pos = torch.arange(3)[None].repeat(2, 1)
    with pytest.raises(NotImplementedError, match="A.9"):
        tattn.attention(tp, x, lin_cfg=tconfigs.linear_cfg("dense"),
                        positions=pos, **kw)


def test_model_paged_prefill_and_decode_match_jax():
    """Per-slot write offsets through the whole model: a paged cache at
    offsets [0, 5] (the second slot's rows prefilled first), then decode
    steps, against the JAX model."""
    jcfg, jp, tcfg, tp = _model()
    B, M, P = 2, 16, 4
    NB = M // P
    bt = (1 + np.arange(B * NB, dtype=np.int32)).reshape(B, NB)
    jc = jmodel.init_cache(jcfg, B, M, jnp.float32, page_size=P,
                           n_pages=1 + B * NB)
    jc["kv"]["block_table"] = jnp.broadcast_to(
        jnp.asarray(bt), jc["kv"]["block_table"].shape)
    tc = tmodel.init_cache(tcfg, B, M, torch.float32, "cpu", page_size=P,
                           n_pages=1 + B * NB)
    tc[0]["kv"]["block_table"].copy_(torch.from_numpy(bt))
    rng = np.random.default_rng(1)
    for step, (S, off) in enumerate(((5, [0, 0]), (3, [5, 5]),
                                     (1, [8, 8]), (1, [9, 9]))):
        toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        idx = np.asarray(off, np.int32)
        if step == 1:
            idx = np.asarray([5, 2], np.int32)    # slots apart
        jc["kv"]["idx"] = jnp.broadcast_to(jnp.asarray(idx),
                                           jc["kv"]["idx"].shape)
        tc[0]["kv"]["idx"].copy_(torch.from_numpy(idx))
        want, jc = jmodel.prefill(jcfg, jp, jc, jnp.asarray(toks),
                                  last_only=False)
        with torch.no_grad():
            got, nc = tmodel.prefill(tcfg, tp, tc, torch.from_numpy(toks)
                                     .long(), last_only=False)
        _close(got.numpy(), want)
        np.testing.assert_array_equal(nc[0]["kv"]["idx"].numpy(),
                                      np.asarray(jc["kv"]["idx"][0]))


# -- the serving report line --------------------------------------------------


def test_format_serving_line_matches_reference():
    regs = [jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()]
    for m in regs:
        m.t_start = -1e12                      # tok/s ~ 0 on both sides
        m.counter("tokens_generated").inc(40)
        m.counter("requests_finished").inc(3)
        m.counter("prefix_hits").inc(2)
        m.counter("preemptions").inc()
        m.gauge("page_pool_used").set(7)
        m.gauge("page_pool_used").set(3)
        m.gauge("active_slots").set(2)
        for v in (0.01, 0.02, 0.5):
            m.histogram("ttft_s").observe(v)
            m.histogram("itl_s").observe(v / 10)
    want = jmetrics.format_serving_line(regs[0])
    assert tmetrics.format_serving_line(regs[1]) == want
    assert "pages=3/7peak" in want
