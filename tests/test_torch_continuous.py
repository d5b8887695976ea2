"""Port parity for continuous batching: ``repro_torch.serve.engine``'s
``ContinuousBatchingEngine`` against the JAX engine on bridged weights,
in dense per-slot mode and in paged mode (chunked prefill, prefix cache,
int8 pools, preemption), the block tables both engines build, and the
engine's lifecycle on its own: admission errors, deadlines, cancel,
the NaN guard and its demotion ladder, page bookkeeping, the launcher.

Greedy tokens are compared exactly.  The ff weights are scaled by 4 on
both sides (as in ``tests/test_torch_serve.py``): at the init scale greedy
decoding from random weights repeats one token, which would leave most of
the comparison blind.  Prompts come from numpy with fixed seeds; the JAX
side runs on its default CPU route (the einsum attention), as its own
engine tests run it."""
import json
import os
import pathlib
import random
import subprocess
import sys
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import flatten_with_paths  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve.engine import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.errors import AdmissionError, DeadlineExceeded  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      RetireReason)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPECS = {"qwen3_0_6b": "dyad_it_4_kernel_ffused",
         "opt125m": "dyad_it_4_kernel"}
_MODELS = {}


def _model(arch="qwen3_0_6b", ff_scale=4.0):
    """(jax cfg, jax params, port cfg, port params) on the same weights,
    the smoke config with the ff weights scaled by ``ff_scale``."""
    key = (arch, ff_scale)
    if key not in _MODELS:
        spec = SPECS[arch]
        jcfg = jconfigs.get(arch, smoke=True,
                            linear=jconfigs.linear_cfg(spec))
        tcfg = tconfigs.get(arch, smoke=True,
                            linear=tconfigs.linear_cfg(spec))
        tree = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in flatten_with_paths(tree).items()}
        for k in flat:
            if k.startswith("layers/mlp/") and k.endswith(("/w1", "/w2")):
                flat[k] = flat[k] * np.float32(ff_scale)
        jp = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [jnp.asarray(flat[k]) for k in flatten_with_paths(tree)])
        _MODELS[key] = (jcfg, jp, tcfg, bridge.from_flat(flat, "cpu"))
    return _MODELS[key]


def _prompts(vocab, seed=1, lengths=(5, 9, 3, 12, 7), shared=0):
    """Prompts of the given lengths; the first ``shared`` tokens are one
    common prefix (a system prompt)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, n - shared)
                            .astype(np.int32)]) for n in lengths]


def _port(tcfg, tp, **kw):
    return ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)


def _jax(jcfg, jp, **kw):
    return JEngine(jcfg, jp, cache_dtype=jnp.float32, **kw)


def _drive(eng, prompts, max_new):
    uids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    res = eng.run()
    return [[int(t) for t in res[u]] for u in uids]


MODES = {
    "dense": dict(),
    "paged": dict(page_size=4),
    "paged_chunk_prefix": dict(page_size=4, prefill_chunk=3,
                               prefix_cache=True),
}


@pytest.mark.parametrize("arch,mode", [
    ("qwen3_0_6b", "dense"), ("qwen3_0_6b", "paged"),
    ("qwen3_0_6b", "paged_chunk_prefix"), ("opt125m", "dense"),
    ("opt125m", "paged_chunk_prefix")])
def test_greedy_tokens_match_jax_engine(arch, mode):
    """Five requests over three slots (slot reuse), mixed prompt lengths
    behind a shared 8-token prefix (two pages: the prefix cache hits), an
    EOS the model emits mid-stream; OPT's learned position table is read
    at each slot's own positions."""
    jcfg, jp, tcfg, tp = _model(arch)
    prompts = _prompts(jcfg.vocab_size, lengths=(9, 13, 10, 12, 11),
                       shared=8)
    # the first request outlives the next two, so its registered prefix
    # pages are live when the queued requests are admitted
    max_new = [11, 4, 7, 3, 5]
    kw = dict(n_slots=3, max_len=20, **MODES[mode])
    want = _drive(_jax(jcfg, jp, **kw), prompts, max_new)
    eng = _port(tcfg, tp, **kw)
    assert _drive(eng, prompts, max_new) == want
    assert len({t for row in want for t in row}) > 4    # not blind
    if eng.paged:
        assert eng.pages.free_pages == eng.pages.n_pages - 1
    if mode == "paged_chunk_prefix":
        assert eng.stats["prefix_hits"] > 0
    # an EOS from the middle of a stream retires that request early
    eos = want[2][2]
    want_eos = _drive(_jax(jcfg, jp, eos_id=eos, **kw), prompts, max_new)
    assert any(len(a) < len(b) for a, b in zip(want_eos, want))
    assert _drive(_port(tcfg, tp, eos_id=eos, **kw), prompts,
                  max_new) == want_eos


def test_block_tables_match_jax_engine_step_by_step():
    """After the same submits and at every step, both engines hold the
    same host block tables, reservations, refcounts and prefix registry,
    and emit the same tokens."""
    jcfg, jp, tcfg, tp = _model()
    prompts = _prompts(jcfg.vocab_size, seed=3, lengths=(10, 13, 9, 11),
                       shared=8)
    kw = dict(n_slots=2, max_len=20, page_size=4, prefill_chunk=4,
              prefix_cache=True, n_pages=12)
    je, te = _jax(jcfg, jp, **kw), _port(tcfg, tp, **kw)

    def same():
        np.testing.assert_array_equal(te._bt, je._bt)
        np.testing.assert_array_equal(te._nblk, je._nblk)
        np.testing.assert_array_equal(te.pages.refcount, je.pages.refcount)
        assert te._prefilling == je._prefilling
        assert set(te._prefix.items()) == set(je._prefix.items())
        assert te.stats == je.stats

    # the first request outlives the second, so its prefix pages are
    # live (and shared) when the queued requests are admitted
    for p, m in zip(prompts, (9, 3, 5, 4)):
        assert te.submit(p, m) == je.submit(p, m)
        same()
    while je.slots.active or je.queue:
        got = {r.uid: r.tokens for r in te.step()}
        want = {r.uid: [int(t) for t in r.tokens] for r in je.step()}
        assert got == want
        same()
    assert not (te.slots.active or te.queue)
    assert te.stats["prefix_hits"] >= 1


def test_int8_kv_tokens_match_jax_engine():
    """int8 pools (``kv_quant="int8"``): rows quantized as they land, the
    chunked prefill over the dequantized view, decode over the int8
    pools; the same greedy tokens as the JAX int8 engine."""
    jcfg, jp, tcfg, tp = _model()
    jcfg, tcfg = jcfg.replace(kv_quant="int8"), tcfg.replace(kv_quant="int8")
    prompts = _prompts(jcfg.vocab_size, lengths=(9, 13, 10, 12), shared=8)
    max_new = [6, 4, 7, 5]
    kw = dict(n_slots=3, max_len=20, page_size=4, prefill_chunk=4,
              prefix_cache=True)
    want = _drive(_jax(jcfg, jp, **kw), prompts, max_new)
    eng = _port(tcfg, tp, **kw)
    assert eng.cache[0]["kv"]["pages_k"].dtype == torch.int8
    assert _drive(eng, prompts, max_new) == want


def test_preemption_is_token_exact_and_matches_jax():
    """A fresh request that cannot fit preempts the youngest decoding
    victim; the victim resumes later with the same tokens as an
    unpressured run, and as the JAX engine under the same pressure."""
    jcfg, jp, tcfg, tp = _model()
    prompts = _prompts(jcfg.vocab_size, seed=5, lengths=(8, 7))
    base = _drive(_port(tcfg, tp, n_slots=2, max_len=24, page_size=4,
                        n_pages=32), prompts, [8, 8])
    # each request reserves ceil((8 + 8 - 1) / 4) = 4 pages of the 6
    kw = dict(n_slots=2, max_len=24, page_size=4, n_pages=7)
    eng = _port(tcfg, tp, **kw)
    u0 = eng.submit(prompts[0], 8)
    u1 = eng.submit(prompts[1], 8)
    assert eng.metrics_summary()["counters"]["preemptions"] == 1
    res = eng.run()
    assert [res[u0], res[u1]] == base
    assert eng.pages.free_pages == eng.pages.n_pages - 1
    assert (eng.pages.refcount == 0).all()
    assert _drive(_jax(jcfg, jp, **kw), prompts, [8, 8]) == base


def test_resumed_request_cannot_retrigger_preemption():
    _, _, tcfg, tp = _model()
    eng = _port(tcfg, tp, n_slots=3, max_len=24, page_size=4, n_pages=7)
    uids = [eng.submit(q, 8) for q in _prompts(tcfg.vocab_size, seed=6,
                                               lengths=(8, 7, 6))]
    res = eng.run()
    assert eng.metrics_summary()["counters"]["preemptions"] <= 3
    assert all(len(res[u]) == 8 for u in uids)
    assert eng.pages.free_pages == eng.pages.n_pages - 1


def test_prefix_cache_shares_pages_and_frees_them_late():
    """A second request sharing a 2-page prompt prefix retains the
    first's pages (refcount 2), prefills only its tail, and the shared
    pages go back to the pool only when the last sharer retires."""
    _, _, tcfg, tp = _model()
    p1, p2 = _prompts(tcfg.vocab_size, seed=2, lengths=(11, 13), shared=8)
    kw = dict(n_slots=2, max_len=20)
    want = _drive(_port(tcfg, tp, **kw), [p1, p2], [2, 6])
    eng = _port(tcfg, tp, page_size=4, prefix_cache=True, **kw)
    u1, u2 = eng.submit(p1, 2), eng.submit(p2, 6)
    s1 = next(s for s, r in eng.slots.active.items() if r.uid == u1)
    s2 = next(s for s, r in eng.slots.active.items() if r.uid == u2)
    shared = eng._bt[s1, :2].copy()
    np.testing.assert_array_equal(eng._bt[s2, :2], shared)
    assert all(eng.pages.refcount[p] == 2 for p in shared)
    assert eng.stats["prefix_pages_shared"] == 2
    assert eng.stats["prefill_tokens"] == len(p1) + len(p2) - 8
    res = {}
    while u1 not in res:
        res.update({r.uid: r.tokens for r in eng.step()})
    assert u2 not in res
    assert all(eng.pages.refcount[p] == 1 for p in shared)
    while eng.slots.active or eng.queue:
        res.update({r.uid: r.tokens for r in eng.step()})
    assert [res[u1], res[u2]] == want
    assert eng.pages.free_pages == eng.pages.n_pages - 1
    assert not eng._prefix and not eng._page_hash


def test_pool_exhaustion_blocks_admission():
    _, _, tcfg, tp = _model()
    eng = _port(tcfg, tp, n_slots=2, max_len=16, page_size=4, n_pages=4)
    rng = np.random.default_rng(0)
    u1 = eng.submit(rng.integers(0, 256, 8).astype(np.int32), 4)
    u2 = eng.submit(rng.integers(0, 256, 5).astype(np.int32), 4)
    assert len(eng.queue) == 1 and eng.slots.free_slots == 1
    with pytest.raises(ValueError):
        eng.submit(np.zeros(13, np.int32), 4)     # 4 pages: never fits
    res = eng.run()
    assert len(res[u1]) == 4 and len(res[u2]) == 4
    assert eng.pages.free_pages == 3


def _check_paged_invariants(eng):
    P = eng.page_size
    held = []
    for slot, req in eng.slots.active.items():
        nblk = int(eng._nblk[slot])
        assert nblk == max(1, -(-(len(req.prompt) + req.max_new - 1) // P))
        row = eng._bt[slot, :nblk]
        assert (row > 0).all(), "live block table points at scratch"
        assert (eng._bt[slot, nblk:] == 0).all()
        assert nblk * P >= eng.slots.lengths[slot]
        assert all(eng.pages.refcount[p] > 0 for p in row)
        held.extend(row.tolist())
    assert len(held) == len(set(held)), "page assigned to two slots"
    assert eng.pages.free_pages == int((eng.pages.refcount[1:] == 0).sum())


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 3))
def test_engine_page_bookkeeping_randomized(seed):
    """Random submit/step schedules through the real engine: the block
    table and refcount invariants hold at every step, and a drain returns
    every page."""
    _, _, tcfg, tp = _model()
    rng = random.Random(seed)
    eng = _port(tcfg, tp, n_slots=2, max_len=16, page_size=4, n_pages=9)
    rng2 = np.random.default_rng(seed)
    for _ in range(rng.randrange(2, 5)):
        S = rng.choice([3, 5, 8])
        eng.submit(rng2.integers(0, 256, S).astype(np.int32),
                   rng.choice([2, 4]))
        _check_paged_invariants(eng)
        for _ in range(rng.randrange(0, 3)):
            eng.step()
            _check_paged_invariants(eng)
    while eng.slots.active or eng.queue:
        eng.step()
        _check_paged_invariants(eng)
    assert eng.pages.free_pages == eng.pages.n_pages - 1
    assert (eng.pages.refcount == 0).all()
    assert (eng._bt == 0).all() and (eng._nblk == 0).all()


# -- lifecycle: admission errors, deadlines, cancel ---------------------------


def test_submit_raises_typed_admission_errors():
    _, _, tcfg, tp = _model()
    eng = _port(tcfg, tp, n_slots=2, max_len=16, page_size=4, n_pages=4)
    with pytest.raises(AdmissionError):
        eng.submit(np.zeros(30, np.int32), 4)          # exceeds max_len
    with pytest.raises(AdmissionError):
        eng.submit(np.zeros(4, np.int32), 0)           # max_new < 1
    with pytest.raises(AdmissionError):
        eng.submit(np.zeros(4, np.int32), 4, deadline_s=-1.0)
    with pytest.raises(AdmissionError):
        eng.submit(np.zeros(10, np.int32), 6)   # 4 of 3 usable pages
    with pytest.raises(ValueError):             # the builtin contract
        eng.submit(np.zeros(30, np.int32), 4)
    assert eng.metrics_summary()["counters"]["admission_rejects"] == 5


def test_deadline_retires_with_partial_output():
    _, _, tcfg, tp = _model()
    eng = _port(tcfg, tp, n_slots=1, max_len=32)
    u0 = eng.submit(np.arange(4, dtype=np.int32), 8)
    u1 = eng.submit(np.arange(5, dtype=np.int32), 8, deadline_s=1e-4)
    time.sleep(0.01)
    res = eng.run()
    assert len(res[u0]) == 8 and res[u1] == []    # u1 expired while queued
    c = eng.metrics_summary()["counters"]
    assert (c["retired_deadline"], c["retired_max_new"],
            c["requests_finished"]) == (1, 1, 2)
    eng = _port(tcfg, tp, n_slots=1, max_len=64, page_size=4)
    uid = eng.submit(np.arange(4, dtype=np.int32), 40, deadline_s=1e-4)
    eng.step()
    time.sleep(0.01)
    assert 1 <= len(eng.run()[uid]) < 40           # expired mid-decode
    assert eng.metrics_summary()["counters"]["retired_deadline"] == 1
    assert eng.pages.free_pages == eng.pages.n_pages - 1


def test_cancel_queued_and_active():
    _, _, tcfg, tp = _model()
    eng = _port(tcfg, tp, n_slots=1, max_len=32)
    u0 = eng.submit(np.arange(4, dtype=np.int32), 8)
    u1 = eng.submit(np.arange(6, dtype=np.int32), 8)
    assert eng.cancel(u1)                          # queued: never ran
    assert eng.finished[-1].retire_reason is RetireReason.CANCELLED
    assert eng.cancel(u0)                          # active: slot released
    assert not eng.cancel(u0) and not eng.cancel(999)
    res = eng.run()
    assert res[u1] == [] and len(res[u0]) >= 1
    assert eng.metrics_summary()["counters"]["retired_cancelled"] == 2
    assert eng.slots.free_slots == 1 and not eng.queue


def test_run_drain_deadline_raises():
    _, _, tcfg, tp = _model()
    eng = _port(tcfg, tp, n_slots=1, max_len=32)
    uid = eng.submit(np.arange(4, dtype=np.int32), 6)
    with pytest.raises(DeadlineExceeded):
        eng.run(deadline_s=0.0)
    assert len(eng.run()[uid]) == 6                # the engine is intact


# -- NaN guard and the demotion ladder ----------------------------------------


@pytest.fixture
def clean_routes(monkeypatch):
    for var in ("REPRO_KERNEL_QUANT", "REPRO_KERNEL_FF", "REPRO_KERNEL_ATTN"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("page_size", [None, 4])
def test_transient_nan_costs_one_retry_and_no_tokens(page_size,
                                                     clean_routes):
    """Non-finite logits on one step: the step reruns on the same route
    over the same cache rows, so the tokens equal a clean run's (the write
    index does not advance twice) and nothing demotes."""
    _, _, tcfg, tp = _model()
    prompts = _prompts(tcfg.vocab_size, seed=4, lengths=(6, 5))
    kw = dict(n_slots=2, max_len=32, page_size=page_size)
    want = _drive(_port(tcfg, tp, **kw), prompts, [6, 6])
    eng = _port(tcfg, tp, **kw)
    real, calls = eng._batch_step, []

    def flaky(*args):
        tok, bad = real(*args)
        calls.append(1)
        return tok, (bad | True) if len(calls) == 2 else bad

    eng._batch_step = flaky
    assert _drive(eng, prompts, [6, 6]) == want
    c = eng.metrics_summary()["counters"]
    assert c["nan_steps"] == 1 and "demotions" not in c
    assert eng.demoted == []


def test_nan_weights_walk_the_ladder_to_faulted(clean_routes):
    """NaN weights defeat the retry and the ladder: the ``quant`` rung is
    passed without a retry (these params carry no sidecars), the ff
    forward goes fused -> split, and the decoding lanes retire FAULTED
    with their prefill token only; the demotion shows in the metrics, the
    process environment is untouched, and ``reset_demotions`` clears it.
    The reference's ``attn`` rung is not taken (ROADMAP C.5)."""
    _, _, tcfg, tp = _model()
    bad = dict(tp, final_norm={k: torch.full_like(v, float("nan"))
                               for k, v in tp["final_norm"].items()})
    eng = _port(tcfg, bad, n_slots=2, max_len=32, page_size=4)
    uids = [eng.submit(q, 6) for q in _prompts(256, lengths=(5, 4))]
    res = eng.run()
    c = eng.metrics_summary()["counters"]
    assert c["retired_faulted"] == 2
    assert all(len(res[u]) == 1 for u in uids)
    assert eng.demoted == ["quant", "ff"]
    assert c["demotions"] == 1 and c["nan_steps"] == 3
    assert eng.metrics_summary()["demoted"] == ["quant", "ff"]
    assert not any(v in os.environ for v in ("REPRO_KERNEL_FF",
                                             "REPRO_KERNEL_ATTN",
                                             "REPRO_KERNEL_QUANT"))
    eng.reset_demotions()
    assert eng.demoted == []
    assert eng.pages.free_pages == eng.pages.n_pages - 1


def test_ff_demotion_stays_with_its_engine(clean_routes, monkeypatch):
    """A demoted engine runs its ff split while another engine in the same
    process stays on the fused route and serves the tokens it served
    before; ``REPRO_KERNEL_FF=split`` already set leaves nothing to
    demote.  The ``quant`` rung, passed without a retry (no sidecars),
    comes first in ``demoted``."""
    from repro_torch.kernels import ops as kops

    _, _, tcfg, tp = _model()
    prompts = _prompts(tcfg.vocab_size, seed=4, lengths=(6, 5))
    want = _drive(_port(tcfg, tp, n_slots=2, max_len=32), prompts, [5, 5])
    real, routes = kops.ff_route, []
    monkeypatch.setattr(kops, "ff_route",
                        lambda: routes.append(real()) or routes[-1])
    bad = dict(tp, final_norm={k: torch.full_like(v, float("nan"))
                               for k, v in tp["final_norm"].items()})
    eng = _port(tcfg, bad, n_slots=2, max_len=32)
    _drive(eng, prompts, [5, 5])
    assert eng.demoted == ["quant", "ff"] and routes[-1] == "split"
    routes.clear()
    assert _drive(_port(tcfg, tp, n_slots=2, max_len=32), prompts,
                  [5, 5]) == want
    assert routes and set(routes) == {"fused"}
    monkeypatch.setenv("REPRO_KERNEL_FF", "split")
    eng = _port(tcfg, bad, n_slots=2, max_len=32)
    _drive(eng, prompts, [5, 5])
    c = eng.metrics_summary()["counters"]
    assert eng.demoted == ["quant", "ff"] and "demotions" not in c
    assert c["nan_steps"] == 2 and c["retired_faulted"] == 2


# -- construction, escape hatch, launcher -------------------------------------


def test_paged_escape_hatch_and_family_checks(monkeypatch):
    _, _, tcfg, tp = _model()
    monkeypatch.setenv("REPRO_PAGED_KV", "off")
    eng = _port(tcfg, tp, n_slots=2, max_len=16, page_size=4)
    assert not eng.paged and "block_table" not in eng.cache[0]["kv"]
    monkeypatch.delenv("REPRO_PAGED_KV")
    with pytest.raises(NotImplementedError, match="pure-KV"):
        _port(tcfg.replace(family="ssm"), tp, n_slots=2, max_len=16,
              page_size=4)
    with pytest.raises(NotImplementedError, match="token-only"):
        _port(tcfg.replace(family="encdec"), tp, n_slots=2, max_len=16)
    if not torch.cuda.is_available():
        # the engine runs on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ContinuousBatchingEngine(tcfg, tp, n_slots=2, max_len=16)


def test_every_layer_shares_one_block_table_and_index():
    """The host refreshes block tables and write indices with one copy:
    all layers hold views of the engine's one control buffer."""
    _, _, tcfg, tp = _model()
    eng = _port(tcfg, tp, n_slots=3, max_len=16, page_size=4)
    kvs = [lc["kv"] for lc in eng.cache]
    assert all(kv["block_table"].data_ptr() == kvs[0]["block_table"]
               .data_ptr() and kv["idx"].data_ptr() == kvs[0]["idx"]
               .data_ptr() for kv in kvs)
    assert kvs[0]["idx"].untyped_storage().data_ptr() == \
        eng._ctl.untyped_storage().data_ptr()
    assert kvs[0]["block_table"].shape == (3, 4)
    assert kvs[0]["pages_k"].dtype == torch.float32       # cache_dtype


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


@pytest.mark.parametrize("extra", [[], ["--quant-kv", "int8"]])
def test_launcher_continuous_paged_cpu(extra, tmp_path):
    out = tmp_path / "m.json"
    r = _launch("--arch", "qwen3_0_6b", "--smoke", "--engine", "continuous",
                "--page-size", "16", "--prefill-chunk", "32",
                "--prefix-cache", "--requests", "6", "--slots", "4",
                "--new-tokens", "8", "--device", "cpu", "--metrics-json",
                str(out), *extra)
    assert r.returncode == 0, r.stderr
    assert "continuous: 6 requests over 4 slots, 48 tokens" in r.stdout
    assert "[serve] paged: {'prefill_chunks'" in r.stdout
    assert ("kv_quant=int8" in r.stdout) == bool(extra)
    assert "reqs=6 tok=48" in r.stdout and "demoted=[]" in r.stdout
    assert json.loads(out.read_text())["demoted"] == []


def test_launcher_quant_kv_needs_the_paged_engine():
    r = _launch("--arch", "qwen3_0_6b", "--smoke", "--quant-kv", "int8",
                "--device", "cpu")
    assert r.returncode != 0 and "--quant-kv requires" in r.stderr
