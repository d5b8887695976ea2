"""Port parity for observability: ``repro_torch.obs`` (the tracer, route
events, the training report line) and ``repro_torch.perf.timeline``
against ``repro.obs`` and ``repro.perf.timeline``, and the spans the
port's engines and trainer record against the JAX package's on the same
weights and requests.

Span names are compared as multisets over the categories ``serve`` and
``train``; the ``route`` instants are left out, because JAX records a
routing decision once per trace and the port once per call."""
import collections
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.checkpoint.manager import flatten_with_paths  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.perf import timeline as jtimeline  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JCEngine  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import init_train_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import faults, obs  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.optim import AdamW, schedule  # noqa: E402
from repro_torch.perf import timeline  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      Engine)
from repro_torch.train import (Trainer, init_train_state,  # noqa: E402
                               make_train_step)

SPAN_CATS = ("serve", "train")
_MODELS = {}


@pytest.fixture(autouse=True)
def _quiet():
    """Tracing off and no fault schedule before and after each test, in
    both packages: the rest of the suite runs with both off."""
    for mod in (obs, jobs):
        mod.disable()
    faults.reset()
    yield
    for mod in (obs, jobs):
        mod.disable()
    faults.reset()


def _model():
    """(jax cfg, jax params, port cfg, port params): Qwen3-0.6B's smoke
    config (fp32, its einsum DYAD ff) on the same weights, the ff weights
    x 4 so that greedy tokens vary."""
    if not _MODELS:
        jcfg = jconfigs.get("qwen3_0_6b", smoke=True)
        tcfg = tconfigs.get("qwen3_0_6b", smoke=True)
        tree = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in flatten_with_paths(tree).items()}
        for k in flat:
            if k.startswith("layers/mlp/") and k.endswith(("/w1", "/w2")):
                flat[k] = flat[k] * np.float32(4.0)
        jp = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tree),
            [jnp.asarray(flat[k]) for k in flatten_with_paths(tree)])
        _MODELS["qwen3"] = (jcfg, jp, tcfg, bridge.from_flat(flat, "cpu"))
    return _MODELS["qwen3"]


def _prompts(vocab, lengths=(5, 9, 3, 12, 7), seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _span_names(doc):
    return collections.Counter(e["name"] for e in doc["traceEvents"]
                               if e["cat"] in SPAN_CATS)


def _traced(mod, run):
    """Run ``run()`` under a fresh tracer of ``mod`` (``obs`` or
    ``jobs``); returns its Chrome-trace document."""
    mod.disable()
    t = mod.enable()
    try:
        run()
    finally:
        mod.disable()
    return t.to_chrome_trace()


# -- the tracer --------------------------------------------------------------


def _spans_and_instant(mod):
    with mod.span("outer", cat="test", batch=4):
        time.sleep(0.002)
        with mod.span("inner", cat="test", arr=np.arange(3)) as sp:
            sp.set(result=7)
            time.sleep(0.002)
        time.sleep(0.002)
    mod.instant("marker", cat="test", reason="x")


def test_trace_export_roundtrip_and_nesting(tmp_path):
    """Both tracers export the same events (names, phases, categories,
    args) as Chrome-trace JSON; the child span lies inside its parent."""
    docs = {}
    for name, mod in (("port", obs), ("jax", jobs)):
        mod.enable()
        _spans_and_instant(mod)
        path = str(tmp_path / f"{name}.json")
        assert mod.export(path) == path
        mod.disable()
        docs[name] = json.load(open(path))

    def shape(doc):
        return [(e["name"], e["ph"], e["cat"], e.get("s"), e.get("args"))
                for e in doc["traceEvents"]]

    assert shape(docs["port"]) == shape(docs["jax"])
    doc = docs["port"]
    assert doc["displayTimeUnit"] == "ms"
    ev = {e["name"]: e for e in doc["traceEvents"]}
    outer, inner = ev["outer"], ev["inner"]
    assert inner["ts"] >= outer["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert inner["args"]["result"] == 7
    assert isinstance(inner["args"]["arr"], str)
    assert ev["marker"]["ph"] == "i" and ev["marker"]["s"] == "t"


def test_trace_ring_buffer_bounded():
    """The ring keeps the newest events and counts the dropped ones, as
    the reference's does."""
    got = []
    for cls in (Tracer, jobs.Tracer):
        t = cls(capacity=10)
        for i in range(25):
            t.instant(f"e{i}")
        got.append((len(t), t.dropped, [e["name"] for e in
                                         t.to_chrome_trace()["traceEvents"]]))
    assert got[0] == got[1]
    assert got[0] == (10, 15, [f"e{i}" for i in range(15, 25)])


def test_disabled_tracer_is_shared_noop_and_cheap():
    """Tracing off: ``span`` returns the one shared null span (no
    allocation, no clock read), ``instant`` and ``export`` do nothing."""
    assert not obs.enabled()
    s1 = obs.span("a", cat="serve", batch=4)
    assert s1 is obs.span("b") is obs.trace._NULL_SPAN
    with s1 as s:
        s.set(anything=1)
    obs.instant("nothing")
    assert obs.export("never_written.json") is None
    t0 = time.perf_counter()
    for _ in range(100_000):
        with obs.span("hot", batch=1):
            pass
    dt = time.perf_counter() - t0
    assert dt < 1.0, f"disabled span too slow: {dt:.3f}s / 100k"


@pytest.mark.parametrize("env,tracing", [
    ("0", True), ("1", False), ("1", True), (None, True), (None, False),
    ("off", True), ("yes", False)])
def test_verbose_gate(env, tracing, monkeypatch):
    """``verbose()`` follows ``REPRO_OBS_VERBOSE`` first, then the tracer,
    in both packages."""
    if env is None:
        monkeypatch.delenv("REPRO_OBS_VERBOSE", raising=False)
    else:
        monkeypatch.setenv("REPRO_OBS_VERBOSE", env)
    got = []
    for mod in (obs, jobs):
        if tracing:
            mod.enable()
        got.append(mod.verbose())
        mod.disable()
    assert got[0] == got[1]
    assert got[0] == (env in ("1", "yes") or (env is None and tracing))


# -- route events ------------------------------------------------------------


EVENTS = [("ff", "fused", {}), ("ff", "fused", {"forced": False}),
          ("attn", "xla", {"forced": False}), ("kernel_bwd", "xla", {}),
          ("ff_quant", "int8", {}), ("demote", "ff", {})]


@pytest.mark.parametrize("tracing", [False, True])
def test_route_counts_and_snapshot_match_the_reference(tracing):
    """The same route events give the same counters, ``routes_snapshot``
    keys and (while tracing) the same ``route:op=route`` instants."""
    got = []
    for mod in (obs, jobs):
        mod.reset_route_counts()
        if tracing:
            mod.enable()
        for op, route, kw in EVENTS:
            mod.route_event(op, route, **kw)
        t = mod.disable()
        names = ([e["name"] for e in t.to_chrome_trace()["traceEvents"]]
                 if t else [])
        got.append((mod.route_counts(), mod.routes_snapshot(), names))
        mod.reset_route_counts()
        assert mod.route_counts() == {}
    assert got[0] == got[1]
    assert got[0][1] == {"attn:xla": 1, "demote:ff": 1, "ff:fused": 2,
                         "ff_quant:int8": 1, "kernel_bwd:xla": 1}
    assert (got[0][2].count("route:ff=fused") == 2) == tracing


def test_engine_records_attn_route():
    """A generate records the attention routing decision, once per layer
    and call in the port (the reference records it once per trace)."""
    _, _, tcfg, tp = _model()
    obs.reset_route_counts()
    Engine(tcfg, tp, max_len=16, device="cpu").generate(
        torch.zeros((1, 4), dtype=torch.long), 3)
    counts = obs.route_counts()
    # prefill and two decode steps over 2 layers
    assert counts == {("attn", "xla"): 3 * tcfg.n_layers}
    obs.reset_route_counts()


def test_training_line_matches_the_reference():
    """``format_training_line`` over the same observations reads as the
    reference's."""
    lines = []
    for mod in (obs, jobs):
        m = mod.MetricsRegistry()
        for dt in (0.012, 0.010, 0.011):
            m.histogram("step_time_s").observe(dt)
        m.gauge("tokens_per_s").set(12345.6)
        lines.append((mod.format_training_line(m, 3, loss=5.4321),
                      mod.format_training_line(m, 4, extra="x=1")))
    assert lines[0] == lines[1]
    assert lines[0][0] == "step 3 loss=5.4321 tok/s=12346 step_ms p50=11"


# -- timeline ----------------------------------------------------------------


def _trace_doc(spans):
    """Chrome-trace doc from [(name, ts_us, dur_us), ...]."""
    return {"traceEvents": [
        {"name": n, "cat": "t", "ph": "X", "pid": 1, "tid": 1,
         "ts": ts, "dur": dur} for n, ts, dur in spans]
        + [{"name": "mark", "cat": "t", "ph": "i", "pid": 1, "tid": 1,
            "ts": 5}]}


PAIRS = {
    "slowdown": (
        _trace_doc([("decode_step", i * 100, 80) for i in range(10)]
                   + [("prefill", 0, 500), ("sync", 0, 40)]),
        _trace_doc([("decode_step", i * 100, 800) for i in range(10)]
                   + [("prefill", 0, 500), ("sync", 0, 40)])),
    "self": (_trace_doc([("x", 0, 100), ("y", 100, 300)]),
             _trace_doc([("x", 0, 100), ("y", 100, 300)])),
    "new_removed_faster": (
        _trace_doc([("a", 0, 1000), ("b", 0, 70), ("gone", 0, 90)]),
        _trace_doc([("a", 0, 200), ("b", 0, 75), ("b", 0, 75),
                    ("new", 0, 3000)])),
    "bench_vs_trace": (
        {"suite": "smoke", "results": [
            {"name": "ff dense", "us_per_call": 120.0},
            {"name": "ff dyad", "us_per_call": 60.0}, {"name": "no time"}]},
        _trace_doc([("ff dyad", 0, 150), ("ff dense", 0, 118)])),
}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_timeline_rows_match_the_reference(case, tmp_path, capsys):
    """On the same two documents the port's diff gives the reference's
    rows, table, verdict, exit code and JSON report."""
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    json.dump(PAIRS[case][0], open(a, "w"))
    json.dump(PAIRS[case][1], open(b, "w"))
    got = []
    for mod in (timeline, jtimeline):
        rows = mod.diff_timelines(mod.load_timeline(a), mod.load_timeline(b))
        table = [(r.name, r.base and (r.base.count, r.base.total_us),
                  r.cur and (r.cur.count, r.cur.total_us), r.delta_total_us,
                  r.mean_ratio, r.status) for r in rows]
        out = str(tmp_path / f"{mod.__name__}.json")
        rc = mod.main([a, b, "--fail-on-regress", "--json", out])
        text = capsys.readouterr().out
        got.append((table, mod.format_diff(rows),
                    [r.name for r in mod.attribute(rows)], rc, text,
                    json.load(open(out))))
    assert got[0] == got[1]
    if case == "slowdown":
        assert got[0][2] == ["decode_step"] and got[0][3] == 1
        assert "REGRESSION localized to span 'decode_step'" in got[0][4]
    if case == "self":
        assert got[0][3] == 0 and "no span regressed" in got[0][4]


def test_timeline_rejects_other_documents(tmp_path):
    q = str(tmp_path / "junk.json")
    json.dump({"nope": 1}, open(q, "w"))
    with pytest.raises(ValueError):
        timeline.load_timeline(q)


# -- spans of the engines and the trainer against the reference ---------------


def _drive(eng, prompts, max_new):
    uids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    res = eng.run()
    return [[int(t) for t in res[u]] for u in uids]


MODES = {"dense": dict(),
         "paged": dict(page_size=4, prefill_chunk=3, prefix_cache=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_continuous_engine_spans_match_the_reference(mode):
    """Five requests over three slots, on the same weights and prompts:
    the same tokens, and the same multiset of ``serve`` spans, but for the
    dense mode's ``sync_control`` push, one per decode step, which the
    reference's dense engine has no twin of (ROADMAP C.10)."""
    jcfg, jp, tcfg, tp = _model()
    prompts = _prompts(jcfg.vocab_size, lengths=(9, 13, 10, 12, 11))
    prompts = [np.concatenate([prompts[0][:8], p]) for p in prompts]
    max_new = [11, 4, 7, 3, 5]
    kw = dict(n_slots=3, max_len=32, **MODES[mode])
    toks = {}
    eng = ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    port = _traced(obs, lambda: toks.update(
        port=_drive(eng, prompts, max_new)))
    jeng = JCEngine(jcfg, jp, cache_dtype=jnp.float32, **kw)
    ref = _traced(jobs, lambda: toks.update(
        jax=_drive(jeng, prompts, max_new)))
    assert toks["port"] == toks["jax"]
    want = _span_names(ref)
    if mode == "dense":
        want["sync_control"] += eng.metrics.histogram("decode_step_s").count
    assert _span_names(port) == want
    assert want["decode_step"] > 0 and want["retire"] == len(prompts)


def test_batch_engine_spans_and_metrics_match_the_reference():
    """``Engine.generate``: one ``prefill`` and one ``decode_loop`` span a
    call with more than one new token, and the reference's metrics."""
    jcfg, jp, tcfg, tp = _model()
    prompts = np.stack(_prompts(jcfg.vocab_size, lengths=(4, 4)))
    eng = Engine(tcfg, tp, max_len=16, device="cpu")
    jeng = JEngine(jcfg, jp, max_len=16, cache_dtype=jnp.float32)

    def run(e, p):
        return lambda: [e.generate(p, n) for n in (6, 1)]

    port = _traced(obs, run(eng, torch.as_tensor(prompts)))
    ref = _traced(jobs, run(jeng, jnp.asarray(prompts)))
    assert _span_names(port) == _span_names(ref) == {"prefill": 2,
                                                     "decode_loop": 1}
    snap, jsnap = eng.metrics.snapshot(), jeng.metrics.snapshot()
    assert snap["counters"] == jsnap["counters"] == {
        "requests_finished": 4, "tokens_generated": 14}
    for h in ("ttft_s", "itl_s"):
        assert (snap["histograms"][h]["count"]
                == jsnap["histograms"][h]["count"])


def _trainers(tmp_path):
    """(port trainer, reference trainer) on OPT-125m's smoke config,
    checkpointing every 2 steps into their own directories."""
    tcfg = tconfigs.get("opt125m", smoke=True)
    jcfg = jconfigs.get("opt125m", smoke=True)
    kw = dict(ckpt_every=2, log_every=100, log_fn=lambda *a: None)
    opt = AdamW(lr=schedule.constant(1e-3))
    port = Trainer(make_train_step(tcfg, opt), init_train_state(
        tcfg, opt, torch.Generator().manual_seed(0), device="cpu"),
        SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=8, global_batch=2,
                    seed=0, device="cpu"),
        ckpt_dir=str(tmp_path / "port"), **kw)
    jopt = JAdamW(lr=jschedule.constant(1e-3))
    ref = JTrainer(jax.jit(jmake_step(jcfg, jopt)),
                   jinit_state(jcfg, jopt, jax.random.PRNGKey(0)),
                   JSyntheticLM(vocab_size=jcfg.vocab_size, seq_len=8,
                                global_batch=2, seed=0),
                   ckpt_dir=str(tmp_path / "jax"), **kw)
    return port, ref


def test_trainer_spans_match_the_reference(tmp_path):
    """Three steps, then a resumed trainer's fourth: ``train_step`` per
    step, ``checkpoint`` at steps 2 and 4 and at each run's end,
    ``resume`` once; the same multiset of ``train`` spans in both
    packages."""
    docs = []
    for n in (3, 4):
        port, ref = _trainers(tmp_path)
        docs.append((_traced(obs, lambda: port.run(n)),
                     _traced(jobs, lambda: ref.run(n))))
        assert port.step == ref.step == n
    for port_doc, ref_doc in docs:
        assert _span_names(port_doc) == _span_names(ref_doc)
    assert _span_names(docs[0][0]) == {"train_step": 3, "checkpoint": 2}
    assert _span_names(docs[1][0]) == {"resume": 1, "train_step": 1,
                                       "checkpoint": 2}


def test_checkpoint_spans_keep_the_writer_thread(tmp_path):
    """The async checkpoint writer records its ``ckpt_retry`` instants
    from its own thread, and the export keeps each thread's id."""
    from repro_torch.checkpoint.manager import CheckpointManager

    faults.configure("ckpt_io:at_step=0")
    mgr = CheckpointManager(str(tmp_path), async_save=True, retries=2,
                            backoff_s=0.001)

    def save():
        with obs.span("checkpoint", cat="train", step=1):
            mgr.save(1, {"w": torch.ones(3)})
        mgr.wait()

    doc = _traced(obs, save)
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert ev["ckpt_retry"]["tid"] != ev["checkpoint"]["tid"]
    assert mgr.latest_step() == 1
