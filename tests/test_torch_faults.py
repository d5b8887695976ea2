"""Port parity for fault injection: ``repro_torch.faults`` against
``repro.faults`` (schedule syntax, per-site streams, the checks that
fire), the chaos drive of the paged engines of both packages on the same
weights, and the port's resilience paths driven by the fault sites: the
NaN ladder under ``kernel_nan``, checkpoint retries under ``ckpt_io``, the
trainer's skip-step under ``nan_loss`` and its watchdog under
``slow_step``."""
import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JCEngine  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import faults, obs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.errors import CheckpointIOError  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve.engine import ContinuousBatchingEngine  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from test_torch_obs import _model, _prompts, _traced  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_faults():
    """Every test starts and ends with no schedule in either package."""
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    obs.disable()


# -- schedules and streams ---------------------------------------------------


@pytest.mark.parametrize("spec", [
    "page_exhaustion:p=0.05;nan_logits:at_step=3;slow_step:ms=50;"
    "kernel_nan:route=ff_fused,times=2",
    " ckpt_io ; nan_loss:at_step=0,times=3 ;",
    "", "slow_step:p=1.0,ms=0.5"])
def test_parse_matches_the_reference(spec):
    got = {k: dataclasses.asdict(v) for k, v in faults.parse(spec).items()}
    want = {k: dataclasses.asdict(v) for k, v in jfaults.parse(spec).items()}
    assert got == want


@pytest.mark.parametrize("spec", [
    "slow_step:bogus=1", "a:p=0.1;a:p=0.2", "a:p=0.5,at_step=2",
    "a:p=1.5"])
def test_parse_errors_match_the_reference(spec):
    for mod in (faults, jfaults):
        with pytest.raises(ValueError):
            mod.parse(spec)


def _fires(mod, spec, seed, checks):
    """The checks of ``checks`` ([(site, route)]) at which ``spec`` fires
    in ``mod``'s registry, and its tallies."""
    reg = mod.FaultRegistry(mod.parse(spec), seed=seed)
    fired = [i for i, (site, route) in enumerate(checks)
             if reg.check(site, route=route) is not None]
    return fired, reg.snapshot()


SCHEDULES = [
    ("page_exhaustion:p=0.2;nan_logits:at_step=3", 0),
    ("page_exhaustion:p=0.2;nan_logits:at_step=3", 9001),
    ("ckpt_io:p=0.3;nan_loss:at_step=5;slow_step:p=0.5,times=4", 7),
    ("kernel_nan:route=ff_fused,p=0.4;slow_step:ms=5", 123),
    ("kernel_nan:route=attn_flash,at_step=2,times=1", 3),
]


@pytest.mark.parametrize("spec,seed", SCHEDULES)
def test_registry_fires_where_the_reference_fires(spec, seed):
    """A random interleaving of checks at every site (routes included)
    fires at exactly the same checks in both registries."""
    rng = np.random.default_rng(seed)
    sites = ["page_exhaustion", "nan_logits", "ckpt_io", "nan_loss",
             "slow_step", "kernel_nan", "other"]
    routes = [None, "ff_fused", "ff_split", "attn_flash", "ff_quant"]
    checks = [(sites[rng.integers(len(sites))],
               routes[rng.integers(len(routes))]) for _ in range(400)]
    got = _fires(faults, spec, seed, checks)
    assert got == _fires(jfaults, spec, seed, checks)
    assert got[0], "the schedule never fired: the comparison is blind"


def test_streams_are_order_independent():
    """A site's firing sequence does not depend on other sites' checks."""
    spec = "a:p=0.5;b:p=0.5"
    alone = faults.FaultRegistry(faults.parse(spec), seed=3)
    seq_a = [alone.check("a") is not None for _ in range(50)]
    mixed = faults.FaultRegistry(faults.parse(spec), seed=3)
    seq_mixed = []
    for _ in range(50):
        mixed.check("b")
        seq_mixed.append(mixed.check("a") is not None)
        mixed.check("b")
    assert seq_a == seq_mixed


def test_at_step_and_times():
    reg = faults.FaultRegistry(faults.parse("x:at_step=2;y:times=2"))
    assert [reg.check("x") is not None for _ in range(5)] == [
        False, False, True, False, False]
    assert [reg.check("y") is not None for _ in range(4)] == [
        True, True, False, False]
    assert reg.snapshot() == {"x": {"checks": 5, "fired": 1},
                              "y": {"checks": 4, "fired": 2}}


def test_route_mismatch_consumes_nothing():
    reg = faults.FaultRegistry(faults.parse("kernel_nan:route=ff_fused,"
                                            "at_step=1"))
    assert reg.check("kernel_nan", route="ff_split") is None
    assert reg.check("kernel_nan", route=None) is None
    assert reg.snapshot()["kernel_nan"]["checks"] == 0
    assert reg.check("kernel_nan", route="ff_fused") is None
    assert reg.check("kernel_nan", route="ff_fused") is not None


def test_env_configure_and_one_load_fast_path(monkeypatch):
    """``REPRO_FAULT`` is read once, at the first check; ``configure``
    wins over it; after the first call ``active`` reads one global."""
    monkeypatch.setenv(faults.ENV_VAR, "slow_step:ms=5")
    monkeypatch.setenv(faults.ENV_SEED, "4")
    assert faults._ACTIVE is None
    assert faults.active() and faults.registry().seed == 4
    assert faults.fire("slow_step").ms == 5.0
    monkeypatch.setattr(faults, "_load_env", None)   # never called again
    assert faults.active()
    faults.configure(None)
    assert not faults.active() and faults.fire("slow_step") is None
    assert faults.snapshot() == {}
    faults.configure("slow_step:ms=9", seed=1)
    assert faults.snapshot() == {"slow_step": {"checks": 0, "fired": 0}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_poison_keeps_the_dtype_and_the_route_gate(dtype):
    x = torch.ones(3, dtype=dtype)
    assert faults.poison(x, "kernel_nan", route="ff_fused") is x
    faults.configure("kernel_nan:route=ff_fused")
    assert faults.poison(x, "kernel_nan", route="ff_split") is x
    y = faults.poison(x, "kernel_nan", route="ff_fused")
    assert y.dtype == dtype and torch.isnan(y).all()


# -- the chaos drive against the reference ------------------------------------


@pytest.mark.parametrize("seed,at", [(0, 0), (7, 2), (9001, 9)])
def test_chaos_drive_matches_the_reference(seed, at):
    """``page_exhaustion:p=0.2;nan_logits:at_step=k`` with the same seed
    on both packages' paged engines (fp32, the same weights and prompts):
    each request's tokens, the fault tallies and the engine counters
    agree, the pages balance and nothing demotes."""
    jcfg, jp, tcfg, tp = _model()
    prompts = _prompts(jcfg.vocab_size, lengths=(6, 5, 4, 6, 5, 4))
    spec = f"page_exhaustion:p=0.2;nan_logits:at_step={at}"
    kw = dict(n_slots=3, max_len=24, page_size=4, n_pages=25,
              prefill_chunk=4, prefix_cache=True)
    out = {}
    for name, mod, make in (
            ("port", faults, lambda: ContinuousBatchingEngine(
                tcfg, tp, device="cpu", **kw)),
            ("jax", jfaults, lambda: JCEngine(
                jcfg, jp, cache_dtype=jnp.float32, **kw))):
        mod.configure(spec, seed=seed)
        eng = make()
        uids = [eng.submit(q, 5) for q in prompts]
        res = eng.run()
        snap = eng.metrics_summary()
        out[name] = ([[int(t) for t in res[u]] for u in uids],
                     snap["faults"], snap["counters"])
        assert eng.pages.free_pages == eng.pages.n_pages - 1
        assert (eng.pages.refcount == 0).all()
        assert eng._prefix == {} and eng._page_hash == {}
        assert eng.demoted == []
        assert not eng.queue and not eng.slots.active
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1]["nan_logits"]["fired"] == 1
    assert out["port"][1]["page_exhaustion"]["fired"] > 0
    assert out["port"][2] == out["jax"][2]


# -- the NaN ladder under kernel_nan ------------------------------------------


def _ffused():
    cfg = tconfigs.get("qwen3_0_6b", smoke=True,
                       linear=tconfigs.linear_cfg("dyad_it_4_kernel_ffused"))
    return cfg, tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")


@pytest.mark.parametrize("route", ["ff_quant", "ff_fused", "attn_flash"])
def test_kernel_nan_walks_the_ladder(route, monkeypatch):
    """A broken kernel on one route: the first request's cache is
    poisoned beyond recovery, so it walks the whole ladder (``quant``,
    then ``ff``) and retires ``FAULTED``, the environment untouched.
    ``ff_quant`` (int8 sidecars): the ``quant`` rung took this engine to
    the fp weights, and the next request comes back clean; ``ff_fused``:
    ``quant`` is passed (no sidecars), the ``ff`` rung split the ff
    forward, and the next request comes back clean; ``attn_flash`` (the
    flash route forced on the CPU): the port has no ``attn`` rung
    (ROADMAP C.5), so the next request retires ``FAULTED`` too."""
    from repro_torch import quant

    for var in ("REPRO_KERNEL_QUANT", "REPRO_KERNEL_FF", "REPRO_KERNEL_ATTN"):
        monkeypatch.delenv(var, raising=False)
    if route == "attn_flash":
        monkeypatch.setenv("REPRO_KERNEL_ATTN", "flash")
    cfg, p = _ffused()
    if route == "ff_quant":
        cfg = cfg.replace(linear=cfg.linear.replace(quant="int8"))
        p = quant.quantize_params(p, "int8")
    faults.configure(f"kernel_nan:route={route}")
    eng = ContinuousBatchingEngine(cfg, p, n_slots=1, max_len=32,
                                   device="cpu")
    obs.reset_route_counts()
    eng.submit(np.arange(5, dtype=np.int32), 4)
    eng.run()
    c = eng.metrics_summary()["counters"]
    assert c["retired_faulted"] == 1
    assert eng.demoted == ["quant", "ff"]
    assert os.environ.get("REPRO_KERNEL_FF") is None
    assert os.environ.get("REPRO_KERNEL_QUANT") is None
    u1 = eng.submit(np.arange(5, dtype=np.int32), 4)
    res = eng.run()
    c = eng.metrics_summary()["counters"]
    routes = obs.routes_snapshot()
    if route == "attn_flash":
        assert c["retired_faulted"] == 2
        assert "demote:ff" in routes and routes["attn:flash"] > 0
    else:
        assert len(res[u1]) == 4
        assert c["retired_faulted"] == 1 and c["retired_max_new"] == 1
        rung, safe = (("quant", "ff_quant:off") if route == "ff_quant"
                      else ("ff", "ff:split"))
        assert routes[f"demote:{rung}"] == 1 and routes[safe] > 0
    eng.reset_demotions()
    assert eng.demoted == []


def test_paged_pool_keeps_a_faulted_requests_nan_rows():
    """ROADMAP C.11, a fault the port shares with the reference: a request
    that retires ``FAULTED`` returns pages holding its NaN K/V rows, and a
    later request that takes those pages reads the stale rows through its
    masked keys (a zero weight times NaN), so it faults too, even on the
    demoted route.  Dense rings rewrite a slot's whole row at admission and
    do not carry it (``test_kernel_nan_walks_the_ladder``)."""
    cfg, p = _ffused()
    faults.configure("kernel_nan:route=ff_fused")
    eng = ContinuousBatchingEngine(cfg, p, n_slots=1, max_len=32,
                                   page_size=4, prefill_chunk=4,
                                   device="cpu")
    eng.submit(np.arange(5, dtype=np.int32), 4)
    eng.run()
    assert eng.demoted == ["quant", "ff"]
    uids = [eng.submit(np.arange(3, 9, dtype=np.int32), 4)
            for _ in range(2)]
    res = eng.run()
    c = eng.metrics_summary()["counters"]
    assert c["retired_faulted"] == 3 and all(len(res[u]) == 1 for u in uids)
    assert faults.snapshot()["kernel_nan"]["fired"] > 0
    assert eng.pages.free_pages == eng.pages.n_pages - 1


# -- checkpoints under ckpt_io ------------------------------------------------


def _tiny_state():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}


def test_ckpt_retry_absorbs_a_transient_fault(tmp_path):
    """The first attempt fails, the retry draws again and writes; one
    ``ckpt_retry`` instant marks the failed attempt."""
    faults.configure("ckpt_io:at_step=0")
    mgr = CheckpointManager(str(tmp_path), async_save=False, retries=2,
                            backoff_s=0.001)
    doc = _traced(obs, lambda: mgr.save(7, _tiny_state()))
    assert mgr.latest_step() == 7
    _, tree = mgr.restore(_tiny_state())
    assert torch.equal(tree["w"], _tiny_state()["w"])
    assert faults.snapshot()["ckpt_io"] == {"checks": 2, "fired": 1}
    retries = [e for e in doc["traceEvents"] if e["name"] == "ckpt_retry"]
    assert len(retries) == 1 and retries[0]["args"]["attempt"] == 0


@pytest.mark.parametrize("async_save", [False, True])
def test_ckpt_retry_budget_exhausted_raises(async_save, tmp_path):
    """Every attempt fails: the save raises (an async one at ``wait``),
    nothing is half-written, and the manager stays usable."""
    faults.configure("ckpt_io")
    mgr = CheckpointManager(str(tmp_path), async_save=async_save,
                            retries=2, backoff_s=0.001)
    with pytest.raises(CheckpointIOError):
        mgr.save(1, _tiny_state())
        mgr.wait()
    assert mgr.latest_step() is None
    assert faults.snapshot()["ckpt_io"] == {"checks": 3, "fired": 3}
    faults.configure(None)
    mgr.save(2, _tiny_state())
    mgr.wait()
    assert mgr.latest_step() == 2


# -- the trainer under nan_loss and slow_step ---------------------------------


class _Data:
    def __init__(self, kind):
        self.kind = kind

    def batch(self, step):
        tokens = np.zeros((2, 4), np.int32) + step
        return {"tokens": torch.as_tensor(tokens) if self.kind == "torch"
                else tokens}


def _fake_step(kind):
    """A train step of 20 ms on the host, with no model: the loss is NaN
    where the batch's ``_fault_poison`` is set, as the real step reports
    it."""
    def step(state, batch):
        time.sleep(0.02)
        bad = float(batch.get("_fault_poison", 0.0))
        loss = np.float32("nan") if bad else np.float32(1.0)
        if kind == "torch":
            loss = torch.tensor(loss)
        return state, {"loss": loss, "grad_norm": loss, "nonfinite":
                       np.float32(bad)}
    return step


def test_slow_step_is_seen_as_a_straggler():
    """``slow_step`` at step 9 sleeps inside the port's timed step, so its
    watchdog records a straggler there (and a ``straggler`` instant); the
    reference sleeps before its step clock starts, so its watchdog does
    not (ROADMAP C.9).  Both fire the site at the same check.  (A loaded
    host may stretch another step past 3x the median in either trainer:
    only step 9 is judged.)"""
    spec = "slow_step:at_step=9,ms=300"
    faults.configure(spec)
    port = Trainer(_fake_step("torch"), {}, _Data("torch"),
                   log_fn=lambda *a: None)
    doc = _traced(obs, lambda: port.run(12))
    jfaults.configure(spec)
    ref = JTrainer(_fake_step("jax"), {}, _Data("jax"),
                   log_fn=lambda *a: None)
    ref.run(12)
    assert 9 in [s for s, _, _ in port.straggler_events]
    assert 9 not in [s for s, _, _ in ref.straggler_events]
    assert faults.snapshot() == jfaults.snapshot() == {
        "slow_step": {"checks": 12, "fired": 1}}
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("train_step") == 12
    assert names.count("slow_step_fault") == 1
    assert 9 in [e["args"]["step"] for e in doc["traceEvents"]
                 if e["name"] == "straggler"]


def test_nan_loss_strike_is_skipped():
    """``nan_loss`` at check 1 poisons the second real step: the step
    skips the update (the params keep their bits), the trainer counts one
    strike and marks one ``nonfinite_step`` instant, and training goes
    on; the poison key rides every step while the site is armed."""
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamW, schedule
    from repro_torch.train import init_train_state, make_train_step

    cfg = tconfigs.get("opt125m", smoke=True)
    opt = AdamW(lr=schedule.constant(1e-3))
    port = Trainer(make_train_step(cfg, opt), init_train_state(
        cfg, opt, torch.Generator().manual_seed(0), device="cpu"),
        SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2,
                    seed=0, device="cpu"), log_fn=lambda *a: None)
    faults.configure("nan_loss:at_step=1")
    seen = []
    inner = port.train_step

    def step(state, batch):
        seen.append(batch["_fault_poison"])
        before = [t.clone() for t in state["params"]["layers"][0]["mlp"]
                  ["up"].values()]
        state, m = inner(state, batch)
        after = list(state["params"]["layers"][0]["mlp"]["up"].values())
        seen.append(all(torch.equal(a, b) for a, b in zip(before, after)))
        return state, m

    port.train_step = step
    doc = _traced(obs, lambda: port.run(3))
    assert seen == [0.0, False, 1.0, True, 0.0, False]
    assert port.metrics.snapshot()["counters"]["nonfinite_steps"] == 1
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("nonfinite_step") == 1
    params = [t for lp in port.state["params"]["layers"]
              for proj in lp["mlp"].values() for t in proj.values()]
    assert all(torch.isfinite(t).all() for t in params)


def test_launchers_write_trace_routes_and_faults(tmp_path, capsys):
    """The train launcher under ``--faults`` with ``--trace`` and
    ``--metrics-json``, then the serve launcher restoring its checkpoint
    (``--ckpt-dir``), in the reference's layout."""
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch

    ck, tj, tm = (str(tmp_path / n) for n in ("ck", "t.json", "tm.json"))
    train_launch.main(["--arch", "opt125m", "--smoke", "--device", "cpu",
                       "--steps", "4", "--batch", "2", "--seq-len", "8",
                       "--ckpt-dir", ck, "--ckpt-every", "2", "--faults",
                       "nan_loss:at_step=1;ckpt_io:at_step=0",
                       "--trace", tj, "--metrics-json", tm])
    doc = json.load(open(tm))
    assert doc["faults"] == {"ckpt_io": {"checks": 4, "fired": 1},
                             "nan_loss": {"checks": 4, "fired": 1}}
    names = [e["name"] for e in json.load(open(tj))["traceEvents"]]
    assert names.count("train_step") == 4 and "ckpt_retry" in names
    obs.disable()
    faults.reset()
    obs.reset_route_counts()
    sj, sm = str(tmp_path / "s.json"), str(tmp_path / "sm.json")
    serve_launch.main(["--arch", "opt125m", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4",
                       "--new-tokens", "3", "--ckpt-dir", ck,
                       "--faults", "slow_step:ms=1", "--trace", sj,
                       "--metrics-json", sm])
    out = capsys.readouterr().out
    assert "[serve] restored checkpoint step 4" in out
    doc = json.load(open(sm))
    assert doc["faults"] == {"slow_step": {"checks": 0, "fired": 0}}
    assert doc["routes"]["attn:xla"] > 0
    assert doc["counters"]["tokens_generated"] == 6
    names = [e["name"] for e in json.load(open(sj))["traceEvents"]]
    assert names.count("prefill") == 1 and names.count("decode_loop") == 1
