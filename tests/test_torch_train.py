"""Port parity for the training path: ``loss_fn`` and its gradients,
AdamW and the schedules, ``make_train_step`` (1 and 3 steps, Kahan
``grad_accum``, the skip-step, remat), ``SyntheticLM``, the ``Trainer``
(resume, rollback, preemption), checkpoints that cross between the two
packages, and the train launcher.  Params move between the packages
through ``repro_torch.checkpoint.bridge``; batches are the same numpy
arrays on both sides (the two data streams draw different random bits).

Tolerances, fp32 on the CPU:
- loss: 1e-5 relative;
- grads: 1e-5 x max(|reference leaf|, 1) x max(1, sqrt(L / 128)), with L
  the longest contraction behind a leaf (the batch's B*S tokens for the
  weight grads);
- AdamW moments: as the grads;
- params after AdamW: the first steps move each element by about ``lr``
  (m/sqrt(v) is about sign(g)), so an element whose grad lies within its
  rounding error of zero can move anywhere in [-lr, lr] on either side.
  Every element is held to 2 x lr per step, and all but 1 in 1000 to
  1e-3 x lr (1e-2 x lr with bf16 moments, which one side can round one
  bf16 ulp, 2^-8, away from the other), each plus 1e-6 x max|param|.
"""
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.checkpoint.manager import flatten_with_paths  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.optim.adamw import default_decay_mask as j_decay_mask  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.errors import NumericalFault  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import AdamW, default_decay_mask, schedule  # noqa: E402
from repro_torch.train import Trainer, make_train_step  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def _close(got, want, L=1, tol=1e-5):
    tol = tol * max(1.0, math.sqrt(L / 128))
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _flat(jtree):
    return {k: np.asarray(v) for k, v in flatten_with_paths(jtree).items()}


def _pair(arch, spec, seed=0, **over):
    jcfg = jconfigs.get(arch, smoke=True, linear=jconfigs.linear_cfg(spec),
                        **over)
    tcfg = tconfigs.get(arch, smoke=True, linear=tconfigs.linear_cfg(spec),
                        **over)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, bridge.from_flat(_flat(jp), "cpu")


def _batch(vocab, B=4, S=16, seed=1):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = seq[:, 1:].copy()
    labels[0, :3] = -1                      # masked positions
    return {"tokens": seq[:, :-1], "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- loss_fn and its gradients --------------------------------------------------------


@pytest.mark.parametrize("arch,spec,route", [
    ("opt125m", "dyad_it_4_kernel", "xla"),
    ("opt125m", "dyad_it_4_kernel", "flash"),
    ("opt125m", "dense", "xla"),
    ("pythia160m", "dyad_it_4_kernel", "xla"),
    ("pythia160m", "dense", "xla"),
])
def test_loss_and_grads_match_jax(arch, spec, route, monkeypatch):
    """route=flash: attention through ops.flash_attention and its
    backward on the port's side, the Pallas forward in interpret mode and
    its XLA backward on the reference's."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", route)
    jcfg, jp, tcfg, tp = _pair(arch, spec)
    batch = _batch(jcfg.vocab_size)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, _jb(batch)), has_aux=True)(jp)
    tm, tg = step_lib.loss_and_grads(tcfg, tp, _tb(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["ppl_proxy"]),
                               float(jm["ppl_proxy"]), rtol=1e-4)
    want, got = _flat(jg), bridge.to_flat(tg)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 64)


def test_loss_masks_negative_labels():
    _, _, tcfg, tp = _pair("opt125m", "dense")
    batch = _tb(_batch(tcfg.vocab_size))
    loss, _ = tmodel.loss_fn(tcfg, tp, batch)
    logits = tmodel.forward(tcfg, tp, batch["tokens"])
    keep = batch["labels"] >= 0
    want = torch.nn.functional.cross_entropy(logits[keep],
                                             batch["labels"][keep])
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)


def test_remat_equals_no_remat():
    _, _, tcfg, tp = _pair("opt125m", "dyad_it_4_kernel")
    batch = _tb(_batch(tcfg.vocab_size))
    m0, g0 = step_lib.loss_and_grads(tcfg, tp, batch)
    m1, g1 = step_lib.loss_and_grads(tcfg.replace(remat=True), tp, batch)
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(tree.leaves(g0), tree.leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_rope_matches_jax():
    from repro.layers.rotary import apply_rope as j_rope
    from repro_torch.layers.rotary import apply_rope

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(5, 12)
    _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0),
           j_rope(jnp.asarray(x), jnp.asarray(pos), 500.0))


# -- AdamW and the schedules ----------------------------------------------------------


def _opt_pair(**kw):
    return (JAdamW(lr=jschedule.constant(LR), **kw),
            AdamW(lr=schedule.constant(LR), **kw))


def _random_like(jtree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        scale * rng.standard_normal(p.shape).astype(np.float32)), jtree)


def _tree_to_port(jtree, dtype=None):
    t = bridge.from_flat(_flat(jtree), "cpu")
    return t if dtype is None else tree.map(lambda x: x.to(dtype), t)


def _assert_params(got, want, steps=1, lr_tol=1e-3 * LR):
    for k in want:
        w = np.asarray(want[k], np.float32)
        floor = 1e-6 * max(float(np.abs(w).max()), 1.0)
        diff = np.abs(np.asarray(got[k], np.float32) - w)
        assert diff.max() <= 2 * LR * steps + floor, (k, diff.max())
        assert np.mean(diff > lr_tol + floor) <= 1e-3, (k, diff.max())


@pytest.mark.parametrize("kw", [
    {}, {"clip_norm": None, "weight_decay": 0.0}, {"clip_norm": 0.05},
    {"moment_dtype": "bfloat16"}])
def test_adamw_update_matches_jax(kw):
    jopt, topt = _opt_pair(**kw)
    _, jp, _, tp = _pair("opt125m", "dyad_it_4_kernel")
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for i in range(2):
        jg = _random_like(jp, 10 + i, 0.1)
        jp, jstate, jm = jopt.update(jg, jstate, jp)
        tp, tstate, tm = topt.update(_tree_to_port(jg), tstate, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    bf16 = kw.get("moment_dtype") == "bfloat16"
    _assert_params(bridge.to_flat(tp), _flat(jp), 2,
                   (1e-2 if bf16 else 1e-3) * LR)
    for k in ("m", "v"):
        want, got = _flat(jstate[k]), bridge.to_flat(tstate[k])
        for key in want:
            # bf16 moments: both sides round the same fp32 value to bf16
            _close(got[key], want[key], tol=8e-3 if bf16 else 1e-5)
    assert int(tstate["step"]) == int(jstate["step"]) == 2


def test_adamw_master_copy_matches_jax():
    jopt, topt = _opt_pair(master=True)
    _, jp, _, _ = _pair("opt125m", "dyad_it_4_kernel")
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tp = _tree_to_port(jax.tree.map(lambda x: x.astype(jnp.float32), jp),
                       torch.bfloat16)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jg = _random_like(jp, 3, 0.1)
    jp, jstate, _ = jopt.update(jg, jstate, jp)
    tp, tstate, _ = topt.update(_tree_to_port(jg), tstate, tp)
    _assert_params(bridge.to_flat(tstate["master"]), _flat(jstate["master"]))
    assert tree.leaves(tp)[0].dtype == torch.bfloat16
    # the bf16 params are the fp32 master rounded once
    for a, b in zip(tree.leaves(tp), tree.leaves(tstate["master"])):
        assert torch.equal(a, b.to(torch.bfloat16))


def test_decay_mask_follows_the_stacked_reference():
    """The reference decides on its stacked layout, so the ff biases
    (stacked (L, d)) ARE decayed though its docstring says "skip biases"
    (ROADMAP C.3); the port follows the rule."""
    _, jp, _, tp = _pair("opt125m", "dyad_it_4_kernel")
    jmask = {k: bool(v) for k, v in flatten_with_paths(
        jax.tree_util.tree_map_with_path(j_decay_mask, jp)).items()}
    tmask = {}
    for path, leaf in tree.leaves_with_paths(tp):
        key, _ = tree.reference_key(path)
        tmask.setdefault(key, set()).add(default_decay_mask(path, leaf))
    assert {k: v.pop() for k, v in tmask.items() if len(v) == 1} == jmask
    assert jmask["layers/mlp/up/b"] and jmask["layers/mlp/down/b"]
    assert jmask["layers/attn/wq/w"] and jmask["embed/table"]
    assert not jmask["final_norm/bias"] and not jmask["layers/norm1/scale"]
    assert not jmask["layers/norm2/bias"]


def test_schedules_match_jax():
    steps = np.arange(0, 40)
    for name, args in (("constant", (3e-4,)),
                       ("warmup_cosine", (1e-3, 7, 30)),
                       ("warmup_cosine", (1e-3, 7, 30, 1e-5)),
                       ("warmup_linear_decay", (2e-3, 5, 25))):
        jf, tf = getattr(jschedule, name)(*args), getattr(schedule, name)(*args)
        for s in steps:
            np.testing.assert_allclose(
                float(tf(torch.tensor(s, dtype=torch.int32))),
                float(jf(jnp.asarray(s, jnp.int32))), rtol=1e-6, atol=1e-12)


# -- make_train_step -------------------------------------------------------------------


def _step_pair(spec="dyad_it_4_kernel", **over):
    jcfg, jp, tcfg, tp = _pair("opt125m", spec, **over)
    jopt, topt = _opt_pair()
    jstate = {"params": jp, "opt": jopt.init(jp)}
    tstate = {"params": tp, "opt": topt.init(tp)}
    return (jax.jit(j_make_train_step(jcfg, jopt)), jstate,
            make_train_step(tcfg, topt), tstate)


def _assert_states(tstate, jstate, steps):
    _assert_params(bridge.to_flat(tstate["params"]), _flat(jstate["params"]),
                   steps)
    for k in ("m", "v"):
        want, got = _flat(jstate["opt"][k]), bridge.to_flat(tstate["opt"][k])
        for key in want:
            _close(got[key], want[key], 64)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"])


@pytest.mark.parametrize("spec,n_steps", [("dyad_it_4_kernel", 1),
                                          ("dyad_it_4_kernel", 3),
                                          ("dense", 3)])
def test_train_steps_match_jax(spec, n_steps):
    jstep, jstate, tstep, tstate = _step_pair(spec)
    for i in range(n_steps):
        batch = _batch(256, seed=20 + i)
        jstate, jm = jstep(jstate, _jb(batch))
        tstate, tm = tstep(tstate, _tb(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert float(tm["nonfinite"]) == float(jm["nonfinite"]) == 0.0
    _assert_states(tstate, jstate, n_steps)


def test_grad_accum_matches_jax_kahan_path():
    jstep, jstate, tstep, tstate = _step_pair(grad_accum=2)
    batch = _batch(256, B=4, seed=30)
    jstate, jm = jstep(jstate, _jb(batch))
    tstate, tm = tstep(tstate, _tb(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _assert_states(tstate, jstate, 1)


def test_skip_step_leaves_the_state_bitwise_unchanged():
    _, _, tstep, tstate = _step_pair()
    batch = dict(_tb(_batch(256)), _fault_poison=torch.tensor(1.0))
    before = [t.clone() for t in tree.leaves(tstate)]
    leaves = tree.leaves(tstate)
    state, metrics = tstep(tstate, batch)
    assert float(metrics["nonfinite"]) == 1.0
    assert not math.isfinite(float(metrics["loss"]))
    after = tree.leaves(state)
    assert all(a is b for a, b in zip(after, leaves))     # updated in place
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    batch["_fault_poison"] = torch.tensor(0.0)
    state, metrics = tstep(state, batch)
    assert float(metrics["nonfinite"]) == 0.0
    assert not torch.equal(before[-1], tree.leaves(state)[-1])
    assert int(state["opt"]["step"]) == 1


def test_packed_state_steps_bitwise_like_a_loose_one():
    """Params and moments packed into one buffer each (as
    init_train_state builds them) step exactly as loose leaves do, stay
    packed in the same tensors, and skip a poisoned step bitwise."""
    _, _, tstep, loose = _step_pair()
    _, _, _, packed = _step_pair()
    packed["params"] = tree.pack(packed["params"])
    leaves = tree.leaves(packed)
    bufs = [tree.packed(tree.leaves(t)) for t in
            (packed["params"], packed["opt"]["m"], packed["opt"]["v"])]
    assert all(b is not None for b in bufs)
    assert tree.packed(tree.leaves(loose["params"])) is None
    for i in range(3):
        batch = _tb(_batch(256, seed=40 + i))
        if i == 1:
            batch["_fault_poison"] = torch.tensor(1.0)
        loose, lm = tstep(loose, batch)
        packed, pm = tstep(packed, batch)
        assert float(lm["nonfinite"]) == float(pm["nonfinite"]) == (i == 1)
    assert all(a is b for a, b in zip(tree.leaves(packed), leaves))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(packed),
                                                  tree.leaves(loose)))
    for t, b in zip((packed["params"], packed["opt"]["m"],
                     packed["opt"]["v"]), bufs):
        got = tree.packed(tree.leaves(t))
        assert got.data_ptr() == b.data_ptr() and got.numel() == b.numel()


def test_tree_flat_reads_a_packed_tree_without_a_copy():
    t = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2),
                                                     torch.zeros(())]}
    p = tree.pack(t)
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(p),
                                                  tree.leaves(t)))
    vec = tree.flat(tree.leaves(p))
    assert vec.shape == (9,) and tree.packed(tree.leaves(p)) is not None
    vec.mul_(2)                                   # the buffer itself
    assert torch.equal(p["a"], 2 * t["a"])
    # loose, reordered or strided leaves are concatenated copies
    for ls in (tree.leaves(t), tree.leaves(p)[::-1], [p["a"].t()]):
        assert tree.packed(ls) is None
        assert torch.equal(tree.flat(ls),
                           torch.cat([x.reshape(-1) for x in ls]))


def test_compressor_other_than_none_raises():
    """A compressor other than ``none`` runs in the step: one int8 step
    with error feedback against the reference's (loss, grad norm,
    params); a codec neither package knows raises."""
    from repro.optim.compress import Compressor as JCompressor
    from repro_torch.optim import Compressor

    jcfg, jp, tcfg, tp = _pair("opt125m", "dyad_it_4_kernel")
    jopt, topt = _opt_pair()
    jc, tc = JCompressor(codec="int8"), Compressor(codec="int8")
    jstate = {"params": jp, "opt": jopt.init(jp), "compress": jc.init(jp)}
    tstate = {"params": tp, "opt": topt.init(tp), "compress": tc.init(tp)}
    batch = _batch(256, seed=70)
    jstate, jm = jax.jit(j_make_train_step(jcfg, jopt, compressor=jc))(
        jstate, _jb(batch))
    tstate, tm = make_train_step(tcfg, topt, compressor=tc)(tstate,
                                                            _tb(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    _assert_params(bridge.to_flat(tstate["params"]), _flat(jstate["params"]))
    with pytest.raises(ValueError, match="unknown gradient codec"):
        Compressor(codec="int4")


def test_eval_step_matches_loss_fn():
    _, _, tcfg, tp = _pair("opt125m", "dyad_it_4_kernel")
    batch = _tb(_batch(256))
    m = step_lib.make_eval_step(tcfg)(tp, batch)
    assert torch.equal(m["loss"], tmodel.loss_fn(tcfg, tp, batch)[1]["loss"])


# -- SyntheticLM -----------------------------------------------------------------------


def test_synthetic_lm_stream():
    d = SyntheticLM(vocab_size=97, seq_len=64, global_batch=64, seed=3,
                    device="cpu")
    b3 = d.batch(3)
    assert b3["tokens"].shape == (64, 64) and b3["tokens"].dtype == torch.int64
    # deterministic and stateless: the same step gives the same batch,
    # whatever was drawn before
    d.batch(7)
    assert torch.equal(d.batch(3)["tokens"], b3["tokens"])
    assert not torch.equal(d.batch(4)["tokens"], b3["tokens"])
    # labels are the tokens shifted by one
    assert torch.equal(b3["labels"][:, :-1], b3["tokens"][:, 1:])
    # the copy rate: p_copy, plus the noise draws that hit perm[prev]
    hit = (b3["labels"] == d.perm()[b3["tokens"]]).float().mean()
    assert abs(float(hit) - (0.8 + 0.2 / 97)) < 0.03
    # shards split the global batch: each its own rows, none repeated
    shards = [d.reshard(s, 4).batch(3)["tokens"] for s in range(4)]
    assert all(s.shape == (16, 64) for s in shards)
    rows = {tuple(r.tolist()) for s in shards for r in s}
    assert len(rows) == 64
    with pytest.raises(ValueError):
        d.reshard(0, 5)


@pytest.mark.parametrize("vocab,seq,batch,p_copy", [
    (97, 64, 8, 0.8), (11, 1, 3, 0.5), (300, 100, 4, 1.0), (300, 100, 4, 0.0),
    (50, 127, 3, 0.9)])
def test_synthetic_lm_walk_equals_the_recurrence(vocab, seq, batch, p_copy):
    """The batched walk equals the token-by-token recurrence on the same
    draws: seq[t + 1] = perm[seq[t]] where use_copy[t], else noise[t]."""
    from repro_torch.data.synthetic import _generator
    d = SyntheticLM(vocab, seq, batch, seed=5, p_copy=p_copy, device="cpu")
    for step in (0, 3):
        gen = _generator(d.seed, step, d.shard)
        first = torch.randint(0, vocab, (batch,), generator=gen)
        noise = torch.randint(0, vocab, (batch, seq), generator=gen)
        use_copy = torch.rand((batch, seq), generator=gen) < p_copy
        want = [first]
        for t in range(seq):
            want.append(torch.where(use_copy[:, t], d.perm()[want[-1]],
                                    noise[:, t]))
        want = torch.stack(want, dim=1)
        got = d.batch(step)
        assert torch.equal(got["tokens"], want[:, :-1])
        assert torch.equal(got["labels"], want[:, 1:])


# -- the Trainer ------------------------------------------------------------------------


def _trainer(tmp_path=None, data=None, **kw):
    tcfg = tconfigs.get("opt125m", smoke=True,
                        linear=tconfigs.linear_cfg("dyad_it_4_kernel"))
    opt = AdamW(lr=schedule.constant(LR))
    state = step_lib.init_train_state(
        tcfg, opt, torch.Generator().manual_seed(0), device="cpu")
    data = data or SyntheticLM(tcfg.vocab_size, 8, 2, device="cpu")
    return Trainer(make_train_step(tcfg, opt), state, data,
                   ckpt_dir=str(tmp_path) if tmp_path else None,
                   log_fn=lambda *a: None, **kw)


def _assert_same(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)


def test_trainer_resumes_from_the_newest_checkpoint(tmp_path):
    ref_state, _ = _trainer().run(6)
    _trainer(tmp_path, ckpt_every=2).run(4)
    t = _trainer(tmp_path, ckpt_every=2)
    state, _ = t.run(6)
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
    _assert_same(state, ref_state)


class _Poisoned:
    """SyntheticLM whose first ``times`` batches from step ``at`` on carry
    the ``_fault_poison`` key."""

    def __init__(self, data, at, times):
        self.data, self.at, self.left = data, at, times

    def batch(self, step):
        b = dict(self.data.batch(step))
        if step >= self.at and self.left:
            self.left -= 1
            b["_fault_poison"] = torch.tensor(1.0)
        return b


def test_trainer_rollback_matches_clean_run(tmp_path):
    ref_state, _ = _trainer().run(8)
    data = _Poisoned(SyntheticLM(256, 8, 2, device="cpu"), at=5, times=2)
    t = _trainer(tmp_path, data=data, ckpt_every=4, nan_strikes=2)
    state, _ = t.run(8)
    c = t.metrics.snapshot()["counters"]
    assert c["nonfinite_steps"] == 2 and c["rollbacks"] == 1
    assert t.step == 8
    _assert_same(state, ref_state)


def test_trainer_nan_without_checkpoint_raises():
    data = _Poisoned(SyntheticLM(256, 8, 2, device="cpu"), at=0, times=9)
    t = _trainer(data=data, nan_strikes=2)
    with pytest.raises(NumericalFault):
        t.run(8)


def test_trainer_metrics_and_stragglers():
    seen = []
    t = _trainer(straggler_factor=0.0, on_straggler=lambda *a: seen.append(a))
    t.run(9)
    snap = t.metrics.snapshot()
    assert snap["histograms"]["step_time_s"]["count"] == 9
    assert snap["histograms"]["data_time_s"]["count"] == 9
    assert snap["counters"]["tokens_trained"] == 9 * 16
    assert snap["gauges"]["tokens_per_s"]["value"] > 0
    assert len(seen) == 2 == snap["counters"]["straggler_count"]


# -- checkpoints cross between the packages --------------------------------------------


def _jstate_like(tstate):
    flat = bridge.to_flat(tstate)
    nested = {}
    for k, v in flat.items():
        node = nested
        *parents, last = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    return nested


def test_checkpoints_cross_both_ways(tmp_path):
    t = _trainer(tmp_path / "port", ckpt_every=2)
    t.run(2)                                         # params, m, v, step
    state = t.state
    template = _jstate_like(state)
    step, restored = JCheckpointManager(str(tmp_path / "port")).restore(
        template)
    assert step == 2
    want = bridge.to_flat(state)
    got = _flat(restored)
    assert set(got) == set(want) and "opt/step" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype

    jmgr = JCheckpointManager(str(tmp_path / "ref"), async_save=False)
    jtree = jax.tree.map(lambda x: x * 2 if x.dtype == jnp.float32 else x + 5,
                         template)
    jmgr.save(7, jtree)
    step, back = CheckpointManager(str(tmp_path / "ref")).restore(state)
    assert step == 7
    for k, v in bridge.to_flat(back).items():
        np.testing.assert_array_equal(v, np.asarray(flatten_with_paths(
            jtree)[k]))


# -- the launcher ---------------------------------------------------------------------


def _launch(*args, **kw):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT, **kw)


def test_launcher_cpu_smoke(tmp_path):
    p = _launch("--arch", "opt125m", "--smoke", "--device", "cpu",
                "--steps", "3", "--linear", "dyad_it_4_kernel",
                "--metrics-json", str(tmp_path / "m.json"))
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out
    assert "[train] arch=opt-125m-smoke" in out
    assert "[train] done at step 3: loss=" in out
    assert "[train] summary: steps=3 step_ms p50" in out
    assert (tmp_path / "m.json").exists()


def test_launcher_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    p = _launch("--arch", "opt125m", "--smoke")
    out, _ = p.communicate(timeout=300)
    assert p.returncode != 0
    assert "CUDA is not available" in out


def test_launcher_sigterm_saves_and_exits_zero(tmp_path):
    p = _launch("--arch", "opt125m", "--smoke", "--device", "cpu",
                "--steps", "100000", "--batch", "2", "--seq-len", "8",
                "--ckpt-every", "3", "--ckpt-dir", str(tmp_path))
    try:
        deadline = time.time() + 200
        while time.time() < deadline and p.poll() is None:
            if any(tmp_path.glob("ckpt_*/manifest.json")):
                break
            time.sleep(0.1)
        assert p.poll() is None, p.communicate()[0]
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, out
    assert "preempted at step" in out
    stopped = int(out.split("preempted at step ")[1].split(":")[0])
    assert CheckpointManager(str(tmp_path)).latest_step() == stopped
