"""Port parity for gradient compression: ``repro_torch.optim.Compressor``
(codecs ``int8``, ``topk``, ``none``, with error feedback) against
``repro.optim.compress.Compressor`` on the same gradients, train steps with
a compressor against the reference's, the skip-step over the error state,
and the trainer and launcher with ``--compress``.

Tolerances: the codec on the same fp32 gradients is compared bit for bit
(the same fp32 operations on both sides).  Train steps take gradients that
differ from the reference's in their last bits (sums in another order),
which can move an element across a rounding boundary of the int8 codec
(or across the top-k threshold): that element then differs by one
quantum, max|leaf| / 127.  So the error state is held to one quantum
everywhere and to 1e-5 x max(|leaf|, 1) on all but 1 in 1000 elements,
and the params as in ``tests/test_torch_train.py``."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim.compress import Compressor as JCompressor  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.optim import Compressor  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from test_torch_train import (ROOT, _assert_params, _batch, _flat, _jb,  # noqa: E402
                              _opt_pair, _pair, _random_like, _tb)


def _port_tree(jtree):
    return bridge.from_flat(_flat(jtree), "cpu")


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_compressor_matches_jax_bit_for_bit(codec):
    """Three rounds of error feedback on the same gradients: the decoded
    gradients and the carried error equal the reference's bit for bit, and
    each leaf keeps a scale (or threshold) of its own."""
    _, jp, _, tp = _pair("opt125m", "dyad_it_4_kernel")
    jc, tc = JCompressor(codec=codec, topk_frac=0.05), Compressor(
        codec=codec, topk_frac=0.05)
    js, ts = jc.init(jp), tc.init(tp)
    assert tree.packed(tree.leaves(ts["err"])) is not None
    for i in range(3):
        # leaves of very different magnitudes: one scale per leaf matters
        jg = jax.tree.map(lambda g, k=i: g * (10.0 ** (k - 1)),
                          _random_like(jp, 30 + i, 0.1))
        jdec, js = jc.compress_decompress(jg, js)
        tdec, ts = tc.compress_decompress(_port_tree(jg), ts)
        for got, want in ((bridge.to_flat(tdec), _flat(jdec)),
                          (bridge.to_flat(ts["err"]), _flat(js["err"]))):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert any(float(v.abs().max()) > 0 for v in tree.leaves(ts["err"]))


def test_compressor_none_and_unknown_codecs():
    c = Compressor(codec="none")
    g = {"a": torch.ones(3)}
    assert c.init(g) == {}
    out, state = c.compress_decompress(g, {})
    assert out is g and state == {}
    with pytest.raises(ValueError, match="unknown gradient codec"):
        Compressor(codec="int4")


def _mostly_close(got, want, tol=1e-5):
    """Within one int8 quantum of the leaf everywhere, within tol x
    max(|leaf|, 1) on all but 1 in 1000 elements."""
    for k in want:
        w = np.asarray(want[k], np.float32)
        d = np.abs(np.asarray(got[k], np.float32) - w)
        scale = max(float(np.abs(w).max()), 1.0)
        assert d.max() <= 2 * scale / 127, (k, d.max())
        assert np.mean(d > tol * scale) <= 1e-3, (k, d.max())


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_train_steps_with_compression_match_jax(codec):
    jcfg, jp, tcfg, tp = _pair("opt125m", "dyad_it_4_kernel")
    jopt, topt = _opt_pair()
    jc, tc = JCompressor(codec=codec), Compressor(codec=codec)
    jstate = {"params": jp, "opt": jopt.init(jp), "compress": jc.init(jp)}
    tp = tree.pack(tp)
    tstate = {"params": tp, "opt": topt.init(tp), "compress": tc.init(tp)}
    jstep = jax.jit(j_make_train_step(jcfg, jopt, compressor=jc))
    tstep = make_train_step(tcfg, topt, compressor=tc)
    n = 3
    for i in range(n):
        batch = _batch(256, seed=50 + i)
        jstate, jm = jstep(jstate, _jb(batch))
        tstate, tm = tstep(tstate, _tb(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    _assert_params(bridge.to_flat(tstate["params"]), _flat(jstate["params"]),
                   n)
    _mostly_close(bridge.to_flat(tstate["compress"]["err"]),
                  _flat(jstate["compress"]["err"]))


def test_poisoned_step_keeps_the_error_state():
    _, _, tcfg, tp = _pair("opt125m", "dyad_it_4_kernel")
    _, topt = _opt_pair()
    tc = Compressor(codec="int8")
    tp = tree.pack(tp)
    state = {"params": tp, "opt": topt.init(tp), "compress": tc.init(tp)}
    step = make_train_step(tcfg, topt, compressor=tc)
    state, m = step(state, _tb(_batch(256, seed=60)))
    assert float(m["nonfinite"]) == 0.0
    err = tree.leaves(state["compress"])
    before = [t.clone() for t in err]
    batch = dict(_tb(_batch(256, seed=61)), _fault_poison=torch.tensor(1.0))
    state, m = step(state, batch)
    assert float(m["nonfinite"]) == 1.0
    after = tree.leaves(state["compress"])
    assert all(a is b for a, b in zip(after, err))       # updated in place
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_trainer_resumes_the_error_state(tmp_path):
    """The error state rides in the checkpoints under the reference's keys
    (``compress/err/...``) and a resumed run continues bit for bit."""
    from repro_torch.launch.train import build_trainer

    def trainer(d=None, every=50):
        return build_trainer("opt125m", smoke=True,
                             linear="dyad_it_4_kernel", steps=10, seq_len=8,
                             batch=2, ckpt_dir=d, ckpt_every=every,
                             device="cpu", compress="int8",
                             log_fn=lambda *a: None)[1]

    ref, _ = trainer().run(4)
    assert "compress" in ref
    trainer(str(tmp_path), every=2).run(2)
    state, _ = trainer(str(tmp_path), every=2).run(4)
    for a, b in zip(tree.leaves(state), tree.leaves(ref)):
        assert torch.equal(a, b)
    assert any(k.startswith("compress/err/")
               for k in bridge.to_flat({"compress": ref["compress"]}))


def test_train_launcher_compress_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "opt125m", "--smoke", "--device", "cpu", "--steps", "2",
         "--linear", "dyad_it_4_kernel", "--compress", "topk"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert r.returncode == 0, r.stderr
    assert "compress=topk" in r.stdout
    assert "[train] done at step 2: loss=" in r.stdout
