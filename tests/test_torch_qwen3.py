"""Port parity for the Qwen3-0.6B slice: the config, qk-norm and GQA
attention on its three branches (no-cache forward, cache prefill, decode),
the attention's ``chunk`` dispatch, logits, loss and gradients, 1 and 3
train steps and greedy ``Engine.generate`` tokens with the ff megakernel
(``dyad_it_4_kernel_ffused``), all on the smoke config with weights moved
over by ``repro_torch.checkpoint.bridge``; and one OPT train step each
with the paper's OT and DT variants on the kernel route.

Tolerances, fp32 on the CPU, as in ``tests/test_torch_train.py``: logits
1e-5 x max(|reference|, 1); loss 1e-5 relative; grads and moments 1e-5 x
max(|reference leaf|, 1) x max(1, sqrt(L / 128)) with L the batch's
tokens; params after AdamW within 2 x lr per step, all but 1 in 1000
within 1e-3 x lr."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import flatten_with_paths  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.kernels import dyad_mm, flash_attn  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402
from test_torch_train import (_assert_states, _batch, _close, _flat, _jb,  # noqa: E402
                              _opt_pair, _pair, _tb)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC = "dyad_it_4_kernel_ffused"


def test_qwen3_configs_match_reference():
    for smoke in (False, True):
        j = jconfigs.get("qwen3_0_6b", smoke=smoke)
        t = tconfigs.get("qwen3_0_6b", smoke=smoke)
        for field in ("name", "n_layers", "d_model", "vocab_size", "n_heads",
                      "n_kv_heads", "head_dim", "d_ff", "act", "mlp_bias",
                      "norm", "pos_embed", "flash_attn", "rope_theta",
                      "tie_embeddings", "iota_embed", "qk_norm",
                      "attn_chunk", "compute_dtype", "remat"):
            assert getattr(t, field) == getattr(j, field), (smoke, field)
    spec = tconfigs.linear_cfg(SPEC)
    assert spec.fuse_ff_kernel and spec.use_kernel and not spec.fuse_mlp


def test_qwen3_init_params_matches_reference_tree():
    jcfg = jconfigs.get("qwen3_0_6b", smoke=True,
                        linear=jconfigs.linear_cfg(SPEC))
    tcfg = tconfigs.get("qwen3_0_6b", smoke=True,
                        linear=tconfigs.linear_cfg(SPEC))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: v.shape for k, v in _flat(jp).items()}
    assert {k: v.shape for k, v in bridge.to_flat(tp).items()} == want
    assert "layers/attn/q_norm/scale" in want
    assert "layers/mlp/gate/w1" in want and "layers/mlp/gate/b" not in want


@pytest.mark.parametrize("spec,route", [(SPEC, "xla"), (SPEC, "flash"),
                                        ("dense", "xla")])
def test_qwen3_forward_prefill_decode_match_jax(spec, route, monkeypatch):
    """qk-norm and GQA (G = 2) on every branch; route=flash runs the
    reference's Pallas kernels in interpret mode and the port's flash
    wrappers on their plain versions."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", route)
    jcfg, jp, tcfg, tp = _pair("qwen3_0_6b", spec)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    want, _ = jmodel.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    _close(tmodel.forward(tcfg, tp, tt).numpy(), want)
    jc = jmodel.init_cache(jcfg, 2, 20, jnp.float32)
    want, jc = jmodel.prefill(jcfg, jp, jc, jnp.asarray(toks),
                              last_only=False)
    tc = tmodel.init_cache(tcfg, 2, 20, torch.float32, "cpu")
    got, tc = tmodel.prefill(tcfg, tp, tc, tt, last_only=False)
    _close(got.numpy(), want)
    want, _ = jmodel.decode_step(jcfg, jp, jc, jnp.asarray(nxt))
    got, _ = tmodel.decode_step(tcfg, tp, tc, torch.from_numpy(nxt).long())
    _close(got.numpy(), want)


def test_qwen3_loss_and_grads_match_jax():
    jcfg, jp, tcfg, tp = _pair("qwen3_0_6b", SPEC)
    batch = _batch(jcfg.vocab_size)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, _jb(batch)), has_aux=True)(jp)
    before = dyad_mm.dyad_ff_fused.launches
    tm, tg = step_lib.loss_and_grads(tcfg, tp, _tb(batch))
    assert dyad_mm.dyad_ff_fused.launches == before      # CPU: plain
    np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=1e-5)
    want, got = _flat(jg), bridge.to_flat(tg)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 64)


@pytest.mark.parametrize("arch,spec,n_steps", [
    ("qwen3_0_6b", SPEC, 1),
    ("qwen3_0_6b", SPEC, 3),
    # the paper's other DYAD variants on the kernel route, OPT's biased ff
    ("opt125m", "dyad_ot_4_kernel", 1),
    ("opt125m", "dyad_dt_4_kernel", 1),
])
def test_train_steps_match_jax(arch, spec, n_steps):
    jcfg, jp, tcfg, tp = _pair(arch, spec)
    jopt, topt = _opt_pair()
    jstep = jax.jit(j_make_train_step(jcfg, jopt))
    tstep = make_train_step(tcfg, topt)
    jstate = {"params": jp, "opt": jopt.init(jp)}
    tstate = {"params": tp, "opt": topt.init(tp)}
    for i in range(n_steps):
        batch = _batch(256, seed=50 + i)
        jstate, jm = jstep(jstate, _jb(batch))
        tstate, tm = tstep(tstate, _tb(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    _assert_states(tstate, jstate, n_steps)


def test_qwen3_remat_equals_no_remat():
    _, _, tcfg, tp = _pair("qwen3_0_6b", SPEC)
    batch = _tb(_batch(tcfg.vocab_size))
    m0, g0 = step_lib.loss_and_grads(tcfg, tp, batch)
    m1, g1 = step_lib.loss_and_grads(tcfg.replace(remat=True), tp, batch)
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(bridge.to_flat(g0).values(), bridge.to_flat(g1).values()):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _jax_params(jcfg, flat):
    tree = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    treedef = jax.tree_util.tree_structure(tree)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[k]) for k in flatten_with_paths(tree)])


@pytest.mark.parametrize("route", ["flash", "xla"])
def test_qwen3_generate_matches_jax_engine(route, monkeypatch):
    """Greedy tokens.  The ff weights are scaled by 4 on both sides: at
    the init scale greedy decoding from random weights repeats one token,
    which would leave most of the comparison blind."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", route)
    jcfg, jp, tcfg, _ = _pair("qwen3_0_6b", SPEC)
    flat = _flat(jp)
    for k in flat:
        if k.startswith("layers/mlp/") and k.endswith(("/w1", "/w2")):
            flat[k] = flat[k] * np.float32(4.0)
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    want = np.asarray(JEngine(jcfg, _jax_params(jcfg, flat), max_len=16)
                      .generate(jnp.asarray(prompts), 9))
    got = tengine.Engine(tcfg, bridge.from_flat(flat, "cpu"), max_len=16,
                         device="cpu").generate(torch.from_numpy(prompts), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2          # the check is not blind


# -- attention: the chunk dispatch -------------------------------------------


def _attn_case(S, chunk, seed=3):
    """One qk-norm GQA attention layer of the Qwen3 smoke widths, as both
    packages' params and input."""
    jcfg = jconfigs.get("qwen3_0_6b", smoke=True)
    lin = jconfigs.linear_cfg("dense")
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg.d_model,
                              jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim,
                              lin, qk_norm=True)
    jp = jax.tree.map(lambda a: a * 1.5, jp)     # off the unit norm scale
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(seed).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    kw = dict(n_heads=jcfg.n_heads, n_kv=jcfg.n_kv_heads,
              head_dim=jcfg.head_dim, rope_theta=jcfg.rope_theta,
              chunk=chunk, flash=True)
    want, _ = jattn.attention(jp, jnp.asarray(x), lin_cfg=lin, **kw)
    got = lambda: tattn.attention(  # noqa: E731
        tp, torch.from_numpy(x), lin_cfg=tconfigs.linear_cfg("dense"),
        **kw)[0]
    return want, got


@pytest.mark.parametrize("S,chunk", [(12, 16), (16, 16)])
def test_attention_with_chunk_set_and_short_sequence_matches_jax(
        S, chunk, monkeypatch):
    """S <= chunk: the reference's naive branch, with chunk set (as
    Qwen3's full config sets attn_chunk=2048)."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", "xla")
    want, got = _attn_case(S, chunk)
    _close(got().numpy(), want)


def test_flash_route_ignores_chunk(monkeypatch):
    """On the flash route chunk is not consulted: S = 16 > chunk = 4 runs
    the flash wrappers (plain versions here) and matches the reference's
    interpret-mode flash kernel."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", "flash")
    want, got = _attn_case(16, 4)
    before = flash_attn.flash_prefill.launches
    _close(got().numpy(), want)
    assert flash_attn.flash_prefill.launches == before


@pytest.mark.parametrize("S,chunk,name", [(16, 4, "_q_block_sdpa"),
                                          (10, 4, "_chunked_sdpa")])
def test_chunked_branches_raise_only_when_taken(S, chunk, name,
                                                monkeypatch):
    """S > chunk on the plain route: the reference's chunked einsum paths,
    ported (they raised until the port had them).  S a multiple of chunk
    takes the q-blocked one, else the key-chunked one; each matches the
    reference's output, and only the branch the reference takes runs."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", "xla")
    taken = []
    for branch in ("_q_block_sdpa", "_chunked_sdpa", "_naive_sdpa"):
        fn = getattr(tattn, branch)
        monkeypatch.setattr(tattn, branch, lambda *a, _b=branch, _f=fn,
                            **k: taken.append(_b) or _f(*a, **k))
    want, got = _attn_case(S, chunk)
    _close(got().numpy(), want)
    assert taken == [name]


def test_qwen3_train_launcher_cpu_smoke():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3_0_6b", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq-len", "16", "--linear", SPEC],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[train] done at step 2" in r.stdout
