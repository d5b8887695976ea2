"""Port parity for serving: ``repro_torch.serve.engine.Engine.generate``
greedy tokens against the JAX ``Engine`` on OPT smoke with
``dyad_it_4_kernel``, under ``REPRO_KERNEL_ATTN=flash`` (the reference's
three Pallas kernels in interpret mode) and ``=xla``; the sampler; and the
launcher as a subprocess.

The ff weights are scaled by 4 on both sides: at the init scale greedy
decoding from random weights repeats one token, which would leave most of
the comparison blind."""
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
from repro.models import model as jmodel  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC = "dyad_it_4_kernel"


def _weights(seed=0, ff_scale=4.0):
    jcfg = jconfigs.get("opt125m", smoke=True, linear=jconfigs.linear_cfg(SPEC))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(
        jmodel.init_params(jcfg, jax.random.PRNGKey(seed))).items()}
    for k in flat:
        if k.startswith("layers/mlp/") and k.endswith(("/w1", "/w2")):
            flat[k] = flat[k] * np.float32(ff_scale)
    return flat


def _jax_params(jcfg, flat):
    tree = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    treedef = jax.tree_util.tree_structure(tree)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[k]) for k in flatten_with_paths(tree)])


@pytest.mark.parametrize("route", ["flash", "xla"])
def test_generate_matches_jax_engine(route, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_ATTN", route)
    jcfg = jconfigs.get("opt125m", smoke=True, linear=jconfigs.linear_cfg(SPEC))
    tcfg = tconfigs.get("opt125m", smoke=True, linear=tconfigs.linear_cfg(SPEC))
    flat = _weights()
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    want = np.asarray(JEngine(jcfg, _jax_params(jcfg, flat), max_len=16)
                      .generate(jnp.asarray(prompts), 9))
    eng = tengine.Engine(tcfg, bridge.from_flat(flat, "cpu"), max_len=16,
                         device="cpu")
    got = eng.generate(torch.from_numpy(prompts), 9)
    assert got.shape == (2, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2          # the check is not blind
    assert set(eng.timings) == {"prefill_s", "decode_s"}


def test_generate_limits_and_sampling():
    tcfg = tconfigs.get("opt125m", smoke=True, linear=tconfigs.linear_cfg(SPEC))
    params = bridge.from_flat(_weights(), "cpu")
    eng = tengine.Engine(tcfg, params, max_len=12, device="cpu")
    prompts = torch.zeros(3, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.generate(prompts, 6)
    assert eng.generate(prompts, 5).shape == (3, 5)   # S + new - 1 == max_len
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = eng.generate(prompts, 4, temperature=0.8, generator=g1)
    b = eng.generate(prompts, 4, temperature=0.8, generator=g2)
    assert torch.equal(a, b) and int(a.max()) < tcfg.vocab_size


def test_greedy_ties_take_the_first_index():
    logits = torch.tensor([[[0.0, 3.0, 3.0, 1.0]], [[5.0, 5.0, 5.0, 5.0]]])
    assert tengine.sample_token(logits, 0.0).tolist() == [[1], [0]]
    want = np.asarray(jnp.argmax(jnp.asarray(logits.numpy())[:, -1:],
                                 axis=-1))
    np.testing.assert_array_equal(tengine.sample_token(logits, 0.0).numpy(),
                                  want)


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_launcher_cpu_smoke():
    r = _launch("--arch", "opt125m", "--smoke", "--linear", SPEC,
                "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
                "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "generated (2, 4)" in r.stdout


def test_launcher_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    r = _launch("--arch", "opt125m", "--smoke")
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
