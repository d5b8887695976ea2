"""Port parity for the OPT model path: ``repro_torch.models.model``
forward, prefill and decode_step logits against the JAX model on the same
weights (moved over by ``repro_torch.checkpoint.bridge``), for the dense
baseline, DYAD-IT on the einsum route and DYAD-IT on the kernel route;
the bridge itself; and the port's isolation from JAX.

Tolerance: 1e-5 times max(|reference logits|, 1), fp32 on the CPU."""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import flatten_with_paths  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _pair(arch, spec, seed=0):
    jcfg = jconfigs.get(arch, smoke=True, linear=jconfigs.linear_cfg(spec))
    tcfg = tconfigs.get(arch, smoke=True, linear=tconfigs.linear_cfg(spec))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(jp).items()}
    return jcfg, jp, tcfg, bridge.from_flat(flat, "cpu")


ROUTES = [("dense", "xla"), ("dyad_it", "xla"), ("dyad_it_4_kernel", "xla"),
          ("dyad_it_4_kernel", "flash")]


@pytest.mark.parametrize("spec,route", ROUTES)
def test_forward_prefill_decode_match_jax(spec, route, monkeypatch):
    """route=flash runs the reference's three Pallas kernels in interpret
    mode and the port's flash wrappers on their plain versions."""
    monkeypatch.setenv("REPRO_KERNEL_ATTN", route)
    _check_forward_prefill_decode("opt125m", spec)


@pytest.mark.parametrize("spec", ["dense", "dyad_it_4_kernel"])
def test_pythia_rope_forward_prefill_decode_match_jax(spec):
    """RoPE: the queries and keys of the prefill and of the decode step are
    rotated at their absolute positions before the cache write."""
    _check_forward_prefill_decode("pythia160m", spec)


def _check_forward_prefill_decode(arch, spec):
    jcfg, jp, tcfg, tp = _pair(arch, spec)
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
    assert tmodel.cache_pos(tc) == 12

    want, _ = jmodel.decode_step(jcfg, jp, jc, jnp.asarray(nxt))
    got, tc = tmodel.decode_step(tcfg, tp, tc, torch.from_numpy(nxt).long())
    _close(got.numpy(), want)
    assert got.shape == (2, 1, jcfg.vocab_size)
    assert tmodel.cache_pos(tc) == 13


@pytest.mark.parametrize("arch", ["opt125m", "opt350m", "pythia160m"])
def test_init_params_matches_reference_tree(arch):
    """The port draws its own weights, in the reference's tree: same keys,
    shapes and parameter count once bridged."""
    jcfg = jconfigs.get(arch, smoke=True)
    tcfg = tconfigs.get(arch, smoke=True)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: v.shape for k, v in flatten_with_paths(jp).items()}
    got = {k: v.shape for k, v in bridge.to_flat(tp).items()}
    assert got == want
    assert tmodel.param_count(tp) == jmodel.param_count(jp)


def test_full_configs_match_reference():
    for arch in ("opt125m", "opt350m", "pythia160m"):
        j, t = jconfigs.get(arch), tconfigs.get(arch)
        for field in ("n_layers", "d_model", "vocab_size", "n_heads",
                      "n_kv_heads", "head_dim", "d_ff", "act", "mlp_bias",
                      "norm", "pos_embed", "max_position", "flash_attn",
                      "rope_theta", "tie_embeddings", "iota_embed"):
            assert getattr(t, field) == getattr(j, field), (arch, field)


def test_bridge_round_trip_is_exact():
    _, jp, _, tp = _pair("opt125m", "dyad_it_4_kernel", seed=3)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(jp).items()}
    back = bridge.to_flat(tp)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    assert len(tp["layers"]) == 2
    assert tp["layers"][1]["mlp"]["up"]["w1"].shape == (4, 32, 16)
    assert bridge.flatten_with_paths({"b": {"y": 1, "x": 2}, "a": 3}) == {
        "a": 3, "b/x": 2, "b/y": 1}


def test_builders_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    tcfg = tconfigs.get("opt125m", smoke=True)
    flat = bridge.to_flat(tmodel.init_params(
        tcfg, torch.Generator().manual_seed(0), "cpu"))
    for build in (lambda: bridge.from_flat(flat),
                  lambda: tmodel.init_params(tcfg, torch.Generator()),
                  lambda: tmodel.init_cache(tcfg, 1, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$|,)"
    r"|from\s+repro(\.|\s))", re.M)


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # the training slice's modules are among those scanned
    names = {str(f.relative_to(ROOT / "src" / "repro_torch"))
             for f in files[:-1]}
    assert {"tree.py", "errors.py", "optim/adamw.py", "optim/schedule.py",
            "data/synthetic.py", "train/step.py", "train/loop.py",
            "checkpoint/manager.py", "obs/metrics.py", "launch/train.py",
            "layers/rotary.py", "configs/pythia160m.py"} <= names
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    # the pattern catches the reference and spares the port's own package
    assert _FORBIDDEN.search("from repro.core import dyad")
    assert _FORBIDDEN.search("import repro")
    assert _FORBIDDEN.search("from repro import configs")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from repro_torch.core import dyad")
    assert not _FORBIDDEN.search("import repro_torch")
