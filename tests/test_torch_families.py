"""Port parity for the moe, ssm and hybrid families: Qwen1.5-MoE-A2.7B,
Llama-4 Maverick, Mamba2-780m and Hymba-1.5B at smoke size, the port
against the JAX model on the same weights (moved over by
``repro_torch.checkpoint.bridge``): the init tree, the full configs, the
bridge round trip, forward and ``loss_fn`` with the router's aux term,
prefill and decode logits, ``Engine.generate`` tokens, Hymba's prompt
past its window (batch and continuous), and the continuous engine
against the port's batch engine (MoE paged and dense, Mamba2 and Hymba
dense), and the continuous engine against the reference's.

The port runs the configs' kernel-routed linear (``use_kernel`` and
``fuse_ff_kernel``, the scope kept: ``ff`` or ``ff+ssm``), whose CPU
route is the kernels' plain versions; the JAX side runs the same
function on its einsum route (``fuse_mlp``: the megakernel's mixed-variant
dataflow).  Logits within 1e-5 x max(|reference|, 1), fp32 on the CPU;
tokens exactly.  The ff (and expert) weights are scaled by 4 on both
sides, so that greedy tokens vary."""
import dataclasses
import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import flatten_with_paths  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import ModelCfg as JModelCfg  # noqa: E402
from repro.serve.engine import (  # noqa: E402
    ContinuousBatchingEngine as JCEngine, Engine as JEngine)
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.config import ModelCfg  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatchingEngine,  # noqa: E402
                                      Engine)

TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen2_moe_a2_7b", "llama4_maverick_400b_a17b", "mamba2_780m",
         "hymba_1_5b"]
_MODELS = {}


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _leaf(rng, key, shape):
    """A weight of the reference's tree drawn with numpy at about its
    init's scale (its uniform(-k, k) by fan-in, its norm scales near 1,
    Mamba2's decay and step-size parameters in their init ranges)."""
    name = key.rsplit("/", 1)[-1]
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name in ("bias", "b"):
        return 0.1 * rng.standard_normal(shape)
    if name == "A_log":
        return np.log(rng.uniform(1.0, 16.0, shape))
    if name == "dt_bias":
        return np.log(np.expm1(rng.uniform(0.001, 0.1, shape)))
    if name == "D":
        return rng.uniform(0.5, 1.5, shape)
    if name == "conv":
        return 0.1 * rng.standard_normal(shape)
    if name == "table":
        return rng.standard_normal(shape) / np.sqrt(shape[-1])
    k = 1.0 / np.sqrt(shape[-1] * (shape[-3] if name in ("w1", "w2") else 1))
    return rng.uniform(-k, k, shape)


def _model(arch, ff_scale=4.0):
    """(jax cfg, jax params, port cfg, port params, flat weights) on the
    same weights, drawn from a numpy seed in the reference's tree."""
    if arch in _MODELS:
        return _MODELS[arch]
    jcfg = jconfigs.get(arch, smoke=True)
    jcfg = jcfg.replace(linear=jcfg.linear.replace(fuse_mlp=True))
    tcfg = tconfigs.get(arch, smoke=True)
    tcfg = tcfg.replace(linear=tcfg.linear.replace(use_kernel=True,
                                                   fuse_ff_kernel=True))
    shapes = jax.eval_shape(
        lambda: jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    flat = {k: _leaf(rng, k, v.shape).astype(np.float32)
            for k, v in flatten_with_paths(shapes).items()}
    for k in flat:
        if k.startswith(("layers/mlp/", "layers/moe/experts/",
                         "layers/moe/shared/")) and k.endswith(("/w1",
                                                               "/w2")):
            flat[k] = flat[k] * np.float32(ff_scale)
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jnp.asarray(flat[k]) for k in flatten_with_paths(shapes)])
    _MODELS[arch] = (jcfg, jp, tcfg, bridge.from_flat(flat, "cpu"), flat)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_bridge_round_trip(arch):
    """The port draws its own weights in the reference's tree (the routed
    experts' leading E axis a tensor axis inside each layer), and the
    bridge carries every leaf across and back exactly."""
    jcfg = jconfigs.get(arch, smoke=True)
    tcfg = tconfigs.get(arch, smoke=True)
    shapes = jax.eval_shape(
        lambda: jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: v.shape for k, v in flatten_with_paths(shapes).items()}
    assert {k: v.shape for k, v in bridge.to_flat(tp).items()} == want
    assert tmodel.param_count(tp) == sum(
        int(np.prod(v)) for v in want.values())
    _, _, _, tp, flat = _model(arch)
    back = bridge.to_flat(tp)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                       else v)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_full_and_smoke_configs_match_reference(arch):
    for smoke in (False, True):
        t = _fields(tconfigs.get(arch, smoke=smoke))
        j = _fields(jconfigs.get(arch, smoke=smoke))
        assert t == {k: j[k] for k in t}, (arch, smoke)
    # the port has every field of the reference's config, the encoder-
    # decoder's and vision model's among them
    assert set(j) - set(t) == set()
    assert tconfigs.get(arch).e_pad == jconfigs.get(arch).e_pad


def test_linear_spec_drops_the_ssm_scope():
    """ROADMAP C.12, followed on purpose: a ``--linear`` spec gets scope
    ``ff`` in both packages, so Mamba2 (no ff module) keeps no DYAD layer
    under it, while its own config keeps ``ff+ssm``."""
    spec = "dyad_it_4_kernel"
    assert tconfigs.get("mamba2_780m").linear.scope == "ff+ssm"
    for get, parse in ((tconfigs.get, tconfigs.linear_cfg),
                       (jconfigs.get, jconfigs.linear_cfg)):
        assert get("mamba2_780m", linear=parse(spec)).linear.scope == "ff"
    cfg = tconfigs.get("mamba2_780m", smoke=True,
                       linear=tconfigs.linear_cfg(spec))
    flat = bridge.to_flat(tmodel.init_params(cfg, torch.Generator(), "cpu"))
    assert not any(k.endswith("/w1") for k in flat)
    jcfg = jconfigs.get("mamba2_780m", smoke=True,
                        linear=jconfigs.linear_cfg(spec))
    shapes = jax.eval_shape(
        lambda: jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    assert set(flatten_with_paths(shapes)) == set(flat)


def test_encdec_and_vlm_still_raise():
    """The encdec and vlm families are ported (tests/test_torch_encdec.py
    holds them against JAX): their configs build and a one-layer model of
    each family inits in the reference's tree.  Only the continuous
    engine still raises for them, as the reference's does."""
    for arch, family in (("whisper_medium", "encdec"),
                         ("phi3_vision_4_2b", "vlm")):
        assert tconfigs.get(arch).family == family
    for family in ("encdec", "vlm"):
        kw = dict(name="x", family=family, n_layers=1, d_model=8,
                  vocab_size=16, n_heads=2, n_kv_heads=2, d_ff=16,
                  n_enc_layers=1, n_frames=3, frontend_dim=4, n_patches=2)
        cfg = ModelCfg(**kw)
        tp = tmodel.init_params(cfg, torch.Generator(), "cpu")
        jp = jax.eval_shape(lambda kw=kw: jmodel.init_params(
            JModelCfg(**kw), jax.random.PRNGKey(0)))
        assert set(bridge.to_flat(tp)) == set(flatten_with_paths(jp))
        with pytest.raises(NotImplementedError, match="token-only"):
            ContinuousBatchingEngine(cfg, tp, n_slots=2, max_len=8,
                                     device="cpu")


def test_new_modules_are_in_the_isolation_scan():
    """``tests/test_torch_model.py``'s scan reads every file of the
    package: the new modules are among them, free of JAX."""
    pkg = ROOT / "src" / "repro_torch"
    for rel in ("layers/moe.py", "layers/ssm.py", "configs/mamba2_780m.py",
                "configs/hymba_1_5b.py", "configs/qwen2_moe_a2_7b.py",
                "configs/llama4_maverick_400b_a17b.py", "layers/frontend.py",
                "configs/whisper_medium.py", "configs/phi3_vision_4_2b.py",
                "configs/phi3_medium_14b.py", "configs/qwen2_5_32b.py",
                "configs/llama3_405b.py"):
        text = (pkg / rel).read_text()
        assert "import jax" not in text and "from repro." not in text


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_prefill_decode_match_jax(arch):
    jcfg, jp, tcfg, tp, _ = _model(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    labels[0, :3] = -1
    nxt = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    tt = torch.from_numpy(toks).long()

    # jitted once per test: the reference's scans compile either way
    jforward = jax.jit(functools.partial(jmodel.forward, jcfg))
    jloss = jax.jit(functools.partial(jmodel.loss_fn, jcfg))
    jprefill = jax.jit(functools.partial(jmodel.prefill, jcfg,
                                         last_only=False))
    jdecode = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    want, jaux = jforward(jp, {"tokens": jnp.asarray(toks)})
    got, taux = tmodel.forward(tcfg, tp, tt, with_aux=True)
    _close(got.numpy(), want)
    _close(taux.numpy(), jaux)
    assert (float(jaux) > 0) == (jcfg.family == "moe")

    jl, jm = jloss(jp, {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(labels)})
    tl, tm = tmodel.loss_fn(tcfg, tp, {"tokens": tt,
                                       "labels": torch.from_numpy(labels)})
    _close(float(tl), float(jl))
    _close(float(tm["loss"]), float(jm["loss"]))
    _close(float(tm["aux"]), float(jm["aux"]))

    jc = jmodel.init_cache(jcfg, 2, 20, jnp.float32)
    want, jc = jprefill(jp, jc, jnp.asarray(toks))
    tc = tmodel.init_cache(tcfg, 2, 20, torch.float32, "cpu")
    got, tc = tmodel.prefill(tcfg, tp, tc, tt, last_only=False)
    _close(got.numpy(), want)
    for _ in range(2):
        want, jc = jdecode(jp, jc, jnp.asarray(nxt))
        got, tc = tmodel.decode_step(tcfg, tp, tc,
                                     torch.from_numpy(nxt).long())
        _close(got.numpy(), want)
        nxt = np.asarray(jnp.argmax(want[:, -1:], axis=-1)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_engine(arch):
    jcfg, jp, tcfg, tp, _ = _model(arch)
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(JEngine(jcfg, jp, max_len=16).generate(
        jnp.asarray(prompts), 8))
    got = Engine(tcfg, tp, max_len=16, device="cpu").generate(
        torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2          # the check is not blind


def test_hymba_prompt_past_the_window():
    """A prompt longer than the window: the prefill attends its in-flight
    K/V and keeps the last ``window`` rows at their ring slots, so decode
    goes on across the wrap; batch (the reference's engine) and per-slot
    (the continuous engine) forms alike."""
    jcfg, jp, tcfg, tp, _ = _model("hymba_1_5b")
    W = tcfg.window
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, W + 4)).astype(np.int32)
    want = np.asarray(JEngine(jcfg, jp, max_len=32).generate(
        jnp.asarray(prompts), 6))
    got = Engine(tcfg, tp, max_len=32, device="cpu").generate(
        torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    eng = ContinuousBatchingEngine(tcfg, tp, n_slots=2, max_len=32,
                                   device="cpu")
    uids = [eng.submit(p, 6) for p in prompts]
    res = eng.run()
    for i, u in enumerate(uids):
        assert res[u] == want[i].tolist()


def _prompts(vocab, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("arch,paged", [
    ("qwen2_moe_a2_7b", True), ("qwen2_moe_a2_7b", False),
    ("mamba2_780m", False), ("hymba_1_5b", False)])
def test_continuous_matches_batch_engine(arch, paged):
    """Each request's greedy tokens from the continuous engine (three
    slots for five requests, so slots are reused: admission must reset
    every leaf of a slot, the SSM states too) equal the batch engine's
    for that prompt alone.  Hymba's prompts fall on both sides of its
    window.  The paged prefill takes each prompt whole: a chunked one
    routes each chunk with its own expert capacity, another function
    (held against the reference's engine in the next test)."""
    _, _, tcfg, tp, _ = _model(arch)
    lengths = ((5, 12, 3, 10, 7) if arch != "hymba_1_5b"
               else (5, 12, 3, 10, 9))
    prompts = _prompts(tcfg.vocab_size, 5, lengths)
    kw = dict(page_size=4) if paged else {}
    eng = ContinuousBatchingEngine(tcfg, tp, n_slots=3, max_len=24,
                                   device="cpu", **kw)
    assert eng.paged == paged
    uids = [eng.submit(p, 6) for p in prompts]
    res = eng.run()
    batch = Engine(tcfg, tp, max_len=24, device="cpu")
    for p, u in zip(prompts, uids):
        want = batch.generate(torch.from_numpy(p)[None].long(), 6)[0]
        assert res[u] == want.tolist(), (arch, len(p))


@pytest.mark.parametrize("arch,kw", [
    ("qwen2_moe_a2_7b", dict(page_size=4, prefill_chunk=4,
                             prefix_cache=True)),
    ("mamba2_780m", {}), ("hymba_1_5b", {})])
def test_continuous_matches_jax_engine(arch, kw):
    """The port's continuous engine against the reference's on the same
    requests (three slots for five; MoE over paged pools with chunked
    prefill, so each chunk routes with its own expert capacity, behind a
    shared prefix the prefix cache hits; Mamba2 and Hymba on dense
    slots, Hymba's prompts on both sides of its window): greedy tokens
    exactly."""
    jcfg, jp, tcfg, tp, _ = _model(arch)
    lengths = ((9, 13, 10, 12, 11) if arch != "hymba_1_5b"
               else (5, 12, 3, 10, 9))
    prompts = _prompts(tcfg.vocab_size, 6, lengths)
    if "prefix_cache" in kw:
        for p in prompts[1:]:
            p[:8] = prompts[0][:8]
    max_new = [9, 4, 6, 3, 5]
    ckw = dict(n_slots=3, max_len=24, **kw)
    jeng = JCEngine(jcfg, jp, cache_dtype=jnp.float32, **ckw)
    teng = ContinuousBatchingEngine(tcfg, tp, device="cpu", **ckw)
    out = []
    for eng in (jeng, teng):
        uids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
        res = eng.run()
        out.append([[int(t) for t in res[u]] for u in uids])
    assert out[1] == out[0]
    assert len({t for row in out[0] for t in row}) > 4    # not blind
    if "prefix_cache" in kw:
        assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] > 0


def test_paged_refuses_ssm_and_hybrid():
    for arch in ("mamba2_780m", "hymba_1_5b"):
        _, _, tcfg, tp, _ = _model(arch)
        with pytest.raises(NotImplementedError, match="dense rings"):
            ContinuousBatchingEngine(tcfg, tp, n_slots=2, max_len=16,
                                     page_size=4, device="cpu")
