"""Port parity for the encoder-decoder and vision families: Whisper-medium
(``encdec``) and Phi-3-vision-4.2B (``vlm``) at smoke size, the port
against the JAX model on the same weights (moved over by
``repro_torch.checkpoint.bridge``): the frontend, the init tree and the
bridge round trip (``enc_layers`` a per-layer list), the configs,
forward and ``loss_fn`` with ``frames`` or ``patches``, prefill (the
cross K/V filled from ``frames``) and decode logits, ``prefill_cross``
plus decode steps against ``forward``, ``Engine.generate`` tokens with
``frames``, the chunked einsum attention (``_chunked_sdpa``,
``_q_block_sdpa``) alone and on a vision forward past ``attn_chunk``, the
serve launcher, and the dense configs Phi-3-medium-14B, Qwen2.5-32B and
Llama-3-405B at smoke size.

The port runs the configs' kernel-routed linear (``use_kernel`` and
``fuse_ff_kernel``), whose CPU route is the kernels' plain versions; the
JAX side the same function on its einsum route (``fuse_mlp`` where the
ff is bias-free: the megakernel's mixed-variant dataflow; Whisper's ff
has biases, so both sides run the per-projection chain).  Logits within
1e-5 x max(|reference|, 1), fp32 on the CPU; tokens exactly.  The ff
weights are scaled by 4 on both sides, so that greedy tokens vary."""
import functools
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
from repro.layers import frontend as jfrontend  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import frontend as tfrontend  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from test_torch_families import _close, _fields, _leaf  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["whisper_medium", "phi3_vision_4_2b"]
DENSE = ["phi3_medium_14b", "qwen2_5_32b", "llama3_405b"]
_MODELS = {}


def _model(arch, ff_scale=4.0, **over):
    """(jax cfg, jax params, port cfg, port params, flat weights) on the
    same weights, drawn from a numpy seed in the reference's tree."""
    key = (arch, ff_scale, tuple(sorted(over.items())))
    if key in _MODELS:
        return _MODELS[key]
    jcfg = jconfigs.get(arch, smoke=True, **over)
    jcfg = jcfg.replace(linear=jcfg.linear.replace(
        fuse_mlp=not jcfg.mlp_bias))
    tcfg = tconfigs.get(arch, smoke=True, **over)
    tcfg = tcfg.replace(linear=tcfg.linear.replace(use_kernel=True,
                                                   fuse_ff_kernel=True))
    shapes = jax.eval_shape(
        lambda: jmodel.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    flat = {k: _leaf(rng, k, v.shape).astype(np.float32)
            for k, v in flatten_with_paths(shapes).items()}
    for k in flat:
        if "/mlp/" in k and k.endswith(("/w1", "/w2")):
            flat[k] = flat[k] * np.float32(ff_scale)
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jnp.asarray(flat[k]) for k in flatten_with_paths(shapes)])
    _MODELS[key] = (jcfg, jp, tcfg, bridge.from_flat(flat, "cpu"), flat)
    return _MODELS[key]


def _inputs(cfg, B, S, seed=1):
    """Tokens, labels (some masked) and the family's frames or patches,
    drawn from a numpy seed: (numpy dict, port keyword dict)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    b["labels"][0, :2] = -1
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    b.update(extra)
    return b, {k: torch.from_numpy(v) for k, v in extra.items()}


@pytest.mark.parametrize("add_positions", [True, False])
def test_frontend_matches_jax(add_positions):
    rng = np.random.default_rng(2)
    w = rng.uniform(-0.25, 0.25, (24, 16)).astype(np.float32)
    b = rng.uniform(-0.25, 0.25, 24).astype(np.float32)
    feats = rng.standard_normal((2, 10, 16)).astype(np.float32)
    want = jfrontend.apply_frontend(
        {"proj": {"w": jnp.asarray(w), "b": jnp.asarray(b)}},
        jnp.asarray(feats), add_positions=add_positions)
    got = tfrontend.apply_frontend(
        {"proj": {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}},
        torch.from_numpy(feats), add_positions=add_positions)
    _close(got.numpy(), want)
    _close(tfrontend.sinusoidal_positions(37, 24).numpy(),
           jfrontend.sinusoidal_positions(37, 24))
    p = tfrontend.init_frontend(torch.Generator().manual_seed(0), 16, 24,
                                device="cpu")
    assert {k: tuple(v.shape) for k, v in p["proj"].items()} == {
        "w": (24, 16), "b": (24,)}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_bridge_round_trip(arch):
    """The port draws its own weights in the reference's tree (the
    encoder's layers a per-layer list of ``n_enc_layers``), and the bridge
    carries every leaf across and back exactly."""
    jcfg = jconfigs.get(arch, smoke=True)
    tcfg = tconfigs.get(arch, smoke=True)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: v.shape for k, v in flatten_with_paths(jparams).items()}
    assert {k: v.shape for k, v in bridge.to_flat(tp).items()} == want
    assert tmodel.param_count(tp) == jmodel.param_count(jparams)
    assert (tmodel.non_embedding_param_count(tp)
            == jmodel.non_embedding_param_count(jparams))
    _, _, _, tp, flat = _model(arch)
    if tcfg.family == "encdec":
        assert len(tp["enc_layers"]) == tcfg.n_enc_layers
        assert "xattn" in tp["layers"][0] and "xnorm" in tp["layers"][0]
    back = bridge.to_flat(tp)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("arch", ARCHS + DENSE)
def test_full_and_smoke_configs_match_reference(arch):
    for smoke in (False, True):
        t = _fields(tconfigs.get(arch, smoke=smoke))
        j = _fields(jconfigs.get(arch, smoke=smoke))
        assert t == {k: j[k] for k in t}, (arch, smoke)
        assert set(j) == set(t)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    jcfg, jp, tcfg, tp, _ = _model(arch)
    b, kw = _inputs(jcfg, 2, 9)
    tt = torch.from_numpy(b["tokens"]).long()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want, _ = jax.jit(functools.partial(jmodel.forward, jcfg))(jp, jb)
    got = tmodel.forward(tcfg, tp, tt, **kw)
    assert got.shape == (2, 9, jcfg.vocab_size)     # text positions only
    _close(got.numpy(), want)
    last = tmodel.forward(tcfg, tp, tt, last_only=True, **kw)
    _close(last.numpy(), np.asarray(want)[:, -1:])
    jl, jm = jax.jit(functools.partial(jmodel.loss_fn, jcfg))(jp, jb)
    tl, tm = tmodel.loss_fn(tcfg, tp, {"tokens": tt,
                                       "labels": torch.from_numpy(
                                           b["labels"]), **kw})
    _close(float(tl), float(jl))
    _close(float(tm["loss"]), float(jm["loss"]))


def test_encdec_forward_needs_frames():
    _, _, tcfg, tp, _ = _model("whisper_medium")
    with pytest.raises(ValueError, match="frames"):
        tmodel.forward(tcfg, tp, torch.zeros(1, 3, dtype=torch.long))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill (the cross K/V filled from ``frames`` first) and two decode
    steps; a vision model serves text only."""
    jcfg, jp, tcfg, tp, _ = _model(arch)
    b, kw = _inputs(jcfg, 2, 7, seed=4)
    frames = kw.get("frames")
    jframes = None if frames is None else jnp.asarray(b["frames"])
    nxt = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    jc = jmodel.init_cache(jcfg, 2, 16, jnp.float32)
    want, jc = jax.jit(functools.partial(
        jmodel.prefill, jcfg, last_only=False))(
        jp, jc, jnp.asarray(b["tokens"]), frames=jframes)
    tc = tmodel.init_cache(tcfg, 2, 16, torch.float32, "cpu")
    if frames is not None:
        assert tc[0]["xk"].shape == (2, tcfg.n_frames, tcfg.n_kv_heads,
                                     tcfg.hd)
    got, tc = tmodel.prefill(tcfg, tp, tc,
                             torch.from_numpy(b["tokens"]).long(),
                             frames=frames, last_only=False)
    _close(got.numpy(), want)
    jdecode = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    for _ in range(2):
        want, jc = jdecode(jp, jc, jnp.asarray(nxt))
        got, tc = tmodel.decode_step(tcfg, tp, tc,
                                     torch.from_numpy(nxt).long())
        _close(got.numpy(), want)
        nxt = np.asarray(jnp.argmax(want[:, -1:], axis=-1)).astype(np.int32)


def test_prefill_cross_and_decode_match_forward():
    """The reference's ``test_encdec_cross_prefill_matches_forward`` on the
    port: ``prefill_cross`` then one decode step a token gives the full
    forward's logits; so do ``prefill`` with ``frames`` and the
    token-by-token prefill of ``serve.engine``."""
    _, _, tcfg, tp, _ = _model("whisper_medium")
    b, kw = _inputs(tcfg, 2, 6, seed=6)
    toks = torch.from_numpy(b["tokens"]).long()
    full = tmodel.forward(tcfg, tp, toks, frames=kw["frames"])
    cache = tmodel.init_cache(tcfg, 2, 6, torch.float32, "cpu")
    cache = tmodel.prefill_cross(tcfg, tp, cache, kw["frames"])
    outs = []
    for t in range(6):
        lo, cache = tmodel.decode_step(tcfg, tp, cache, toks[:, t:t + 1])
        outs.append(lo)
    _close(torch.cat(outs, 1).numpy(), full.numpy())
    cache = tmodel.init_cache(tcfg, 2, 6, torch.float32, "cpu")
    one, _ = tengine.prefill(tcfg, tp, cache, toks, kw["frames"])
    cache = tmodel.init_cache(tcfg, 2, 6, torch.float32, "cpu")
    tok, _ = tengine.prefill_tokenwise(tcfg, tp, cache, toks, kw["frames"])
    _close(one.numpy(), full[:, -1:].numpy())
    _close(tok.numpy(), full[:, -1:].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_engine(arch):
    jcfg, jp, tcfg, tp, _ = _model(arch)
    b, kw = _inputs(jcfg, 2, 9, seed=7)
    jframes = jnp.asarray(b["frames"]) if "frames" in b else None
    want = np.asarray(jengine.Engine(jcfg, jp, max_len=16).generate(
        jnp.asarray(b["tokens"]), 8, frames=jframes))
    got = tengine.Engine(tcfg, tp, max_len=16, device="cpu").generate(
        torch.from_numpy(b["tokens"]), 8, frames=kw.get("frames"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2          # the check is not blind


def _qkv(B, S, T, K, G, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, K, G, h)).astype(np.float32),
            rng.standard_normal((B, T, K, h)).astype(np.float32),
            rng.standard_normal((B, T, K, h)).astype(np.float32))


# (S, T, chunk, q offset, causal, window, per-batch kpos): ragged key
# tails, a window, non-causal, and per-slot key positions with dead rows
CHUNKED = [(5, 11, 4, 6, True, None, False), (5, 11, 4, 6, True, 3, False),
           (7, 9, 4, 0, False, None, False), (3, 12, 5, 9, True, None, True)]


@pytest.mark.parametrize("case", CHUNKED)
def test_chunked_sdpa_matches_jax(case):
    S, T, chunk, off, causal, window, per_batch = case
    q, k, v = _qkv(2, S, T, 2, 2, 8, seed=S + T)
    qpos = np.arange(S) + off
    kpos = np.arange(T)
    if per_batch:
        kpos = np.stack([np.where(kpos < 10, kpos, -(10 ** 9)),
                         np.where(kpos < 7, kpos, -(10 ** 9))])
    want = jattn._chunked_sdpa(*map(jnp.asarray, (q, k, v, qpos, kpos)),
                               causal, window, chunk)
    got = tattn._chunked_sdpa(*map(torch.from_numpy, (q, k, v)),
                              torch.from_numpy(qpos),
                              torch.from_numpy(kpos), causal, window, chunk)
    _close(got.numpy(), want)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_q_block_sdpa_matches_jax(causal, window):
    """Query blocks of 4 over 14 keys (a ragged last key chunk), the band
    skip on the causal and windowed cases."""
    q, k, v = _qkv(2, 12, 14, 2, 2, 8, seed=3)
    qpos, kpos = np.arange(12) + 2, np.arange(14)
    want = jattn._q_block_sdpa(*map(jnp.asarray, (q, k, v, qpos, kpos)),
                               causal, window, 4)
    got = tattn._q_block_sdpa(*map(torch.from_numpy, (q, k, v, qpos, kpos)),
                              causal, window, 4)
    _close(got.numpy(), want)


@pytest.mark.parametrize("text,name", [(10, "_q_block_sdpa"),
                                       (9, "_chunked_sdpa")])
def test_vision_forward_past_the_chunk_matches_jax(text, name, monkeypatch):
    """Phi-3-vision's default route past ``attn_chunk``, at smoke size: 6
    patches and 10 text tokens make 16 positions, a multiple of the chunk
    of 4 (``_q_block_sdpa``), 9 make 15 (``_chunked_sdpa``); then a
    prefill and decode step over a 20-row cache (``_chunked_sdpa``)."""
    jcfg, jp, tcfg, tp, _ = _model("phi3_vision_4_2b", attn_chunk=4)
    taken = []
    fn = getattr(tattn, name)
    monkeypatch.setattr(tattn, name,
                        lambda *a, **k: taken.append(name) or fn(*a, **k))
    b, kw = _inputs(jcfg, 2, text, seed=8)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want, _ = jmodel.forward(jcfg, jp, jb)
    got = tmodel.forward(tcfg, tp, torch.from_numpy(b["tokens"]).long(),
                         **kw)
    _close(got.numpy(), want)
    assert len(taken) == tcfg.n_layers
    jc = jmodel.init_cache(jcfg, 2, 20, jnp.float32)
    want, jc = jmodel.prefill(jcfg, jp, jc, jnp.asarray(b["tokens"]),
                              last_only=False)
    tc = tmodel.init_cache(tcfg, 2, 20, torch.float32, "cpu")
    got, tc = tmodel.prefill(tcfg, tp, tc,
                             torch.from_numpy(b["tokens"]).long(),
                             last_only=False)
    _close(got.numpy(), want)
    nxt = np.asarray(jnp.argmax(want[:, -1:], axis=-1)).astype(np.int32)
    want, _ = jmodel.decode_step(jcfg, jp, jc, jnp.asarray(nxt))
    got, _ = tmodel.decode_step(tcfg, tp, tc, torch.from_numpy(nxt).long())
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_smoke_forward_matches_jax(arch):
    """The dense configs run the lm path the port has held since Qwen3:
    held against JAX at smoke size (at full size Qwen2.5-32B and
    Llama-3-405B need several cards)."""
    jcfg, jp, tcfg, tp, _ = _model(arch)
    b, _ = _inputs(jcfg, 2, 8, seed=9)
    want, _ = jmodel.forward(jcfg, jp, {"tokens": jnp.asarray(b["tokens"])})
    got = tmodel.forward(tcfg, tp, torch.from_numpy(b["tokens"]).long())
    _close(got.numpy(), want)


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get("gpt2")
    assert set(tconfigs.PORTED_ARCHS) == set(
        jconfigs.ARCHS + jconfigs.PAPER_ARCHS)


@pytest.mark.parametrize("arch,name", [
    ("whisper_medium", "whisper-medium-smoke"),
    ("phi3_vision_4_2b", "phi3-vision-smoke")])
def test_serve_launcher_cpu_smoke(arch, name):
    """The batch launcher feeds an encoder-decoder random frames from its
    seeded generator and serves a vision model text only."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6",
         "--new-tokens", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"[serve] {name} on cpu: generated (2, 4)" in r.stdout

