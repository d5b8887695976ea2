"""Port parity for quantized serving: the weight codec and its sidecars
(bit for bit with ``repro.quant``, carried through the bridge), the plain
versions of ``dyad_mm_blocks_q``, ``dyad_mm_blocks_two_q`` and
``dyad_ff_fused_q`` against the JAX Pallas kernels in interpret mode,
``ops.dyad_mm_quant`` and ``ops.dyad_ff_quant`` on the fused and split
routes, the dispatch in ``factory.apply`` and ``apply_mlp`` with its
fallbacks, greedy tokens of the batch and paged continuous engines on
bridged quantized weights, the engine's ``quant`` rung and the serve
launcher's ``--quant-weights``.  Inputs come from numpy with a seed; on the
CPU every wrapper takes its plain version.

Tolerance, for a contraction of length L, as in
``tests/test_torch_ff.py``: tol x max(|reference|, 1) x max(1,
sqrt(L / 128)), tol 1e-5 in fp32 (the sums run in another order than the
tiled Pallas kernels, and each scale multiplies a whole sum here where
the TPU kernel multiplies each k step's partial) and 2e-2 in bf16 (the
outputs, and the hidden before the down product, are rounded to bf16)."""
import math
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
from repro import quant as jquant  # noqa: E402
from repro.checkpoint.manager import flatten_with_paths  # noqa: E402
from repro.core import factory as jfactory  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.dyad_mm import dyad_ff_fused_q as j_ff_q  # noqa: E402
from repro.layers import mlp as jmlp  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve.engine import ContinuousBatchingEngine as JCEngine  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.core import factory  # noqa: E402
from repro_torch.kernels import dyad_mm, ops  # noqa: E402
from repro_torch.layers import mlp  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QDTYPES = ["int8", "fp8"]
ACTS = ["gelu", "relu", "silu", "swiglu"]
WRAPPERS = (dyad_mm.dyad_mm_blocks_q, dyad_mm.dyad_mm_blocks_two_q,
            dyad_mm.dyad_ff_fused_q)


@pytest.fixture(autouse=True)
def _clean_routes(monkeypatch):
    for var in ("REPRO_KERNEL_FF", "REPRO_KERNEL_QUANT", "REPRO_KERNEL_ATTN"):
        monkeypatch.delenv(var, raising=False)


def _close(got, want, L=1, dtype="float32"):
    tol = TOL[dtype] * max(1.0, math.sqrt(L / 128))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.max(np.abs(want))), 1.0) if want.size else 1.0
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _t(a):
    """A JAX or numpy array as a CPU tensor of the same bits (fp8 too)."""
    return bridge.from_flat({"a": np.asarray(a)}, "cpu")["a"]


def _x(shape, dtype, seed):
    """The same activations as a JAX array and a torch tensor."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a).astype(JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TDT[dtype])


def _qw(shape, qdtype, seed):
    """A weight at the init scale, quantized by the reference: the JAX
    (payload, scales) and the same bits as tensors."""
    w = (np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
         / math.sqrt(shape[-1]))
    q, s = jquant.quantize_dyad_weight(jnp.asarray(w), qdtype)
    return (q, s), (_t(q), _t(s))


def _leaves(tree, prefix=""):
    """{path: tensor} of a port tree, lists indexed."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {prefix: tree}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


# -- the codec and the sidecars ----------------------------------------------


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_sidecars_equal_jax_bit_for_bit(qdtype):
    """``quantize_params`` on the port's tree (a list of layers) gives the
    sidecars the reference gives on its layer-stacked tree, byte for byte
    once the bridge carries them over; ``to_flat`` writes the payloads as
    fp32 values, exactly."""
    jcfg = jconfigs.get("qwen3_0_6b", smoke=True,
                        linear=jconfigs.linear_cfg("dyad_it_4_kernel_ffused"))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(jp).items()}
    jq = {k: np.asarray(v) for k, v in
          flatten_with_paths(jquant.quantize_params(jp, qdtype)).items()}
    want = _leaves(bridge.from_flat(jq, "cpu"))
    got = _leaves(quant.quantize_params(bridge.from_flat(flat, "cpu"),
                                        qdtype))
    assert sorted(got) == sorted(want)
    names = [k for k in got if k.endswith(("_q", "_s"))]
    assert len(names) == 2 * 3 * 4       # 2 layers x gate/up/down x 4
    qdt = quant.resolve_dtype(qdtype)[0]
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
        if k.endswith("_q"):
            assert got[k].dtype == qdt
    back = bridge.to_flat(quant.quantize_params(
        bridge.from_flat(flat, "cpu"), qdtype))
    for k, v in jq.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32))


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_every_payload_value_is_a_bf16_value(qdtype):
    """The premise of the quantized kernels' bf16 tensor-core routes: each
    of the 256 int8 values and of the 254 finite float8_e4m3fn values
    converts to bf16 exactly (its fp32 value, as the reference's
    ``w.astype(x.dtype)`` gives it) and back to the same payload bits, so
    a bf16 product with the converted payload is the reference's."""
    bits = torch.arange(256, dtype=torch.int16).to(torch.uint8)
    q = bits.view(torch.int8 if qdtype == "int8" else torch.float8_e4m3fn)
    f = q.float()
    finite = torch.isfinite(f)
    assert int(finite.sum()) == (256 if qdtype == "int8" else 254)
    b = q[finite].to(torch.bfloat16)
    assert torch.equal(b.float(), f[finite])
    assert torch.equal(b.to(q.dtype).view(torch.uint8), bits[finite])
    jq = jax.lax.bitcast_convert_type(
        jnp.asarray(bits[finite].numpy()),
        jnp.int8 if qdtype == "int8" else jnp.float8_e4m3fn)
    np.testing.assert_array_equal(
        np.asarray(jq.astype(jnp.bfloat16).astype(jnp.float32)),
        f[finite].numpy())


def test_codec_contract_and_guards():
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 17, 29)).astype(np.float32))
    for qdtype, qmax in (("int8", 127.0), ("fp8", 448.0)):
        q, s = quant.quantize_dyad_weight(w, qdtype)
        assert q.shape == w.shape and s.shape == (3, 17)
        assert s.dtype == torch.float32
        np.testing.assert_allclose(
            s.numpy(), w.abs().amax(-1).numpy() / qmax + 1e-12, rtol=1e-6)
        err = (quant.dequant(q, s, -1) - w).abs()
        if qdtype == "int8":
            assert bool((err <= 0.5 * s[..., None] + 1e-7).all())
        else:
            assert float((err / s[..., None]).max()) < 32.0
    with pytest.raises(ValueError, match="DYAD"):
        quant.quantize_dyad_weight(torch.zeros(8, 8))
    with pytest.raises(ValueError, match="unknown quantization dtype"):
        quant.quantize_params({}, "int4")
    lc = factory.LinearCfg(impl="dyad", n_dyad=2, variant="it")
    p = mlp.init_mlp(torch.Generator().manual_seed(0), 16, 32, lc,
                     act="gelu", bias=True)
    qp = quant.quantize_params(p, "int8")
    assert quant.ff_quantized(qp) and not quant.ff_quantized(p)
    assert quant.module_quantized(qp["up"])
    assert not quant.module_quantized(p["up"])
    assert not quant.ff_quantized({"up": qp["up"]})
    assert qp["up"]["w1"] is p["up"]["w1"] and qp["up"]["b"] is p["up"]["b"]
    assert "w1_q" not in p["up"]                 # the input tree is kept
    # the per-tensor codec, bit for bit with the reference's
    g = np.random.default_rng(2).standard_normal((5, 33)).astype(np.float32)
    jq, js = jquant.quant_int8(jnp.asarray(g))
    tq, ts = quant.quant_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and ts.dim() == 0
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(quant.dequant_int8(tq, ts).numpy(),
                                  np.asarray(jquant.dequant_int8(jq, js)))


def test_quantization_switches(monkeypatch):
    assert quant.enabled()
    with quant.disabled():
        assert not quant.enabled()
        with quant.disabled(False):          # does not lift an outer one
            assert not quant.enabled()
    with quant.disabled(False):
        assert quant.enabled()
    monkeypatch.setenv("REPRO_KERNEL_QUANT", "off")
    assert not quant.enabled()
    assert quant.supports_fp8()


# -- the kernels' plain versions against Pallas -------------------------------

# (B, n, d_in, d_out): the reference's ``tests/test_quant.py`` shapes, odd
# and prime dims among them
MM_SHAPES = [(16, 4, 32, 32), (9, 3, 70, 130), (7, 2, 129, 67)]


@pytest.mark.parametrize("dtype,shape", [("float32", s) for s in MM_SHAPES]
                         + [("bfloat16", MM_SHAPES[1])])
@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("variant", ["it", "ot", "dt"])
def test_quant_mm_plain_matches_pallas(variant, qdtype, dtype, shape):
    """``ops.dyad_mm_quant`` (``dyad_mm_blocks_q`` for IT,
    ``dyad_mm_blocks_two_q`` and ``combine`` for OT/DT) against the
    reference's, which runs the Pallas kernels in interpret mode."""
    B, n, d_in, d_out = shape
    jx, tx = _x((B, n * d_in), dtype, seed=B + d_in)
    (jq1, js1), (tq1, ts1) = _qw((n, d_out, d_in), qdtype, seed=1)
    (jq2, js2), (tq2, ts2) = _qw((n, d_out, d_in), qdtype, seed=2)
    want = jops.dyad_mm_quant(jx, jq1, jq2, js1, js2, variant=variant)
    before = [w.launches for w in WRAPPERS]
    got = ops.dyad_mm_quant(tx, tq1, tq2, ts1, ts2, variant=variant)
    assert [w.launches for w in WRAPPERS] == before
    assert got.shape == (B, n * d_out) and got.dtype == TDT[dtype]
    _close(got, want, d_in, dtype)


FF_SHAPES = [
    # (M, n, d_in_b, d_ff_b, d_out_b): odd and prime dims, then Qwen3
    # smoke's widths (d 64, d_ff 96, n 4)
    (3, 2, 129, 130, 17),
    (8, 4, 16, 24, 16),
]


@pytest.mark.parametrize("dtype,shape", [("float32", FF_SHAPES[0]),
                                         ("bfloat16", FF_SHAPES[1])])
@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_quant_ff_plain_matches_pallas(act, qdtype, dtype, shape):
    M, n, d_in, d_ff, d_out = shape
    jx1, tx1 = _x((M, n, d_in), dtype, seed=M)
    jx2, tx2 = _x((M, n, d_in), dtype, seed=M + 1)
    ups = [_qw((n, d_ff, d_in), qdtype, seed=10 + i) for i in range(4)]
    downs = [_qw((n, d_out, d_ff), qdtype, seed=20 + i) for i in range(2)]
    gated = act == "swiglu"
    (ju, tu), (jd, td) = zip(*ups), zip(*downs)
    jgate = (dict(wg1=ju[2][0], wg2=ju[3][0], sg1=ju[2][1], sg2=ju[3][1])
             if gated else {})
    tgate = (dict(wg1=tu[2][0], wg2=tu[3][0], sg1=tu[2][1], sg2=tu[3][1])
             if gated else {})
    want = j_ff_q(jx1, jx2, ju[0][0], ju[1][0], jd[0][0], jd[1][0],
                  ju[0][1], ju[1][1], jd[0][1], jd[1][1], act=act,
                  interpret=True, **jgate)
    before = [w.launches for w in WRAPPERS]
    got = dyad_mm.dyad_ff_fused_q(tx1, tx2, tu[0][0], tu[1][0], td[0][0],
                                  td[1][0], tu[0][1], tu[1][1], td[0][1],
                                  td[1][1], act=act, **tgate)
    assert [w.launches for w in WRAPPERS] == before
    for a, b in zip(got, want):
        assert a.shape == (M, n, d_out) and a.dtype == TDT[dtype]
        _close(a, b, max(d_in, d_ff), dtype)


def test_quant_wrappers_refuse_what_is_not_a_payload():
    """No wrapper takes a dequantized or cast weight: a payload that is not
    int8 or fp8, or scales that are not fp32 (n, rows), raise on either
    device; so do the gate arguments the reference insists on."""
    x = torch.zeros(2, 2, 8)
    q, s = torch.zeros(2, 4, 8, dtype=torch.int8), torch.ones(2, 4)
    with pytest.raises(TypeError, match="payload"):
        dyad_mm.dyad_mm_blocks_q(x, x, q.float(), q, s, s)
    with pytest.raises(TypeError, match="payload"):
        dyad_mm.dyad_mm_blocks_two_q(x, x, q, q.bfloat16(), s, s)
    with pytest.raises(TypeError, match="scales"):
        dyad_mm.dyad_mm_blocks_q(x, x, q, q, s.double(), s)
    with pytest.raises(TypeError, match="scales"):
        dyad_mm.dyad_mm_blocks_q(x, x, q, q, s[:, :2], s)
    qd, sd = torch.zeros(2, 3, 4, dtype=torch.int8), torch.ones(2, 3)
    with pytest.raises(TypeError, match="payload"):
        dyad_mm.dyad_ff_fused_q(x, x, q, q, qd.float(), qd, s, s, sd, sd)
    with pytest.raises(ValueError, match="sg1/sg2"):
        dyad_mm.dyad_ff_fused_q(x, x, q, q, qd, qd, s, s, sd, sd, wg1=q,
                                wg2=q, act="swiglu")
    with pytest.raises(ValueError, match="exactly when"):
        dyad_mm.dyad_ff_fused_q(x, x, q, q, qd, qd, s, s, sd, sd,
                                act="swiglu")


# -- the ops and their routes ------------------------------------------------


def _mlp_pair(act, qdtype, d=32, d_ff=48, n=4, bias=False, seed=5,
              spec="dyad_it_4_kernel_ffused"):
    """(jax params, port params, jax cfg, port cfg) of one quantized ff
    module on the same weights, each side quantized by its own codec."""
    jlc = jconfigs.linear_cfg(spec).replace(n_dyad=n, quant=qdtype)
    tlc = tconfigs.linear_cfg(spec).replace(n_dyad=n, quant=qdtype)
    jp = jmlp.init_mlp(jax.random.PRNGKey(seed), d, d_ff, jlc, act=act,
                       bias=bias)
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(jp).items()}
    tp = quant.quantize_params(bridge.from_flat(flat, "cpu"), qdtype)
    return jquant.quantize_params(jp, qdtype), tp, jlc, tlc


@pytest.mark.parametrize("route,act,dtype", [
    ("fused", a, "float32") for a in ACTS] + [
    ("split", a, "float32") for a in ACTS] + [
    ("fused", "swiglu", "bfloat16"), ("split", "swiglu", "bfloat16")])
def test_dyad_ff_quant_routes_match_jax(route, act, dtype, monkeypatch):
    """``ops.dyad_ff_quant`` on the fused route (``dyad_ff_fused_q``) and
    the split route (``dyad_mm_blocks_q``, the activation,
    ``dyad_mm_blocks_two_q``) against the reference's on the same route
    (``REPRO_KERNEL_FF`` reaches both)."""
    monkeypatch.setenv("REPRO_KERNEL_FF", route)
    jp, tp, _, _ = _mlp_pair(act, "int8", seed=len(act))
    jx, tx = _x((2, 5, 32), dtype, seed=3)
    want = jops.dyad_ff_quant(jp, jx, act=act)
    got = ops.dyad_ff_quant(tp, tx, act=act)
    assert got.shape == (2, 5, 32) and got.dtype == TDT[dtype]
    _close(got, want, 48, dtype)


def test_ff_quant_routes_follow_ff_route(monkeypatch):
    """``force_ff_route`` and ``REPRO_KERNEL_FF`` pick the quantized route
    as they pick the fp one."""
    _, tp, _, _ = _mlp_pair("swiglu", "fp8")
    tx = _x((4, 32), "float32", seed=4)[1]
    seen = []
    for name in ("dyad_ff_fused_q", "dyad_mm_blocks_q",
                 "dyad_mm_blocks_two_q"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **k: (
            seen.append(_n), _r(*a, **k))[1])
    fused = ops.dyad_ff_quant(tp, tx, act="swiglu")
    assert seen == ["dyad_ff_fused_q"]
    seen.clear()
    with ops.force_ff_route("split"):
        split = ops.dyad_ff_quant(tp, tx, act="swiglu")
    assert seen == ["dyad_mm_blocks_q", "dyad_mm_blocks_q",
                    "dyad_mm_blocks_two_q"]
    _close(split, fused.numpy(), 48)


@pytest.mark.parametrize("variant", ["it", "ot", "dt"])
def test_factory_apply_quant_with_bias_matches_jax(variant):
    """The OPT projections: a biased DYAD linear through ``factory.apply``
    takes the quantized kernels and adds its bias outside them."""
    spec = f"dyad_{variant}_4_kernel"
    jlc = jconfigs.linear_cfg(spec).replace(quant="int8")
    tlc = tconfigs.linear_cfg(spec).replace(quant="int8")
    jp = jfactory.init(jax.random.PRNGKey(2), 48, 96, jlc, bias=True)
    jp = dict(jp, b=jnp.linspace(-1, 1, 96))
    flat = {k: np.asarray(v) for k, v in jp.items()}
    tp = quant.quantize_params(bridge.from_flat(flat, "cpu"), "int8")
    jx, tx = _x((3, 4, 48), "float32", seed=6)
    want = jfactory.apply(jquant.quantize_params(jp, "int8"), jx, jlc)
    got = factory.apply(tp, tx, tlc)
    _close(got, want, 12)
    fp = factory.apply(bridge.from_flat(flat, "cpu"), tx, tlc)
    assert not torch.equal(got, fp)          # the sidecars were read


@pytest.mark.parametrize("act,qdtype", [("gelu", "int8"), ("swiglu", "fp8")])
def test_apply_mlp_quant_matches_jax(act, qdtype):
    jp, tp, jlc, tlc = _mlp_pair(act, qdtype)
    jx, tx = _x((3, 32), "float32", seed=8)
    _close(mlp.apply_mlp(tp, tx, tlc, act=act),
           jmlp.apply_mlp(jp, jx, jlc, act=act), 48)


def test_quant_dispatch_falls_back_to_the_fp_routes(monkeypatch):
    """Without sidecars, with ``REPRO_KERNEL_QUANT=off`` or inside
    ``quant.disabled()`` the ff runs its fp route and gives the
    unquantized output bit for bit; a config without ``quant`` ignores
    sidecars."""
    _, tp, _, tlc = _mlp_pair("swiglu", "int8")
    fp_tree = {k: {w: v[w] for w in ("w1", "w2")} for k, v in tp.items()}
    tx = _x((3, 32), "float32", seed=9)[1]
    calls = []
    real = ops.dyad_ff_quant
    monkeypatch.setattr(ops, "dyad_ff_quant",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = mlp.apply_mlp(fp_tree, tx, tlc, act="swiglu")
    assert calls == []
    quantized = mlp.apply_mlp(tp, tx, tlc, act="swiglu")
    assert calls == [1] and not torch.equal(quantized, want)
    with quant.disabled():
        assert torch.equal(mlp.apply_mlp(tp, tx, tlc, act="swiglu"), want)
    assert torch.equal(mlp.apply_mlp(tp, tx, tlc.replace(quant=None),
                                     act="swiglu"), want)
    monkeypatch.setenv("REPRO_KERNEL_QUANT", "off")
    assert torch.equal(mlp.apply_mlp(tp, tx, tlc, act="swiglu"), want)
    assert torch.equal(factory.apply(tp["up"], tx, tlc),
                       factory.apply(fp_tree["up"], tx, tlc))
    assert calls == [1]


# -- the slice: greedy tokens of the engines ---------------------------------


def _quant_model(arch, spec, qdtype, ff_scale=4.0):
    """(jax cfg, jax params, port cfg, port params): the smoke config on
    the same weights, the ff weights scaled by ``ff_scale`` (at the init
    scale greedy decoding repeats one token), then quantized by each
    side's codec."""
    jcfg = jconfigs.get(arch, smoke=True, linear=jconfigs.linear_cfg(spec))
    tcfg = tconfigs.get(arch, smoke=True, linear=tconfigs.linear_cfg(spec))
    assert jcfg.linear.quant == tcfg.linear.quant == qdtype
    tree = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(tree).items()}
    for k in flat:
        if k.startswith("layers/mlp/") and k.endswith(("/w1", "/w2")):
            flat[k] = flat[k] * np.float32(ff_scale)
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [jnp.asarray(flat[k]) for k in flatten_with_paths(tree)])
    return (jcfg, jquant.quantize_params(jp, qdtype), tcfg,
            quant.quantize_params(bridge.from_flat(flat, "cpu"), qdtype))


@pytest.mark.parametrize("arch,spec,qdtype", [
    ("qwen3_0_6b", "dyad_it_4_kernel_ffused_w8", "int8"),
    ("qwen3_0_6b", "dyad_it_4_kernel_ffused_wfp8", "fp8"),
    ("opt125m", "dyad_it_4_kernel_w8", "int8"),
])
def test_quantized_generate_matches_jax_engine(arch, spec, qdtype):
    jcfg, jp, tcfg, tp = _quant_model(arch, spec, qdtype)
    prompts = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    want = np.asarray(JEngine(jcfg, jp, max_len=16).generate(
        jnp.asarray(prompts), 9))
    got = tengine.Engine(tcfg, tp, max_len=16, device="cpu").generate(
        torch.from_numpy(prompts), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 2          # the check is not blind


def test_quantized_paged_continuous_int8_pools_match_jax_engine():
    """The README's quantized serving command at smoke size: int8 weights
    through the megakernel, int8 page pools, chunked prefill, prefix
    cache, in the paged continuous engine of both packages."""
    jcfg, jp, tcfg, tp = _quant_model("qwen3_0_6b",
                                      "dyad_it_4_kernel_ffused_w8", "int8")
    jcfg, tcfg = jcfg.replace(kv_quant="int8"), tcfg.replace(kv_quant="int8")
    # a shared 8-token prefix; the first request outlives the second, so
    # its prefix pages are live when the queued requests are admitted
    rng = np.random.default_rng(3)
    head = rng.integers(0, jcfg.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(0, jcfg.vocab_size, n)
                               .astype(np.int32)]) for n in (1, 5, 2, 4)]
    max_new = [6, 4, 7, 5]
    kw = dict(n_slots=3, max_len=20, page_size=4, prefill_chunk=4,
              prefix_cache=True)
    j = JCEngine(jcfg, jp, **kw)
    juids = [j.submit(jnp.asarray(p), m) for p, m in zip(prompts, max_new)]
    jres = j.run()
    t = tengine.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    tuids = [t.submit(torch.from_numpy(p), m)
             for p, m in zip(prompts, max_new)]
    tres = t.run()
    want = [list(map(int, jres[u])) for u in juids]
    assert [tres[u] for u in tuids] == want
    assert len({x for w in want for x in w}) > 2
    assert t.stats["prefix_hits"] == j.stats["prefix_hits"] > 0


# -- the engine's quant rung --------------------------------------------------


def _drive(eng, prompts, new=5):
    uids = [eng.submit(torch.from_numpy(p), new) for p in prompts]
    res = eng.run()
    return [res[u] for u in uids]


def test_quant_rung_recovers_corrupt_sidecars_in_the_engine(monkeypatch):
    """Sidecars that turn to NaN after the prompts were prefilled defeat
    the same-route retry; the ``quant`` rung, held in the engine, then
    serves what an engine that stopped reading the sidecars at that point
    serves, without touching the environment, while another engine in the
    process keeps the quantized route; ``reset_demotions`` restores it."""
    _, _, tcfg, tp = _quant_model("qwen3_0_6b", "dyad_it_4_kernel_ffused_w8",
                                  "int8")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (6, 4)]

    def engine(params):
        eng = tengine.ContinuousBatchingEngine(tcfg, params, n_slots=2,
                                               max_len=24, device="cpu")
        uids = [eng.submit(torch.from_numpy(p), 6) for p in prompts]
        eng.step()                       # admission: both prompts prefilled
        return eng, uids

    ref, uids = engine(tp)
    with quant.disabled():
        res = ref.run()
    want = [res[u] for u in uids]
    clean = _drive(tengine.ContinuousBatchingEngine(
        tcfg, tp, n_slots=2, max_len=24, device="cpu"), prompts)
    assert clean != want                 # the two routes part
    bad = dict(tp, layers=[dict(lp, mlp={k: dict(v, w1_s=v["w1_s"].clone())
                                         for k, v in lp["mlp"].items()})
                           for lp in tp["layers"]])
    eng, uids = engine(bad)
    for lp in bad["layers"]:
        for proj in lp["mlp"].values():
            proj["w1_s"].fill_(float("nan"))
    res = eng.run()
    c = eng.metrics_summary()["counters"]
    assert [res[u] for u in uids] == want
    assert eng.demoted == ["quant"]
    assert c["demotions"] == 1 and c["nan_steps"] == 2
    assert eng.metrics_summary()["demoted"] == ["quant"]
    assert "REPRO_KERNEL_QUANT" not in os.environ and quant.enabled()
    assert _drive(tengine.ContinuousBatchingEngine(
        tcfg, tp, n_slots=2, max_len=24, device="cpu"), prompts) == clean
    enabled = []
    real = ops.dyad_ff_quant
    monkeypatch.setattr(ops, "dyad_ff_quant", lambda *a, **k: (
        enabled.append(quant.enabled()), real(*a, **k))[1])
    eng.reset_demotions()
    assert eng.demoted == []
    eng.params = tp
    _drive(eng, prompts, new=2)
    assert enabled and all(enabled)


def test_quant_ladder_walks_both_rungs_to_faulted():
    """NaN everywhere (the final norm): the retry, then the ``quant`` and
    ``ff`` rungs, each taken once and held in the engine (the process's
    environment and routes untouched), then the lanes retire FAULTED."""
    _, _, tcfg, tp = _quant_model("qwen3_0_6b", "dyad_it_4_kernel_ffused_w8",
                                  "int8")
    bad = dict(tp, final_norm={k: torch.full_like(v, float("nan"))
                               for k, v in tp["final_norm"].items()})
    eng = tengine.ContinuousBatchingEngine(tcfg, bad, n_slots=2, max_len=24,
                                           device="cpu", page_size=4)
    rng = np.random.default_rng(6)
    res = _drive(eng, [rng.integers(0, 256, n).astype(np.int32)
                       for n in (5, 4)])
    c = eng.metrics_summary()["counters"]
    assert eng.demoted == ["quant", "ff"]
    assert c["demotions"] == 2 and c["nan_steps"] == 4
    assert c["retired_faulted"] == 2 and all(len(r) == 1 for r in res)
    assert not any(v in os.environ for v in ("REPRO_KERNEL_FF",
                                             "REPRO_KERNEL_QUANT"))
    assert quant.enabled() and ops.ff_route() == "fused"
    eng.reset_demotions()
    assert eng.demoted == []


# -- the launcher -------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--linear", "dyad_it_4_kernel_ffused", "--quant-weights", "int8"],
    ["--linear", "dyad_it_4_kernel_ffused", "--quant-weights", "fp8",
     "--engine", "continuous", "--page-size", "4", "--quant-kv", "int8",
     "--requests", "3", "--slots", "2"],
])
def test_serve_launcher_quant_weights_cpu(extra):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3_0_6b", "--smoke", "--device", "cpu", "--new-tokens", "4",
         *extra], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr
    qdtype = extra[extra.index("--quant-weights") + 1]
    assert f"[serve] quantized DYAD weight sidecars: {qdtype}" in r.stdout
    assert "[serve] qwen3-0.6b-smoke on cpu" in r.stdout
