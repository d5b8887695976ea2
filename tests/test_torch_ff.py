"""Port parity for the ff megakernel slice: the plain versions of
``dyad_mm_blocks_two``, ``dyad_mm_dgrad`` and ``dyad_ff_fused`` against
the JAX Pallas kernels in interpret mode; ``ops.dyad_ff`` forward (the
``fused`` and ``split`` routes) and gradients (the plain, kernel-dataflow
and oracle backward routes) against ``repro.kernels.ops.dyad_ff``; the OT
and DT ``ops.dyad_mm`` on their kernel dataflow; and the ``apply_mlp``
dispatch.  Inputs come from numpy with a seed; on the CPU every wrapper
takes its plain version.

Tolerance, for a contraction of length L (d_in for the up products,
d_ff_b or d_out behind the down side, the rows for the weight grads):
tol x max(|reference|, 1) x max(1, sqrt(L / 128)), with tol 1e-5 in fp32
(the sums run in another order than the tiled Pallas kernels, ROADMAP
C.1) and 2e-2 in bf16 (the outputs are rounded to bf16, relative step
2^-8, and the hidden, rounded to bf16 before the down product, can land
one bf16 step apart where the two fp32 up sums differ in their last
bit)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.dyad_mm import dyad_ff_fused as j_ff  # noqa: E402
from repro.kernels.dyad_mm import dyad_mm_blocks_two as j_two  # noqa: E402
from repro.kernels.dyad_mm import dyad_mm_dgrad as j_dgrad  # noqa: E402
from repro.layers import mlp as jmlp  # noqa: E402
from repro_torch.core import factory  # noqa: E402
from repro_torch.kernels import dyad_mm, ops, ref  # noqa: E402
from repro_torch.layers import mlp  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ACT_NAMES = ["gelu", "relu", "silu", "swiglu"]


def _close(got, want, L=1, dtype="float32"):
    tol = TOL[dtype] * max(1.0, math.sqrt(L / 128))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(float(np.max(np.abs(want))), 1.0) if want.size else 1.0
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(a).astype(JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TDT[dtype])


# -- the three kernels' plain versions against Pallas -------------------------

FF_SHAPES = [
    # (M, n, d_in_b, d_ff_b, d_out_b): odd and prime dims, then Qwen3
    # smoke's widths (d 64, d_ff 96, n 4)
    (3, 2, 129, 130, 17),
    (8, 4, 16, 24, 16),
]


def _ff_inputs(M, n, d_in, d_ff, d_out, seed):
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((M, n, d_in)).astype(np.float32)
         for _ in range(2)]
    ups = [rng.standard_normal((n, d_ff, d_in)).astype(np.float32)
           / math.sqrt(d_in) for _ in range(4)]
    downs = [rng.standard_normal((n, d_out, d_ff)).astype(np.float32)
             / math.sqrt(d_ff) for _ in range(2)]
    return x, ups, downs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACT_NAMES)
@pytest.mark.parametrize("shape", FF_SHAPES)
def test_ff_fused_plain_matches_pallas(shape, act, dtype):
    M, n, d_in, d_ff, d_out = shape
    x, ups, downs = _ff_inputs(*shape, seed=M + d_ff)
    (jx1, tx1), (jx2, tx2) = (_pair(a, dtype) for a in x)
    ju, tu = zip(*(_pair(a, dtype) for a in ups))
    jd, td = zip(*(_pair(a, dtype) for a in downs))
    gated = act == "swiglu"
    want = j_ff(jx1, jx2, ju[0], ju[1], jd[0], jd[1],
                wg1=ju[2] if gated else None, wg2=ju[3] if gated else None,
                act=act, interpret=True)
    before = dyad_mm.dyad_ff_fused.launches
    got = dyad_mm.dyad_ff_fused(tx1, tx2, tu[0], tu[1], td[0], td[1],
                                tu[2] if gated else None,
                                tu[3] if gated else None, act=act)
    assert dyad_mm.dyad_ff_fused.launches == before
    for a, b in zip(got, want):
        assert a.shape == (M, n, d_out) and a.dtype == TDT[dtype]
        _close(a, b, max(d_in, d_ff), dtype)


def test_ff_fused_plain_takes_fp32_weights_for_bf16_x():
    """fp32 weights with bf16 x: rounded to bf16 first, the cast the
    caller would otherwise make."""
    x, ups, downs = _ff_inputs(5, 2, 16, 24, 8, seed=3)
    xb = [torch.from_numpy(a).bfloat16() for a in x]
    ws = [torch.from_numpy(a) for a in ups[:2] + downs]
    got = dyad_mm.dyad_ff_fused(*xb, *ws, act="gelu")
    want = dyad_mm.dyad_ff_fused(*xb, *(w.bfloat16() for w in ws),
                                 act="gelu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ff_fused_argument_checks_match_the_reference():
    x, ups, downs = _ff_inputs(2, 2, 8, 8, 8, seed=4)
    t = [torch.from_numpy(a) for a in x + ups + downs]
    with pytest.raises(ValueError, match="exactly when act='swiglu'"):
        dyad_mm.dyad_ff_fused(t[0], t[1], t[2], t[3], t[6], t[7],
                              act="swiglu")
    with pytest.raises(ValueError, match="exactly when act='swiglu'"):
        dyad_mm.dyad_ff_fused(t[0], t[1], t[2], t[3], t[6], t[7], t[4],
                              t[5], act="gelu")
    with pytest.raises(ValueError, match="unsupported megakernel"):
        dyad_mm.dyad_ff_fused(t[0], t[1], t[2], t[3], t[6], t[7],
                              act="tanh")


def test_ff_split_covers_the_hidden():
    for M, n, d_ff, d_out in [(4096, 4, 768, 256), (8, 4, 768, 256),
                              (1024, 4, 768, 256), (3, 2, 130, 17),
                              (1, 1, 1, 1)]:
        for sms in (1, 132):
            split, span = dyad_mm.ff_split(M, n, d_ff, d_out, sms)
            assert span % 16 == 0 and split >= 1
            assert (split - 1) * span < d_ff <= split * span
    # Qwen3-0.6B on an H100 SXM (132 SMs): the training rows fill the card
    # alone; prefill and decode rows split the hidden
    assert dyad_mm.ff_split(4096, 4, 768, 256, 132) == (1, 768)
    assert dyad_mm.ff_split(1024, 4, 768, 256, 132) == (3, 256)
    assert dyad_mm.ff_split(8, 4, 768, 256, 132) == (48, 16)


MM_SHAPES = [
    # (M, n, d_in, d_out): ragged and prime dims, past-lane dims
    (129, 2, 13, 17),
    (13, 3, 7, 5),
    (64, 2, 129, 130),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,n,d_in,d_out", MM_SHAPES)
def test_blocks_two_and_dgrad_plain_match_pallas(M, n, d_in, d_out, dtype):
    rng = np.random.default_rng(M + d_out)
    (jx1, tx1), (jx2, tx2) = (_pair(rng.standard_normal(
        (M, n, d_in)).astype(np.float32), dtype) for _ in range(2))
    (jz1, tz1), (jz2, tz2) = (_pair(rng.standard_normal(
        (M, n, d_out)).astype(np.float32), dtype) for _ in range(2))
    (jw1, tw1), (jw2, tw2) = (_pair(rng.standard_normal(
        (n, d_out, d_in)).astype(np.float32) / math.sqrt(d_in), dtype)
        for _ in range(2))
    before = (dyad_mm.dyad_mm_blocks_two.launches,
              dyad_mm.dyad_mm_dgrad.launches)
    got = dyad_mm.dyad_mm_blocks_two(tx1, tx2, tw1, tw2)
    want = j_two(jx1, jx2, jw1, jw2, interpret=True)
    for a, b in zip(got, want):
        assert a.shape == (M, n, d_out) and a.dtype == TDT[dtype]
        _close(a, b, d_in, dtype)
    got = dyad_mm.dyad_mm_dgrad(tz1, tz2, tw1, tw2)
    assert got.shape == (M, n, d_in) and got.dtype == TDT[dtype]
    _close(got, j_dgrad(jz1, jz2, jw1, jw2, interpret=True), 2 * d_out,
           dtype)
    assert before == (dyad_mm.dyad_mm_blocks_two.launches,
                      dyad_mm.dyad_mm_dgrad.launches)


# -- ops.dyad_ff against the reference op -------------------------------------


def _ff_params(act, d=48, d_ff=72, n=4, seed=5):
    """Bias-free DYAD ff params of the reference's layout, as numpy."""
    rng = np.random.default_rng(seed)
    names = ("gate", "up", "down") if act == "swiglu" else ("up", "down")
    p = {}
    for name in names:
        f_in, f_out = (d_ff, d) if name == "down" else (d, d_ff)
        shape = (n, f_out // n, f_in // n)
        p[name] = {w: (rng.standard_normal(shape) / math.sqrt(f_in / n))
                   .astype(np.float32) for w in ("w1", "w2")}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    r = rng.standard_normal((2, 5, d)).astype(np.float32)
    return p, x, r


def _jax_ff(p, x, r, act, dtype, use_kernel_bwd=True):
    jp = jax.tree.map(jnp.asarray, p)
    jx, jr = jnp.asarray(x, JDT[dtype]), jnp.asarray(r, JDT[dtype])
    y = jops.dyad_ff(jp, jx, act=act, use_kernel_bwd=use_kernel_bwd)
    grads = jax.grad(lambda px, xx: jnp.sum(
        (jops.dyad_ff(px, xx, act=act, use_kernel_bwd=use_kernel_bwd)
         * jr).astype(jnp.float32)), argnums=(0, 1))(jp, jx)
    return y, grads


def _port_ff(p, x, r, act, dtype, use_kernel_bwd=True):
    tp = {k: {w: torch.from_numpy(a).requires_grad_() for w, a in v.items()}
          for k, v in p.items()}
    tx = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    y = ops.dyad_ff(tp, tx, act=act, use_kernel_bwd=use_kernel_bwd)
    (y.float() * torch.from_numpy(r).to(TDT[dtype]).float()).sum().backward()
    return y, tp, tx


def _check_grads(tp, tx, jgrads, dtype, rows=10):
    jgp, jgx = jgrads
    _close(tx.grad, jgx, 72, dtype)
    for k in tp:
        for w in ("w1", "w2"):
            assert tp[k][w].grad.dtype == torch.float32
            _close(tp[k][w].grad, jgp[k][w], rows, dtype)


@pytest.mark.parametrize("act", ACT_NAMES)
@pytest.mark.parametrize("route", ["fused", "split"])
def test_dyad_ff_forward_and_grads_match_jax(act, route, monkeypatch):
    """fp32; the forward route forced on both sides, each backward on its
    CPU default (the direct lowering)."""
    monkeypatch.setenv("REPRO_KERNEL_FF", route)
    p, x, r = _ff_params(act)
    jy, jgrads = _jax_ff(p, x, r, act, "float32")
    y, tp, tx = _port_ff(p, x, r, act, "float32")
    _close(y, jy, 72)
    _check_grads(tp, tx, jgrads, "float32")


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_dyad_ff_kernel_backward_dataflow_matches_jax(act, monkeypatch):
    """The CUDA route's dataflow (rematerialised hidden, wgrad, fused
    dgrad, activation VJP, dgrad_two) on the CPU, where its kernels take
    their plain versions, against the reference's interpret-mode Pallas
    backward forced with REPRO_KERNEL_BWD=pallas."""
    p, x, r = _ff_params(act, seed=6)
    monkeypatch.setenv("REPRO_KERNEL_BWD", "pallas")
    jy, jgrads = _jax_ff(p, x, r, act, "float32")
    monkeypatch.delenv("REPRO_KERNEL_BWD")
    monkeypatch.setattr(ops, "bwd_route", lambda device: "kernel")
    counts = (dyad_mm.dyad_mm_dgrad.launches, dyad_mm.dyad_ff_fused.launches)
    y, tp, tx = _port_ff(p, x, r, act, "float32")
    assert counts == (dyad_mm.dyad_mm_dgrad.launches,
                      dyad_mm.dyad_ff_fused.launches)
    _close(y, jy, 72)
    _check_grads(tp, tx, jgrads, "float32")


@pytest.mark.parametrize("act", ["gelu", "relu", "swiglu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dyad_ff_oracle_backward_matches_jax(act, dtype):
    """use_kernel_bwd=False on both sides: autograd of the einsum oracle.
    bf16 gradients are held against this route only: the reference's
    default CPU ff backward crashes in bf16 on jax 0.9 (ROADMAP C.2)."""
    p, x, r = _ff_params(act, seed=7)
    jy, jgrads = _jax_ff(p, x, r, act, dtype, use_kernel_bwd=False)
    y, tp, tx = _port_ff(p, x, r, act, dtype, use_kernel_bwd=False)
    assert y.dtype == TDT[dtype]
    _close(y, jy, 72, dtype)
    _check_grads(tp, tx, jgrads, dtype)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_dyad_ff_bf16_routes_agree_with_the_oracle(act, monkeypatch):
    """bf16 on the port: the plain and the kernel-dataflow backward, and
    the split forward, against the oracle route on the same inputs."""
    p, x, r = _ff_params(act, seed=8)
    y0, tp0, tx0 = _port_ff(p, x, r, act, "bfloat16", use_kernel_bwd=False)
    want = [tx0.grad] + [tp0[k][w].grad for k in tp0 for w in ("w1", "w2")]
    runs = {"plain": {}, "kernel": {}, "split": {"REPRO_KERNEL_FF": "split"}}
    for name, env in runs.items():
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        if name == "kernel":
            monkeypatch.setattr(ops, "bwd_route", lambda device: "kernel")
        y, tp, tx = _port_ff(p, x, r, act, "bfloat16")
        _close(y, y0.float().detach().numpy(), 72, "bfloat16")
        got = [tx.grad] + [tp[k][w].grad for k in tp for w in ("w1", "w2")]
        for a, b in zip(got, want):
            _close(a, b.float().numpy(), 72, "bfloat16")
        monkeypatch.undo()


def test_dyad_ff_gradcheck_fp64():
    gen = torch.Generator().manual_seed(2)
    n, d, d_ff = 2, 6, 8
    x = torch.randn(3, d, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    ws = [torch.randn(n, d_ff // n, d // n, generator=gen,
                      dtype=torch.float64, requires_grad=True)
          for _ in range(4)]
    ws += [torch.randn(n, d // n, d_ff // n, generator=gen,
                       dtype=torch.float64, requires_grad=True)
           for _ in range(2)]

    def f(x, *w):
        p = {"gate": {"w1": w[0], "w2": w[1]}, "up": {"w1": w[2], "w2": w[3]},
             "down": {"w1": w[4], "w2": w[5]}}
        return ops.dyad_ff(p, x, act="swiglu")

    assert torch.autograd.gradcheck(f, (x, *ws))


# -- OT and DT dyad_mm on the kernel dataflow ---------------------------------


@pytest.mark.parametrize("variant", ["ot", "dt"])
def test_ot_dt_dyad_mm_kernel_dataflow_matches_jax(variant, monkeypatch):
    """Forward through dyad_mm_blocks_two + combine, backward through
    dyad_mm_dgrad (OT) or dyad_mm_dgrad_two + unview (DT) and wgrad, on the
    CPU's plain versions, against the reference's Pallas forward and
    backward in interpret mode."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w1, w2 = (rng.standard_normal((4, 8, 12)).astype(np.float32)
              for _ in range(2))
    r = rng.standard_normal((2, 5, 32)).astype(np.float32)
    monkeypatch.setenv("REPRO_KERNEL_BWD", "pallas")
    jr = jnp.asarray(r)
    jy = jops.dyad_mm(*map(jnp.asarray, (x, w1, w2)), variant=variant)
    want = jax.grad(lambda *a: jnp.sum(jops.dyad_mm(
        *a, variant=variant) * jr), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, w1, w2)))
    monkeypatch.delenv("REPRO_KERNEL_BWD")
    monkeypatch.setattr(ops, "bwd_route", lambda device: "kernel")
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w1, w2)]
    y = ops.dyad_mm(*ts, variant=variant)
    _close(y, jy, 12)
    (y * torch.from_numpy(r)).sum().backward()
    for t, b in zip(ts, want):
        _close(t.grad, b, 10)


# -- the apply_mlp dispatch -----------------------------------------------------


def _mlp_pair(spec, act, bias, seed=10):
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase

    jcfg, tcfg = jbase.linear_cfg(spec), tbase.linear_cfg(spec)
    p = jmlp.init_mlp(jax.random.PRNGKey(seed), 32, 64, jcfg, act=act,
                      bias=bias)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    x = np.random.default_rng(seed).standard_normal((2, 3, 32)).astype(
        np.float32)
    want = jmlp.apply_mlp(p, jnp.asarray(x), jcfg, act=act)
    return tp, torch.from_numpy(x), tcfg, want


@pytest.mark.parametrize("spec,act,bias,route", [
    # bias-free DYAD with the megakernel opt-in: ops.dyad_ff
    ("dyad_it_4_kernel_ffused", "swiglu", False, "dyad_ff"),
    ("dyad_it_4_kernel_ffused", "gelu", False, "dyad_ff"),
    # the einsum tier
    ("dyad_it_4_fused", "swiglu", False, "fused"),
    ("dyad_it_4_fused", "relu", True, "fused"),
    # fuse_ff_kernel without use_kernel: the megakernel's dataflow as
    # einsums, not the all-IT chain (the reference's PR 8 rule)
    ("dyad_it_4_ffused", "swiglu", False, "fused"),
    # a biased ff (the paper's configs) takes the plain chain
    ("dyad_it_4_kernel_ffused", "relu", True, "plain"),
    ("dyad_it_4_kernel", "swiglu", False, "plain"),
])
def test_apply_mlp_dispatch_matches_jax(spec, act, bias, route,
                                        monkeypatch):
    tp, x, tcfg, want = _mlp_pair(spec, act, bias)
    seen = []
    monkeypatch.setattr(ops, "dyad_ff", _spy(ops.dyad_ff, seen, "dyad_ff"))
    monkeypatch.setattr(mlp, "_fused_dyad_mlp",
                        _spy(mlp._fused_dyad_mlp, seen, "fused"))
    _close(mlp.apply_mlp(tp, x, tcfg, act=act), want, 64)
    assert seen == ([route] if route != "plain" else [])


def _spy(fn, seen, name):
    def wrapped(*a, **k):
        seen.append(name)
        return fn(*a, **k)
    return wrapped


def test_quantized_megakernel_route_raises():
    tcfg = factory.LinearCfg(impl="dyad", use_kernel=True,
                             fuse_ff_kernel=True, quant="int8")
    p = mlp.init_mlp(torch.Generator().manual_seed(0), 16, 32, tcfg,
                     act="gelu")
    with pytest.raises(NotImplementedError, match="A.10"):
        mlp.apply_mlp(p, torch.zeros(2, 16), tcfg, act="gelu")


def test_dyad_ff_ref_matches_the_reference_oracle():
    from repro.kernels import ref as jref

    p, x, _ = _ff_params("swiglu", seed=11)
    args = [p["up"]["w1"], p["up"]["w2"], p["down"]["w1"], p["down"]["w2"],
            p["gate"]["w1"], p["gate"]["w2"]]
    want = jref.dyad_ff_ref(jnp.asarray(x), *map(jnp.asarray, args),
                            act="swiglu")
    got = ref.dyad_ff_ref(torch.from_numpy(x),
                          *map(torch.from_numpy, args), act="swiglu")
    _close(got, want, 72)
