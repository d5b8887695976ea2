"""Port parity: DYAD core, dense linear, factory and linear-spec parsing
(``repro_torch.core`` / ``repro_torch.configs``) against the JAX reference
on the same numpy inputs, fp32 on the CPU.

Tolerance: 1e-5 times max(|reference|, 1) — both sides accumulate fp32
sums of at most 64 products, in different orders."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import dyad as jdyad  # noqa: E402
from repro.core import factory as jfactory  # noqa: E402
from repro.core import linear as jlinear  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import dyad, factory, linear  # noqa: E402

TOL = 1e-5


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _dyad_params(rng, f_in, f_out, n, bias=True):
    d_in, d_out = f_in // n, f_out // n
    p = {"w1": rng.standard_normal((n, d_out, d_in)).astype(np.float32),
         "w2": rng.standard_normal((n, d_out, d_in)).astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(f_out).astype(np.float32)
    return p


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


SHAPES = [(16, 24, 4, (5,)), (24, 12, 2, (2, 3)), (64, 32, 8, (7,))]


@pytest.mark.parametrize("f_in,f_out,n,lead", SHAPES)
@pytest.mark.parametrize("cat", [False, True])
@pytest.mark.parametrize("variant", ["it", "ot", "dt"])
def test_apply_matches_jax_and_dense(variant, cat, f_in, f_out, n, lead):
    rng = np.random.default_rng(f_in * 7 + n)
    p = _dyad_params(rng, f_in, f_out, n)
    x = rng.standard_normal((*lead, f_in)).astype(np.float32)
    jp, tp = _both(p)
    jspec = jdyad.DyadSpec(n_dyad=n, variant=variant, cat=cat)
    tspec = dyad.DyadSpec(n_dyad=n, variant=variant, cat=cat)
    want = jdyad.apply(jp, jnp.asarray(x), jspec)
    got = dyad.apply(tp, torch.from_numpy(x), tspec)
    _close(got, want)
    dense = dyad.to_dense(tp, tspec)
    np.testing.assert_array_equal(dense.numpy(),
                                  np.asarray(jdyad.to_dense(jp, jspec)))
    _close(torch.from_numpy(x) @ dense.T + tp["b"], want)


@pytest.mark.parametrize("variant", ["it", "ot", "dt"])
def test_apply_kernel_spec_on_cpu_matches_jax(variant):
    """``use_kernel`` on a CPU tensor takes the plain route of ops.dyad_mm;
    the reference runs its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(3)
    p = _dyad_params(rng, 32, 48, 4)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    jp, tp = _both(p)
    want = jdyad.apply(jp, jnp.asarray(x),
                       jdyad.DyadSpec(n_dyad=4, variant=variant,
                                      use_kernel=True))
    got = dyad.apply(tp, torch.from_numpy(x),
                     dyad.DyadSpec(n_dyad=4, variant=variant,
                                   use_kernel=True))
    _close(got, want)


def test_block_layout_applies_match_jax():
    rng = np.random.default_rng(4)
    up = _dyad_params(rng, 32, 64, 4)
    down = _dyad_params(rng, 64, 32, 4)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    (jup, tup), (jdown, tdown) = _both(up), _both(down)
    jh = jdyad.apply_blocks(jup, jnp.asarray(x), jdyad.DyadSpec(n_dyad=4))
    th = dyad.apply_blocks(tup, torch.from_numpy(x), dyad.DyadSpec(n_dyad=4))
    _close(th, jh)
    _close(dyad.apply_ot_from_blocks(tdown, th),
           jdyad.apply_ot_from_blocks(jdown, jh))


@pytest.mark.parametrize("f_in,f_out,req", [(768, 3072, 4), (30, 45, 4),
                                            (7, 13, 4), (64, 64, 16)])
def test_counts_match_jax(f_in, f_out, req):
    assert dyad.resolve_n_dyad(f_in, f_out, req) == jdyad.resolve_n_dyad(
        f_in, f_out, req)
    n = dyad.resolve_n_dyad(f_in, f_out, req)
    assert dyad.param_count(f_in, f_out, n) == jdyad.param_count(f_in, f_out,
                                                                 n)
    assert dyad.flops(8, f_in, f_out, n) == jdyad.flops(8, f_in, f_out, n)
    assert linear.param_count(f_in, f_out) == jlinear.param_count(f_in,
                                                                  f_out)


def test_init_shapes_and_range():
    g = torch.Generator().manual_seed(0)
    p = dyad.init(g, 64, 32, dyad.DyadSpec(n_dyad=4))
    assert p["w1"].shape == p["w2"].shape == (4, 8, 16)
    assert p["b"].shape == (32,)
    k = 1.0 / 8.0
    assert all(float(t.abs().max()) <= k for t in p.values())
    with pytest.raises(ValueError):
        dyad.init(g, 30, 32, dyad.DyadSpec(n_dyad=4))


def test_dense_linear_matches_jax():
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((24, 16)).astype(np.float32),
         "b": rng.standard_normal(24).astype(np.float32)}
    x = rng.standard_normal((4, 16)).astype(np.float32)
    jp, tp = _both(p)
    _close(linear.apply(tp, torch.from_numpy(x)),
           jlinear.apply(jp, jnp.asarray(x)))


SPECS = ["dense", "dyad_it", "dyad_ot_8", "dyad_dt_4_cat",
         "dyad_it_4_kernel", "dyad_it_4_kernel_einsumbwd", "dyad_it_4_fused",
         "dyad_it_4_kernel_ffused", "dyad_it_4_kernel_ffused_w8",
         "dyad_it_4_kernel_ffused_wfp8"]


@pytest.mark.parametrize("spec", SPECS)
def test_linear_cfg_parsing_matches_jax(spec):
    ref = dataclasses.asdict(jbase.linear_cfg(spec))
    assert ref["use_kernel_bwd"] is ("einsumbwd" not in spec)
    assert dataclasses.asdict(tbase.linear_cfg(spec)) == ref


@pytest.mark.parametrize("scope", ["none", "ff", "ff+attn", "all"])
def test_factory_sites_and_apply(scope):
    tcfg = factory.LinearCfg(impl="dyad", scope=scope)
    jcfg = jfactory.LinearCfg(impl="dyad", scope=scope)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    for site in ("ff", "attn", "ssm", "head"):
        assert tcfg.dyad_at(site) == jcfg.dyad_at(site)
        p = factory.init(torch.Generator().manual_seed(1), 32, 16, tcfg,
                         site=site)
        assert ("w1" in p) == tcfg.dyad_at(site)
        assert (sum(t.numel() for t in p.values())
                == jfactory.param_count(32, 16, jcfg, site=site))
        jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
        _close(factory.apply(p, torch.from_numpy(x), tcfg, site=site),
               jfactory.apply(jp, jnp.asarray(x), jcfg, site=site))


def test_unported_routes_raise():
    cfg = tbase.linear_cfg("dyad_it_4_kernel_ffused_w8")
    p = factory.init(torch.Generator().manual_seed(0), 16, 16, cfg)
    with pytest.raises(NotImplementedError, match="A.10"):
        factory.apply(p, torch.zeros(2, 16), cfg)
    # Qwen3-0.6B is ported now; an arch of another family is not
    with pytest.raises(NotImplementedError, match="A.13"):
        tbase.get("mamba2_780m", smoke=True)
