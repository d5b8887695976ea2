"""Port parity for the Mamba2 (SSD) mixer: ``repro_torch.layers.ssm``
against ``repro.layers.ssm`` on the same weights and inputs (numpy seeds,
the weights in the reference's tree): ``apply_ssm`` at sequence lengths
off the SSD chunk, and ``ssm_prefill`` followed by ``ssm_decode_step``
calls against the reference and against ``apply_ssm`` over the whole
sequence; DYAD in and out projections (scope ``ff+ssm``) and dense ones.
Within 1e-5 x max(|reference|, 1), fp32 on the CPU (the recurrent form
against the chunked one at 2e-5: they sum in other orders)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import flatten_with_paths  # noqa: E402
from repro.core import factory as jfactory  # noqa: E402
from repro.layers import ssm as jssm  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.core import factory as tfactory  # noqa: E402
from repro_torch.layers import ssm as tssm  # noqa: E402

TOL = 1e-5
# Mamba2's smoke widths: d 64, state 16, head dim 16 (8 heads), SSD chunk 8
D, N, P, CHUNK = 64, 16, 16, 8
KW = dict(d_state=N, head_dim=P, n_groups=1)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


def _lin(impl):
    kw = dict(impl=impl, n_dyad=4, variant="it", scope="ff+ssm")
    return jfactory.LinearCfg(**kw), tfactory.LinearCfg(**kw)


def _pair(impl, n_groups=1, seed=0):
    jlin, tlin = _lin(impl)
    shapes = jax.eval_shape(lambda: jssm.init_ssm(
        jax.random.PRNGKey(0), D, jlin, d_state=N, head_dim=P,
        n_groups=n_groups))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in flatten_with_paths(shapes).items():
        if k == "A_log":
            a = np.log(rng.uniform(1.0, 16.0, v.shape))
        elif k == "dt_bias":
            a = np.log(np.expm1(rng.uniform(0.001, 0.1, v.shape)))
        elif k in ("D", "norm/scale"):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif k == "conv":
            a = 0.1 * rng.standard_normal(v.shape)
        else:
            fan = v.shape[-1] * (v.shape[-3] if k.endswith(("w1", "w2"))
                                 else 1)
            a = rng.uniform(-1, 1, v.shape) / np.sqrt(fan)
        flat[k] = a.astype(np.float32)
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jnp.asarray(flat[k]) for k in flatten_with_paths(shapes)])
    return jlin, jp, tlin, bridge.from_flat(flat, "cpu")


def _x(B, S, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


@pytest.mark.parametrize("impl,S,groups", [
    ("dyad", 13, 1), ("dyad", 16, 1), ("dense", 5, 1), ("dense", 11, 2)])
def test_apply_ssm_matches_jax(impl, S, groups):
    """S 13 and 11 leave a padded last chunk (dt 0 there), S 5 one short
    chunk, S 16 two whole chunks; two B/C groups over the heads."""
    jlin, jp, tlin, tp = _pair(impl, groups)
    x = _x(2, S)
    kw = dict(KW, n_groups=groups, chunk=CHUNK)
    want = jax.jit(functools.partial(jssm.apply_ssm, lin_cfg=jlin, **kw))(
        jp, jnp.asarray(x))
    got = tssm.apply_ssm(tp, torch.from_numpy(x), tlin, **kw)
    assert got.shape == (2, S, D)
    _close(got.numpy(), want)


@pytest.mark.parametrize("impl", ["dyad", "dense"])
def test_prefill_then_decode_matches_jax_and_the_whole_forward(impl):
    """A 13-token prefill hands on the conv tail and the state, then 4
    recurrent steps: each output equals the reference's, and all 17 equal
    the chunked forward over the whole sequence."""
    jlin, jp, tlin, tp = _pair(impl)
    S, k = 13, 4
    x = _x(2, S + k, seed=2)
    jc = jssm.init_ssm_cache(2, D, d_state=N, head_dim=P)
    tc = tssm.init_ssm_cache(2, D, d_state=N, head_dim=P)
    want, jc = jssm.ssm_prefill(jp, jnp.asarray(x[:, :S]), jc, jlin,
                                chunk=CHUNK, **KW)
    got, tc = tssm.ssm_prefill(tp, torch.from_numpy(x[:, :S]), tc, tlin,
                               chunk=CHUNK, **KW)
    _close(got.numpy(), want)
    _close(tc["state"].numpy(), jc["state"])
    _close(tc["conv"].numpy(), jc["conv"])
    outs = [got]
    for t in range(S, S + k):
        xt = x[:, t:t + 1]
        want, jc = jssm.ssm_decode_step(jp, jnp.asarray(xt), jc, jlin, **KW)
        before = tc["state"].clone()
        got, nc = tssm.ssm_decode_step(tp, torch.from_numpy(xt), tc, tlin,
                                       **KW)
        assert torch.equal(tc["state"], before)    # the old state is kept
        tc = nc
        _close(got.numpy(), want)
        outs.append(got)
    whole = tssm.apply_ssm(tp, torch.from_numpy(x), tlin, chunk=CHUNK, **KW)
    _close(torch.cat(outs, dim=1).numpy(), whole.numpy())
