"""Port parity for the MoE ff module: ``repro_torch.layers.moe.apply_moe``
against ``repro.layers.moe.apply_moe`` on the same weights and inputs
(numpy seeds, the weights in the reference's tree): DYAD and dense experts,
Qwen1.5-MoE's top-4 over padded experts with shared experts, Maverick's
top-1, a capacity that drops tokens, and a ``moe_chunk`` shorter than the
sequence; output and aux within 1e-5 x max(|reference|, 1), fp32 on the
CPU.  Also the router's top-k ties (the lower index first, as
``jax.lax.top_k``) and the dropped tokens themselves."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import flatten_with_paths  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import bridge  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402

TOL = 1e-5


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * scale)


# (n_experts, e_pad, top_k, n_shared, capacity_factor, chunk, S, spec):
# Qwen1.5-MoE's smoke routing, Maverick's, dense experts, a capacity that
# drops, a chunk shorter than S, and the kernel-routed shared expert
CASES = {
    "qwen_top4_padded": (6, 8, 4, 2, 1.25, None, 8, "dyad_it"),
    "maverick_top1": (8, 8, 1, 1, 1.25, None, 8, "dyad_it"),
    "dense_experts": (6, 8, 4, 2, 1.25, None, 8, "dense"),
    "capacity_drops": (6, 8, 4, 0, 0.5, None, 12, "dyad_it"),
    "chunked": (6, 8, 2, 1, 1.0, 4, 12, "dyad_it"),
    "shared_megakernel": (6, 8, 4, 2, 1.25, None, 8,
                          "dyad_it_4_kernel_ffused"),
}


def _pair(n_exp, e_pad, top_k, n_shared, spec, d=32, dff=16, seed=0):
    jlin = jconfigs.linear_cfg(spec)
    tlin = tconfigs.linear_cfg(spec)
    if spec.endswith("ffused"):
        # the megakernel's einsum twin on the reference's side
        jlin = jlin.replace(use_kernel=False, fuse_ff_kernel=False,
                            fuse_mlp=True)
    shapes = jax.eval_shape(lambda: jmoe.init_moe(
        jax.random.PRNGKey(0), d, dff, n_exp, top_k, jlin,
        n_shared=n_shared, n_experts_padded=e_pad))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in flatten_with_paths(shapes).items():
        # uniform(-k, k) by fan-in, as the reference draws its linears
        fan = v.shape[-1] * (v.shape[-3] if k.endswith(("w1", "w2")) else 1)
        flat[k] = rng.uniform(-1, 1, v.shape).astype(np.float32) / np.sqrt(
            np.float32(fan))
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jnp.asarray(flat[k]) for k in flatten_with_paths(shapes)])
    return jlin, jp, tlin, bridge.from_flat(flat, "cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_matches_jax(case):
    n_exp, e_pad, top_k, n_sh, cf, chunk, S, spec = CASES[case]
    jlin, jp, tlin, tp = _pair(n_exp, e_pad, top_k, n_sh, spec)
    x = np.random.default_rng(1).standard_normal((2, S, 32)).astype(
        np.float32)
    kw = dict(n_experts=n_exp, top_k=top_k, capacity_factor=cf, chunk=chunk)
    want, jaux = jax.jit(functools.partial(jmoe.apply_moe, lin_cfg=jlin,
                                           **kw))(jp, jnp.asarray(x))
    got, taux = tmoe.apply_moe(tp, torch.from_numpy(x), tlin, **kw)
    _close(got.numpy(), want)
    _close(taux.numpy(), jaux)
    assert np.abs(np.asarray(want)).max() > 0


def test_capacity_drops_the_later_slots():
    """With capacity 1 a token whose expert already holds an earlier
    token of its row gets nothing from it: the slot order is the (s, k)
    row-major flattening, as the reference's cumsum makes it."""
    _, jp, _, tp = _pair(4, 4, 2, 0, "dense")
    x = np.random.default_rng(2).standard_normal((1, 4, 32)).astype(
        np.float32)
    w, idx, _ = tmoe._route(tp, torch.from_numpy(x), 4, 2)
    _, combine = tmoe._dispatch_combine(torch.from_numpy(x), w, idx, 4, 1)
    jw, jidx, _ = jmoe._route(jp, jnp.asarray(x), 4, 2)
    _, jcombine = jmoe._dispatch_combine(jnp.asarray(x), jw, jidx, 4, 2, 1)
    _close(combine.numpy(), jcombine)
    kept = combine.numpy().sum(-1) > 0                 # (1, S, E)
    assert kept.sum(axis=1).max() <= 1                 # one token an expert
    assert kept.sum() < 4 * 2                          # some slots dropped


def test_router_ties_go_to_the_lower_index():
    """A zero router gives every real expert the same probability; the
    top-k are then the lowest indices, as ``jax.lax.top_k`` picks them,
    and the padded experts none."""
    _, jp, _, tp = _pair(6, 8, 4, 0, "dense")
    tp["router"]["w"].zero_()
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    x = np.random.default_rng(3).standard_normal((2, 3, 32)).astype(
        np.float32)
    w, idx, probs = tmoe._route(tp, torch.from_numpy(x), 6, 4)
    jw, jidx, jprobs = jmoe._route(jp, jnp.asarray(x), 6, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0, 0].tolist() == [0, 1, 2, 3]
    _close(w.numpy(), jw)
    assert float(probs[..., 6:].max()) == 0.0
