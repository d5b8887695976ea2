"""Bridge between the reference's flat, layer-stacked arrays and the port's
trees.

The reference stores a model (and a train state) as a pytree whose
per-layer leaves are stacked on a leading ``n_layers`` axis; flattened with
its ``checkpoint.manager.flatten_with_paths`` the keys are ``/``-joined
dict keys such as ``layers/mlp/up/w1`` ``(n_layers, n, d_out, d_in)``,
``pos/table`` and ``final_norm/scale`` for params, and
``params/layers/...``, ``opt/m/layers/...``, ``opt/v/...``, ``opt/step``
and ``opt/master/...`` for a train state.  The port keeps every ``layers``
subtree (and an encoder-decoder's ``enc_layers``, stacked on its own
``n_enc_layers`` axis) as a list of per-layer dicts; any other axis stays a tensor axis,
so a MoE layer's routed experts keep their leading expert axis
(``layers/moe/experts/up/w1`` is ``(n_layers, E, n, d_out, d_in)`` in the
reference and ``(E, n, d_out, d_in)`` in each port layer), beside the
router, the shared expert and its gate, and the SSM mixer's ``A_log``,
``dt_bias``, ``D``, ``conv``, ``norm``, ``wbc`` and ``wdt``.
:func:`to_flat` turns any port tree
into that flat dict of numpy arrays (each list stacked on a leading axis;
bf16 and fp8 leaves are written as fp32, which numpy can hold exactly, and
cast back by the reader); :func:`from_flat` is its inverse, onto a device.
It takes the reference's quantized sidecars as they are: int8 payloads as
int8, and ``float8_e4m3fn`` payloads (a numpy extension dtype, which
``torch.from_numpy`` refuses) by their bytes, so the port needs no numpy
fp8 package.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import tree as tree_lib

# the subtrees stacked on a leading layer axis in the reference
_LAYERS = ("layers", "enc_layers")


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, object]:
    """``{"a/b/c": leaf}`` for a tree of dicts — the reference's key format
    (dict keys joined with ``/``, in sorted key order)."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            out.update(flatten_with_paths(tree[key], path + "/"))
        else:
            out[path] = tree[key]
    return out


def _nest(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _unstack(node: dict) -> dict:
    """Turn every ``layers`` (and ``enc_layers``) dict of stacked arrays
    into a list of per-layer dicts."""
    out = {k: _unstack(v) if isinstance(v, dict) else v
           for k, v in node.items()}
    for key in _LAYERS:
        sub = out.get(key)
        if not isinstance(sub, dict):
            continue
        flat = flatten_with_paths(sub)
        depth = {np.shape(v)[0] for v in flat.values()}
        if len(depth) > 1:
            raise ValueError(f"inconsistent {key} axes: {sorted(depth)}")
        n = depth.pop() if depth else 0
        out[key] = [_nest({k: np.asarray(v)[i] for k, v in flat.items()})
                    for i in range(n)]
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy holds neither bf16 nor fp8: both go out as fp32, exactly
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        t = t.float()
    return t.numpy()


def _from_numpy(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "float8_e4m3fn":
        # one byte per element: carried over as bytes, then viewed
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def from_flat(flat: Dict[str, np.ndarray], device=None) -> dict:
    """The port's tree from the reference's flat, layer-stacked arrays, on
    ``device`` (``None`` means cuda)."""
    device = device_lib.resolve(device)

    def tensor(a):
        return _from_numpy(a).to(device)

    return tree_lib.map(tensor, _unstack(_nest(dict(flat))))


def to_flat(tree: dict) -> Dict[str, np.ndarray]:
    """Inverse of :func:`from_flat`: numpy arrays keyed like the reference,
    with the leaves of each list stacked on a leading axis."""
    groups: Dict[str, list] = {}
    for path, leaf in tree_lib.leaves_with_paths(tree):
        key, stacked = tree_lib.reference_key(path)
        if stacked > 1:
            raise ValueError(f"nested lists are not a reference layout: "
                             f"{path}")
        groups.setdefault(key, []).append((stacked, _to_numpy(leaf)))
    return {k: (np.stack([a for _, a in v]) if v[0][0] else v[0][1])
            for k, v in sorted(groups.items())}
