"""Weight bridge between the reference's parameter tree and the port's.

The reference stores a model as a pytree whose per-layer leaves are
stacked on a leading ``n_layers`` axis; flattened with its
``checkpoint.manager.flatten_with_paths`` the keys are ``/``-joined dict
keys such as ``layers/mlp/up/w1`` ``(n_layers, n, d_out, d_in)``,
``layers/attn/wq/w``, ``pos/table`` and ``final_norm/scale``.  The port
keeps ``layers`` as a list of per-layer dicts.  :func:`from_flat` takes
that flat dict of numpy arrays to port parameters on a device;
:func:`to_flat` is its inverse.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import device as device_lib

_LAYERS = "layers"


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


def from_flat(flat: Dict[str, np.ndarray], device=None) -> dict:
    """Port parameters from the reference's flat, layer-stacked arrays, on
    ``device`` (``None`` means cuda)."""
    device = device_lib.resolve(device)
    stacked = {k[len(_LAYERS) + 1:]: v for k, v in flat.items()
               if k.startswith(_LAYERS + "/")}
    rest = {k: v for k, v in flat.items() if not k.startswith(_LAYERS + "/")}
    n_layers = {np.shape(v)[0] for v in stacked.values()}
    if len(n_layers) > 1:
        raise ValueError(f"inconsistent layer axes: {sorted(n_layers)}")
    n = n_layers.pop() if n_layers else 0

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    params = _nest({k: tensor(v) for k, v in rest.items()})
    params[_LAYERS] = [_nest({k: tensor(np.asarray(v)[i])
                              for k, v in stacked.items()})
                       for i in range(n)]
    return params


def to_flat(params: dict) -> Dict[str, np.ndarray]:
    """Inverse of :func:`from_flat`: numpy arrays keyed like the reference,
    with the per-layer tensors stacked on a leading axis."""
    layers = [flatten_with_paths(lp) for lp in params[_LAYERS]]
    flat = flatten_with_paths({k: v for k, v in params.items()
                               if k != _LAYERS})
    out = {k: v.detach().cpu().numpy() for k, v in flat.items()}
    for key in (layers[0] if layers else {}):
        out[f"{_LAYERS}/{key}"] = np.stack(
            [lp[key].detach().cpu().numpy() for lp in layers])
    return out
