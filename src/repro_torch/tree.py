"""Nested dict/list trees of tensors: the port's parameter and optimizer
state containers (the reference's pytrees, with ``layers`` a list)."""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import torch


def leaves_with_paths(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, object]]:
    """``(path, leaf)`` in a fixed order: dict keys sorted, lists in order;
    a path holds the dict keys and list indices that lead to the leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_paths(tree[key], path + (key,))
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from leaves_with_paths(sub, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def map_with_path(fn: Callable, tree, *rest, path: Tuple = ()):
    """``fn(path, leaf, *other_leaves)`` over trees of one structure,
    visiting the leaves in :func:`leaves_with_paths` order."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 path=path + (k,)) for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_with_path(fn, t, *(r[i] for r in rest), path=path + (i,))
                for i, t in enumerate(tree)]
    return fn(path, tree, *rest)


def map(fn: Callable, tree, *rest):  # noqa: A001 - mirrors jax.tree.map
    return map_with_path(lambda _, *leaves_: fn(*leaves_), tree, *rest)


def reference_key(path: Tuple) -> Tuple[str, int]:
    """(key, stacked): the reference's flat key of a leaf (list indices
    dropped, since the reference stacks each list on a leading axis) and
    how many such axes it has there."""
    keys = [str(p) for p in path if not isinstance(p, int)]
    return "/".join(keys), sum(isinstance(p, int) for p in path)


def unflat(vec: torch.Tensor, like):
    """``like``'s tree over consecutive pieces of the 1-D ``vec``: views,
    each shaped as its ``like`` leaf."""
    pieces = iter(torch.split(vec, [x.numel() for x in leaves(like)]))
    return map(lambda x: next(pieces).view(x.shape), like)


def pack(tree):
    """A copy of ``tree`` (one dtype, one device) whose leaves are
    consecutive views of one 1-D buffer, so that :func:`flat` reads the
    whole tree as that buffer, without a copy."""
    return unflat(torch.cat([x.detach().reshape(-1) for x in leaves(tree)]),
                  tree)


def packed(ls) -> Optional[torch.Tensor]:
    """The 1-D buffer ``ls`` are consecutive contiguous pieces of, or
    None."""
    first = ls[0]
    base, end = first.storage_offset(), first.storage_offset()
    ptr = first.untyped_storage().data_ptr()
    for x in ls:
        if (x.dtype != first.dtype or not x.is_contiguous()
                or x.untyped_storage().data_ptr() != ptr
                or x.storage_offset() != end):
            return None
        end += x.numel()
    return first.as_strided((end - base,), (1,), base)


def flat(ls) -> torch.Tensor:
    """The leaves ``ls``, in order, as one 1-D tensor: their buffer itself
    when they are packed (see :func:`pack`; writes to it reach them), else
    a concatenated copy."""
    vec = packed(ls)
    return vec if vec is not None else torch.cat([x.reshape(-1) for x in ls])
