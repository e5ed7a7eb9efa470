"""Nested parameter trees (dicts, lists and tuples of tensors): paths,
their printed names, and the carry of numpy weights onto a device.

A path is a tuple of keys: a ``str`` for a dict entry, an ``int`` for a
list or tuple entry and an :class:`Attr` for a field of a named tuple (an
optimizer state).  Dicts are walked in sorted key order, sequences in index
order and named tuples in field order; ``None`` is an empty subtree, no
leaf.  So leaves come out in the order ``jax.tree_util`` flattens the same
tree, and :func:`keystr` prints a path as ``jax.tree_util.keystr`` does,
e.g. ``['segments'][0]['mlp']['wi']`` or ``[1].m['embed']['tok']``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

Path = Tuple[Any, ...]


class Attr(str):
    """A path key naming a field of a named tuple, printed ``.name``."""


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _collect(node, path: Path, out: List[Tuple[Path, Any]]) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for key in sorted(node):
            _collect(node[key], path + (key,), out)
    elif _is_namedtuple(node):
        for name in node._fields:
            _collect(getattr(node, name), path + (Attr(name),), out)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            _collect(child, path + (i,), out)
    else:
        out.append((path, node))


def flatten_with_path(tree) -> List[Tuple[Path, Any]]:
    """(path, leaf) for every leaf of ``tree``; anything that is not a
    dict, list, tuple or None is a leaf.  (A module-level walk: a nested one that
    closed over the list would form a reference cycle, and the leaves
    would live on until the cycle collector ran.)"""
    out: List[Tuple[Path, Any]] = []
    _collect(tree, (), out)
    return out


def map_with_path(fn: Callable[[Path, Any], Any], tree):
    """A tree of the same structure with every leaf replaced by
    ``fn(path, leaf)``."""
    return _map(fn, tree, ())


def _map(fn, node, path: Path):
    if node is None:
        return None
    if isinstance(node, dict):
        return {key: _map(fn, node[key], path + (key,)) for key in node}
    if _is_namedtuple(node):
        return type(node)(*(_map(fn, getattr(node, name), path + (Attr(name),))
                            for name in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_map(fn, child, path + (i,))
                          for i, child in enumerate(node))
    return fn(path, node)


def at(tree, path: Path):
    """The subtree (or leaf) of ``tree`` at ``path``."""
    for key in path:
        tree = getattr(tree, key) if isinstance(key, Attr) else tree[key]
    return tree


def keystr(path: Path) -> str:
    """The path's printed name: ``[repr(key)]`` for a dict key, ``[i]``
    for a sequence index, ``.name`` for a named tuple's field."""
    return "".join(f".{k}" if isinstance(k, Attr)
                   else f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                   for k in path)


def to_tensor(a, device) -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` reads) as a tensor of
    the same dtype and values on ``device``; bfloat16 arrays keep their
    bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16), order="C"))
        return t.view(torch.bfloat16).to(device)
    # a copy: the tensor never aliases the caller's (maybe read-only) array
    return torch.from_numpy(np.array(a, order="C")).to(device)


def params_from_numpy(tree, device):
    """Carry a nested tree of arrays (a model's weights) onto ``device``
    as tensors, structure and leaf order kept."""
    return map_with_path(lambda _, leaf: to_tensor(leaf, device), tree)
