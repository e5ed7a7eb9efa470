"""Nested parameter trees (dicts, lists and tuples of tensors): paths,
their printed names, and the carry of numpy weights onto a device.

A path is a tuple of keys, a ``str`` for a dict entry and an ``int`` for a
list or tuple entry.  Dicts are walked in sorted key order and sequences in
index order, so leaves come out in the order ``jax.tree_util`` flattens the
same tree, and :func:`keystr` prints a path as
``jax.tree_util.keystr`` does, e.g. ``['segments'][0]['mlp']['wi']``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

Path = Tuple[Any, ...]


def flatten_with_path(tree) -> List[Tuple[Path, Any]]:
    """(path, leaf) for every leaf of ``tree``; anything that is not a
    dict, list or tuple is a leaf."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def map_with_path(fn: Callable[[Path, Any], Any], tree):
    """A tree of the same structure with every leaf replaced by
    ``fn(path, leaf)``."""
    def walk(node, path):
        if isinstance(node, dict):
            return {key: walk(node[key], path + (key,)) for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(child, path + (i,))
                              for i, child in enumerate(node))
        return fn(path, node)

    return walk(tree, ())


def keystr(path: Path) -> str:
    """The path's printed name: ``[repr(key)]`` for a dict key, ``[i]``
    for a sequence index."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
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
