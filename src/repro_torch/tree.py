"""Small helpers over parameter trees: nested dicts / lists / tuples of
tensors, where a ``QTensor`` counts as one leaf."""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.quant.qtypes import QTensor


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf (tensor or QTensor); containers keep
    their structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_index(tree: Any, i: int) -> Any:
    """Entry ``i`` of a tree stacked over a leading layer axis (views)."""
    return tree_map(lambda x: x.index(i) if isinstance(x, QTensor) else x[i],
                    tree)


def _unstack_leaf(x: Any, n: int):
    if isinstance(x, QTensor):
        return [x.index(i) for i in range(n)]
    if isinstance(x, torch.Tensor):
        return torch.unbind(x, 0)
    return x.unstack(n)         # a mesh train step's FSDPLeaf


def tree_unstack(tree: Any, n: int) -> list:
    """The ``n`` entries of a tree stacked over a leading layer axis (views,
    as ``tree_index``), each tensor leaf split once by ``torch.unbind``:
    under autograd the layers' gradients then go back to the stack in one
    op, where ``n`` separate ``x[i]`` would each add a zero-filled copy of
    the whole stack."""
    split = [_unstack_leaf(x, n) for x in tree_leaves(tree)]
    out = []
    for i in range(n):
        it = iter([s[i] for s in split])
        out.append(tree_map(lambda _: next(it), tree))
    return out
