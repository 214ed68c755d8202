"""Small helpers over parameter trees: nested dicts / lists / tuples of
tensors, where a ``QTensor`` counts as one leaf."""

from __future__ import annotations

from typing import Any, Callable

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
