"""Carry parameters from the JAX package into the port.

``from_jax(tree, device)`` takes the JAX package's parameters after
``jax.tree.map(np.asarray, ...)`` (numpy leaves, with QTensor / Segment /
SegmentedParams / KVPage nodes still in place) and returns the port's tree
on ``device``. Nodes are recognised by their fields, so this module imports
nothing of the JAX package:

* ``(data, scale, precision, shape, group)``      -> ``QTensor``
* ``(precision, start, stop, params)``            -> ``Segment``
* ``(segments, num_layers)``                      -> ``SegmentedParams``
* ``(data, scale, precision, head_dim, group)``   -> ``KVPage``
* dicts, lists, tuples and NamedTuples keep their structure.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays and are carried over
bit for bit through a uint16 view; int8 payloads keep their bytes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.quant.apply import Segment, SegmentedParams
from repro_torch.quant.kvcache import KVPage
from repro_torch.quant.qtypes import QTensor

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64,
           np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
           np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int64, np.dtype(np.bool_): torch.bool}


def to_torch(a, device="cpu") -> torch.Tensor:
    """One numpy array (bf16 via ml_dtypes included) -> torch tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    if a.dtype not in _DTYPES:
        raise TypeError(f"cannot carry dtype {a.dtype} over")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _has(x, *names) -> bool:
    return all(hasattr(x, n) for n in names)


def from_jax(tree: Any, device="cpu") -> Any:
    """Convert a numpy-leaved JAX parameter tree (see module docstring)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)):
        return to_torch(tree, device)
    if _has(tree, "data", "scale", "precision", "head_dim", "group"):
        return KVPage(data=to_torch(tree.data, device),
                      scale=from_jax(tree.scale, device),
                      precision=tree.precision, head_dim=tree.head_dim,
                      group=tree.group)
    if _has(tree, "data", "scale", "precision", "shape", "group"):
        return QTensor(data=to_torch(tree.data, device),
                       scale=to_torch(tree.scale, device),
                       precision=tree.precision, shape=tuple(tree.shape),
                       group=tree.group)
    if _has(tree, "segments", "num_layers"):
        return SegmentedParams(
            segments=[from_jax(s, device) for s in tree.segments],
            num_layers=tree.num_layers)
    if _has(tree, "precision", "start", "stop", "params"):
        return Segment(precision=tree.precision, start=tree.start,
                       stop=tree.stop, params=from_jax(tree.params, device))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(from_jax(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax(v, device) for v in tree)
    if hasattr(tree, "__array__"):
        return to_torch(tree, device)
    return tree
