"""Activation-sharding context: logical-dim rules visible inside model code
(the JAX package's ``sharding/ctx.py``).

Model code marks activations with *logical* dims through
``constrain(x, ("batch", None, "model"))``; ``activation_sharding(mesh)``
installs the mapping from logical dims to mesh axes. The port places every
shard itself (``sharding/specs.py``), so ``constrain`` moves nothing: it
checks the tensor's rank against its logical dims and returns it
(``activation_spec`` reads the P the rules give it). Outside the context
it is a no-op.

Logical dims:
  "batch"  -> ("pod", "data") / "data"   (the FSDP/DP axes)
  "model"  -> "model"                     (TP/EP axis)
  "expert" -> "model"
  "seq"    -> "model"
A dim is only sharded when its size divides the axis size.

``unshard_fsdp`` is the reference's FSDP materialization point: under a
training placement (a mesh train step, ``train/step.py``) it gathers each
weight's data-axis slices to its TP-only shape; serving weights are placed
TP-only, so there it is the identity. ``cost_mode`` /
``unroll_flag`` are kept for the dry-run, which lowers reduced-depth
variants with every layer loop unrolled.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.sharding.collective import FSDPLeaf
from repro_torch.sharding.specs import P
from repro_torch.tree import tree_leaves, tree_map

_STATE = threading.local()


def _rules():
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def activation_sharding(mesh):
    """Install the logical-dim -> mesh-axis mapping. Tolerates meshes
    missing an axis (a pure-DP serving mesh has no "model"; pure-TP no
    "data"): the absent logical dim maps to no axis (size 1, always
    divides, always replicated)."""
    fsdp = ("pod", "data") if "pod" in mesh.axis_names else "data"
    fsdp_t = fsdp if isinstance(fsdp, tuple) else (fsdp,)
    if not all(a in mesh.axis_names for a in fsdp_t):
        fsdp, fsdp_t = None, ()
    model_ax = "model" if "model" in mesh.axis_names else None
    model_sz = mesh.shape["model"] if model_ax else 1
    sizes = {"batch": int(np.prod([mesh.shape[a] for a in fsdp_t] or [1])),
             "model": model_sz, "expert": model_sz, "seq": model_sz}
    axes = {"batch": fsdp, "model": model_ax, "expert": model_ax,
            "seq": model_ax}
    old = _rules()
    _STATE.rules = {"axes": axes, "sizes": sizes, "mesh": mesh}
    try:
        yield
    finally:
        _STATE.rules = old


def activation_spec(shape: Sequence[int],
                    dims: Sequence[Optional[str]]) -> Optional[P]:
    """The P the installed rules give a tensor of ``shape`` marked with
    ``dims`` (None outside the context)."""
    rules = _rules()
    if rules is None:
        return None
    assert len(dims) == len(shape), (dims, tuple(shape))
    parts = []
    for name, size in zip(dims, shape):
        if name is None or size % rules["sizes"][name] != 0:
            parts.append(None)
        else:
            parts.append(rules["axes"][name])
    return P(*parts)


def constrain(x, dims: Sequence[Optional[str]]):
    """``x`` unchanged; inside the context its rank must match ``dims``."""
    activation_spec(tuple(x.shape), dims)
    return x


def data_shards() -> int:
    """Size of the data (batch) axes, 1 outside the context."""
    rules = _rules()
    return rules["sizes"]["batch"] if rules else 1


def model_shards() -> int:
    rules = _rules()
    return rules["sizes"]["model"] if rules else 1


def unshard_fsdp(tree):
    """FSDP materialization of a layer body (or the embedding, or the
    head): every ``FSDPLeaf`` of ``tree`` gathered over the data rows of
    its model column to the leaf's TP-only shape (the reference strips the
    FSDP axes from each leaf's spec), in position order on the row
    position's device. The gathers carry gradients, so the backward sums
    each slice's gradient over the rows. A tree without an ``FSDPLeaf``
    (serving, or any mesh-less tree) comes back as it is."""
    if not any(isinstance(x, FSDPLeaf) for x in tree_leaves(tree)):
        return tree
    return tree_map(lambda x: x.unshard() if isinstance(x, FSDPLeaf) else x,
                    tree)


@contextlib.contextmanager
def cost_mode():
    old = getattr(_STATE, "cost_mode", False)
    _STATE.cost_mode = True
    try:
        yield
    finally:
        _STATE.cost_mode = old


def in_cost_mode() -> bool:
    return getattr(_STATE, "cost_mode", False)


def unroll_flag():
    """True (unroll every layer loop) in cost mode, else 1."""
    return True if in_cost_mode() else 1
