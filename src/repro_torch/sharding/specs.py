"""Named-axis sharding rules (DP/FSDP/TP/EP/SP) for every model family, and
the placement that gives each mesh position its shard (the JAX package's
``sharding/specs.py``).

Mesh axes: ("data", "model") single-pod; ("pod", "data", "model") multi-pod.
The "pod" axis extends data parallelism (batch and FSDP shard over
("pod", "data")).

Parameter policy (2D "FSDP+TP", MaxText-style):
  column-parallel weights (wq/wk/wv/w_gate/w_up/w_in, (out, in)):
      out -> "model", in -> fsdp axes
  row-parallel weights (wo/w_down/w_out, (out, in)):
      out -> fsdp axes, in -> "model"
  embeddings / lm head (V, D):  V -> "model", D -> fsdp axes
  MoE experts (E, F, D): E -> "model" (EP) when E % |model| == 0, else
      F/D -> "model" (expert TP); the other matrix dim -> fsdp axes
  norms / biases / scalars: replicated
  QTensor leaves: payload inherits the weight rule; per-group scales inherit
      the same dims (group axis divides the contraction axis).

Dims are sharded only when divisible by the axis size, otherwise that dim
is replicated.

The rules walk the port's trees with the reference's leaf paths: a dict key
by its name, a NamedTuple field by its name, a list or tuple entry as
``[i]``, and the children of a ``QTensor`` / ``KVPage`` (data, scale), a
``PagedKV`` (data, scale, table), a ``SegmentedParams`` (its segments) and
a ``Segment`` (its params) as ``#0``, ``#1``, ``#2``. A spec is a ``P``, a
tuple with the entries of JAX's ``PartitionSpec``.

``shard_tree`` is the port's counterpart of ``to_shardings`` +
``device_put``: it gives every mesh position its own slice of every leaf
as a contiguous copy (never a view: the kernels refuse a strided or
misaligned payload); a leaf the spec replicates is shared by the positions
that sit on its device. A QTensor whose payload would shard its
contraction axis at a point that splits a quantization group is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.quant.apply import Segment, SegmentedParams
from repro_torch.quant.kvcache import KVPage, PagedKV
from repro_torch.quant.qtypes import QTensor
from repro_torch.sharding.collective import FSDPLeaf

COLUMN_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up", "w_in")
ROW_PARALLEL = ("wo", "w_down", "w_out")
EMBED = ("tok", "head")


class P(tuple):
    """A partition spec: one entry per dim, None (replicated), an axis name
    or a tuple of axis names (major to minor)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


# --------------------------------------------------------------------------
# Tree paths (the reference's key names)
# --------------------------------------------------------------------------

def _map_with_path(fn, tree, path=()):
    """``tree`` with each leaf replaced by ``fn(names, leaf)``; ``names``
    are the reference's path entries (see the module docstring). A ``P``
    is a leaf, so the same walk maps spec trees."""
    if tree is None:
        return None
    if isinstance(tree, P):
        return fn(list(path), tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, SegmentedParams):
        return SegmentedParams(
            segments=_map_with_path(fn, tree.segments, path + ("#0",)),
            num_layers=tree.num_layers)
    if isinstance(tree, Segment):
        return dataclasses.replace(
            tree, params=_map_with_path(fn, tree.params, path + ("#0",)))
    if isinstance(tree, (QTensor, KVPage)):
        return dataclasses.replace(
            tree, data=_map_with_path(fn, tree.data, path + ("#0",)),
            scale=_map_with_path(fn, tree.scale, path + ("#1",)))
    if isinstance(tree, PagedKV):
        return dataclasses.replace(
            tree, data=_map_with_path(fn, tree.data, path + ("#0",)),
            scale=_map_with_path(fn, tree.scale, path + ("#1",)),
            table=_map_with_path(fn, tree.table, path + ("#2",)))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(list(path), tree)


def flatten_with_names(tree) -> list:
    """[(path string, leaf), ...] of a tree or of a spec tree (whose leaves
    are ``P``s), paths ``/``-joined as ``_map_with_path`` names them."""
    out: list = []

    def visit(names, leaf):
        out.append(("/".join(names), leaf))
        return leaf

    _map_with_path(visit, tree)
    return out


# --------------------------------------------------------------------------
# The rules
# --------------------------------------------------------------------------

def _axis_size(mesh, name) -> int:
    """Product of the named axes' sizes; absent axes contribute 1 (a
    pure-DP serving mesh has no "model" axis, a pure-TP mesh no "data")."""
    names = name if isinstance(name, tuple) else (name,)
    return int(np.prod([mesh.shape[n] for n in names
                        if n in mesh.axis_names] or [1]))


def _present(mesh, name) -> bool:
    names = name if isinstance(name, tuple) else (name,)
    return all(n in mesh.axis_names for n in names)


def fsdp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _div(dim: int, mesh, axis) -> Optional[Any]:
    """axis if present in the mesh and dim divisible by its size, else None
    (replicate)."""
    if axis is None or not _present(mesh, axis):
        return None
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def _weight_spec(names: list, shape: tuple, mesh, fsdp: Any) -> P:
    """Spec for a (possibly layer-stacked, possibly expert-stacked)
    matrix."""
    leaf = None
    for n in reversed(names):
        if not n.startswith("#"):
            leaf = n
            break
    ndim = len(shape)
    if ndim <= 1:                       # norms / biases / 1D leaves
        return P()
    if leaf in EMBED:                   # embedding / head tables (V, D)
        return P(_div(shape[0], mesh, "model"), _div(shape[1], mesh, fsdp))
    n_stack = ndim - 2
    stack_spec: list = [None] * n_stack
    is_expert = (leaf in ("w_gate", "w_up", "w_down") and n_stack >= 1
                 and names and any("moe" in n for n in names))
    if is_expert:
        # (L?, E, F/D, D/F): the expert dim is the last stack dim
        e = shape[n_stack - 1]
        model_used = _div(e, mesh, "model") is not None
        if model_used:
            stack_spec[n_stack - 1] = "model"
        out_dim, in_dim = shape[-2], shape[-1]
        if leaf in ("w_gate", "w_up"):
            out_ax = "model" if not model_used else None
            spec = [_div(out_dim, mesh, out_ax) if out_ax else None,
                    _div(in_dim, mesh, fsdp)]
        else:
            in_ax = "model" if not model_used else None
            spec = [_div(out_dim, mesh, fsdp),
                    _div(in_dim, mesh, in_ax) if in_ax else None]
        return P(*stack_spec, *spec)
    if leaf in COLUMN_PARALLEL:
        return P(*stack_spec, _div(shape[-2], mesh, "model"),
                 _div(shape[-1], mesh, fsdp))
    if leaf in ROW_PARALLEL:
        return P(*stack_spec, _div(shape[-2], mesh, fsdp),
                 _div(shape[-1], mesh, "model"))
    if leaf == "router":
        return P(*stack_spec, None, None)
    if leaf == "conv_w":
        return P(*stack_spec, _div(shape[-2], mesh, "model"), None)
    # default 2D leaf: fsdp on the larger dim
    return P(*stack_spec, _div(shape[-2], mesh, fsdp), None)


def param_specs(params: Any, mesh, *, serving: bool = False) -> Any:
    """P tree matching ``params`` (QTensor-aware). ``serving=True`` keeps
    weights TP-sharded only (replicated over the data axes): decode re-reads
    the weights every step."""
    fsdp = None if serving else fsdp_axes(mesh)

    def spec_of(names, leaf):
        shape = tuple(leaf.shape)
        if names and names[-1] == "#1":         # QTensor scale
            base = _weight_spec(names[:-1], shape, mesh, fsdp)
            parts = list(base) + [None] * (len(shape) - len(base))
            parts = parts[:len(shape)]
            return P(*[ax if ax and shape[i] % _axis_size(mesh, ax) == 0
                       else None for i, ax in enumerate(parts)])
        if names and names[-1] == "#0":
            names = names[:-1]
        return _weight_spec(names, shape, mesh, fsdp)

    return _map_with_path(spec_of, params)


def batch_specs(batch: Any, mesh) -> Any:
    """tokens/labels (B, S) -> batch over (pod, data) when divisible."""
    fsdp = fsdp_axes(mesh)
    return _map_with_path(
        lambda _, leaf: P(_div(leaf.shape[0], mesh, fsdp),
                          *([None] * (len(leaf.shape) - 1))), batch)


def cache_specs(cache: Any, mesh) -> Any:
    """KV/SSM caches: batch dim over fsdp axes, head/state dims over model.

      KV:       (L, B, S, Hkv, hd)  raw, or a KVPage's int8 payload
      KV scale: (L, B, S, F/G)      and an int4 payload (L, B, S, F/2):
                only the slot dim shards
      conv:     (L, B, W-1, C)
      state:    (L, B, H, P, N)
      pos:      scalar or (B,)
    When the KV heads do not divide the model axis, the SEQUENCE dim
    shards instead (the GQA fallback)."""
    fsdp = fsdp_axes(mesh)

    def spec_of(names, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        field = next((n for n in reversed(names)
                      if not (n.startswith("#") or n.startswith("["))), "")
        is_scale = bool(names) and names[-1] == "#1"
        if names and names[-1] == "#2":         # PagedKV page table
            return P()
        if field in ("k", "v", "cross_k", "cross_v"):
            if is_scale or len(shape) == 4:
                return P(None, _div(shape[1], mesh, fsdp), None, None)
            if _div(shape[3], mesh, "model") is not None:
                return P(None, _div(shape[1], mesh, fsdp), None, "model",
                         None)
            return P(None, _div(shape[1], mesh, fsdp),
                     _div(shape[2], mesh, "model"), None, None)
        if field == "conv" and len(shape) == 4:
            return P(None, _div(shape[1], mesh, fsdp), None,
                     _div(shape[3], mesh, "model"))
        if field == "state" and len(shape) == 5:
            return P(None, _div(shape[1], mesh, fsdp),
                     _div(shape[2], mesh, "model"), None, None)
        parts = [None] * len(shape)
        if len(shape) >= 2:
            parts[1] = _div(shape[1], mesh, fsdp)
        return P(*parts)

    return _map_with_path(spec_of, cache)


def opt_state_specs(opt_state, pspecs, mesh):
    """Adam moments inherit the parameter specs (ZeRO); count replicated;
    an int8 moment's payload inherits, its scale is replicated."""
    from repro_torch.optim.adamw import AdamWState

    def moments(spec, moment):
        if isinstance(spec, P):
            if isinstance(moment, QTensor):
                return dataclasses.replace(moment, data=spec, scale=P())
            return spec
        if isinstance(spec, dict):
            return {k: moments(spec[k], moment[k]) for k in spec}
        if isinstance(spec, SegmentedParams):
            return SegmentedParams(
                segments=[moments(s, m) for s, m in
                          zip(spec.segments, moment.segments)],
                num_layers=spec.num_layers)
        if isinstance(spec, Segment):
            return dataclasses.replace(spec,
                                       params=moments(spec.params,
                                                      moment.params))
        if isinstance(spec, QTensor):
            return spec
        if isinstance(spec, (list, tuple)):
            return type(spec)(moments(s, m) for s, m in zip(spec, moment))
        return spec

    return AdamWState(count=P(), m=moments(pspecs, opt_state.m),
                      v=moments(pspecs, opt_state.v))


# --------------------------------------------------------------------------
# Placement
# --------------------------------------------------------------------------

class GroupSplitError(ValueError):
    """A shard boundary would fall inside a quantization group."""


def positions(mesh) -> list:
    """Every position's index tuple, in C order over the mesh axes."""
    return list(np.ndindex(*mesh.devices.shape))


def position_grid(mesh) -> np.ndarray:
    """(R, T) object array of position index tuples: R rows over the data
    axes (C order, the order of ``split_data_replicas``), T columns along
    "model" (1 without a model axis). Axes other than pod/data/model are
    refused."""
    names = mesh.axis_names
    extra = [a for a in names if a not in ("pod", "data", "model")]
    if extra:
        raise ValueError(f"mesh axes {extra} are neither data nor model "
                         f"axes; the port serves over pod/data/model only")
    t = mesh.shape["model"] if "model" in names else 1
    r = mesh.size // t
    idx = np.empty(mesh.devices.shape, dtype=object)
    for pos in positions(mesh):
        idx[pos] = pos
    if "model" in names:
        idx = np.moveaxis(idx, names.index("model"), -1)
    return idx.reshape(r, t)


def _bounds(entry, shape_dim: int, coords: dict, mesh) -> tuple:
    """(lo, hi) of this position's slice of one dim under spec ``entry``."""
    if entry is None:
        return 0, shape_dim
    names = entry if isinstance(entry, tuple) else (entry,)
    k, count = 0, 1
    for n in names:
        k = k * mesh.shape[n] + coords[n]
        count *= mesh.shape[n]
    step = shape_dim // count
    return k * step, (k + 1) * step


def _copy_slice(x: torch.Tensor, bounds: tuple, device) -> torch.Tensor:
    """A contiguous copy of ``x[bounds]`` on ``device``."""
    view = x[tuple(slice(lo, hi) for lo, hi in bounds)]
    out = torch.empty(view.shape, dtype=x.dtype, device=device)
    out.copy_(view)
    return out


def _place_leaf(x: torch.Tensor, spec: P, coords: dict, mesh, device,
                memo: dict) -> torch.Tensor:
    bounds = tuple(_bounds(spec[i] if i < len(spec) else None, x.shape[i],
                           coords, mesh) for i in range(x.ndim))
    whole = all(lo == 0 and hi == n for (lo, hi), n in zip(bounds, x.shape))
    if whole and x.device == device:
        return x                        # replicated: shared, not copied
    key = (id(x), str(device), bounds)
    if key not in memo:
        memo[key] = (x, _copy_slice(x, bounds, device))
    return memo[key][1]


def _sharded_dims(spec, ndim: int) -> list:
    return [i for i in range(ndim) if i < len(spec) and spec[i] is not None]


def _place_qtensor(q: QTensor, spec: QTensor, coords: dict, mesh, device,
                   memo: dict, name: str) -> QTensor:
    """Position ``coords``' QTensor: payload and scales each by its spec. A
    scale spec of ``P()`` (an int8 Adam moment, ``opt_state_specs``)
    replicates the whole scale array beside the payload's slice: the
    optimizer finds a slice's groups in it (``optim/adamw.py``)."""
    dspec, sspec = spec.data, spec.scale
    nd = q.data.ndim
    if len(sspec) and (_sharded_dims(dspec, nd)
                       != _sharded_dims(sspec, q.scale.ndim)):
        raise GroupSplitError(
            f"{name}: the payload shards dims {_sharded_dims(dspec, nd)} but "
            f"its group scales {_sharded_dims(sspec, q.scale.ndim)}: a shard "
            f"of the contraction axis ({q.shape[-1]} over "
            f"{_axis_size(mesh, dspec[-1])}) would split a quantization "
            f"group of {q.group}; serve with a group that divides the shard "
            f"(split groups: ROADMAP.md queue 1 item 10)")
    data = _place_leaf(q.data, dspec, coords, mesh, device, memo)
    scale = _place_leaf(q.scale, sspec, coords, mesh, device, memo)
    shape = list(q.shape)
    for i in range(len(shape)):
        full = q.data.shape[i]
        if data.shape[i] != full:
            shape[i] = shape[i] * data.shape[i] // full
    return QTensor(data=data, scale=scale, precision=q.precision,
                   shape=tuple(shape), group=q.group)


def _zip_map(fn, tree, specs, name: str = ""):
    """``tree`` rebuilt with each leaf (a tensor, or a QTensor as one leaf)
    replaced by ``fn(leaf, its spec, its path)``; ``specs`` has the
    tree's structure."""
    if tree is None:
        return None
    if isinstance(tree, (QTensor, torch.Tensor)):
        return fn(tree, specs, name)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k], f"{name}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, SegmentedParams):
        return SegmentedParams(
            segments=[_zip_map(fn, g, sg, f"{name}/{i}") for i, (g, sg) in
                      enumerate(zip(tree.segments, specs.segments))],
            num_layers=tree.num_layers)
    if isinstance(tree, Segment):
        return dataclasses.replace(tree, params=_zip_map(fn, tree.params,
                                                         specs.params, name))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, sv, f"{name}/{k}") for k, v, sv
                            in zip(tree._fields, tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, sv, f"{name}/{i}")
                          for i, (v, sv) in enumerate(zip(tree, specs)))
    return tree


def refill(tree, specs, leaves: list):
    """``tree`` with its leaves (a QTensor one leaf) replaced, in order, by
    ``leaves``."""
    it = iter(leaves)
    return _zip_map(lambda *_: next(it), tree, specs)


def place_tree(tree, specs, mesh, pos: tuple, memo: Optional[dict] = None):
    """Position ``pos``'s shard of ``tree`` under ``specs``."""
    memo = {} if memo is None else memo
    coords = dict(zip(mesh.axis_names, pos))
    device = mesh.devices[pos]

    def place(leaf, spec, name):
        if isinstance(leaf, QTensor):
            return _place_qtensor(leaf, spec, coords, mesh, device, memo,
                                  name)
        return _place_leaf(leaf, spec, coords, mesh, device, memo)

    return _zip_map(place, tree, specs)


def _leaves(tree, specs) -> list:
    """(leaf, spec) pairs of a parameter tree, a QTensor counted as one
    leaf, in the tree's order."""
    out: list = []

    def visit(leaf, spec, _):
        out.append((leaf, spec))
        return leaf

    _zip_map(visit, tree, specs)
    return out


def _nbytes(leaf) -> int:
    parts = (leaf.data, leaf.scale) if isinstance(leaf, QTensor) else (leaf,)
    return sum(t.numel() * t.element_size() for t in parts)


def physical_nbytes(tree) -> float:
    """Bytes a parameter tree's tensors hold (payloads and scales)."""
    return float(sum(_nbytes(leaf) for leaf, _ in _leaves(tree, tree)))


def _split(spec, mesh) -> int:
    """The positions that share a leaf out under ``spec``."""
    p = spec.data if isinstance(spec, QTensor) else spec
    return int(np.prod([_axis_size(mesh, ax) for ax in p if ax is not None]
                       or [1]))


def predicted_position_nbytes(tree, specs, mesh) -> float:
    """The physical bytes one position would hold once ``tree`` is placed
    under ``specs``: each leaf's bytes over the positions it is split
    across (a prediction read off the specs, before any placement)."""
    return float(sum(_nbytes(leaf) / _split(spec, mesh)
                     for leaf, spec in _leaves(tree, specs)))


@dataclasses.dataclass
class MeshTree:
    """A tree placed on a mesh: ``trees[pos]`` is position ``pos``'s shard
    (an object ndarray over the mesh axes); ``specs`` the P tree it was
    placed by."""
    mesh: Any
    specs: Any
    trees: np.ndarray

    def at(self, pos: tuple):
        return self.trees[pos]

    def field(self, i: int) -> "MeshTree":
        """The placement of entry ``i`` of a placed tuple (a restored
        ``(params, AdamWState)``: 0 the params, 1 the optimizer state)."""
        trees = np.empty(self.trees.shape, dtype=object)
        for pos in positions(self.mesh):
            trees[pos] = self.trees[pos][i]
        return MeshTree(mesh=self.mesh, specs=self.specs[i], trees=trees)

    def position_nbytes(self) -> dict:
        """Physical bytes each position holds, by position."""
        return {pos: physical_nbytes(self.trees[pos])
                for pos in positions(self.mesh)}

    def logical_nbytes(self) -> float:
        """Effective bytes of the whole tree (ternary at 1.58 bits): each
        position's share of a leaf is its bytes over the positions that
        hold the same slice."""
        total = 0.0
        for pos in positions(self.mesh):
            for leaf, spec in _leaves(self.trees[pos], self.specs):
                eff = (leaf.nbytes_effective() if isinstance(leaf, QTensor)
                       else _nbytes(leaf))
                total += eff * _split(spec, self.mesh) / self.mesh.size
        return total


def shard_tree(tree, specs, mesh) -> MeshTree:
    """Give every position of ``mesh`` its own slice of every leaf of
    ``tree`` under ``specs`` (contiguous copies; replicated leaves shared
    by the positions on their device)."""
    memo: dict = {}
    trees = np.empty(mesh.devices.shape, dtype=object)
    for pos in positions(mesh):
        trees[pos] = place_tree(tree, specs, mesh, pos, memo)
    return MeshTree(mesh=mesh, specs=specs, trees=trees)


# --------------------------------------------------------------------------
# A placement's slices (training: gradients, the optimizer, checkpoints)
# --------------------------------------------------------------------------

def _slice_bounds(spec, shape: tuple, coords: dict, mesh) -> tuple:
    """(lo, hi) of each dim of a position's slice of local ``shape`` under
    ``spec``, in the coordinates of the logical array."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        count = 1 if entry is None else _axis_size(mesh, entry)
        out.append(_bounds(entry, n * count, coords, mesh))
    return tuple(out)


def _by_leaf(mt: MeshTree) -> list:
    """For each leaf of ``mt`` in tree order, [(position, leaf, spec,
    coords), ...] over the positions in C order."""
    out: list = []
    for pos in positions(mt.mesh):
        coords = dict(zip(mt.mesh.axis_names, pos))
        leaves = _leaves(mt.trees[pos], mt.specs)
        if not out:
            out = [[] for _ in leaves]
        for k, (leaf, spec) in enumerate(leaves):
            out[k].append((pos, leaf, spec, coords))
    return out


def placed_slices(mt: MeshTree) -> list:
    """For each leaf of ``mt`` in tree order, [(position, bounds, leaf),
    ...] over the positions in C order: ``bounds`` are the slice's (lo, hi)
    per dim in the logical leaf (a QTensor's, its payload's). Positions
    with equal bounds hold the same slice (one tensor on one device)."""
    out = []
    for entries in _by_leaf(mt):
        row = []
        for pos, leaf, spec, coords in entries:
            data, dspec = ((leaf.data, spec.data) if isinstance(leaf, QTensor)
                           else (leaf, spec))
            row.append((pos, _slice_bounds(dspec, tuple(data.shape), coords,
                                           mt.mesh), leaf))
        out.append(row)
    return out


def distinct_leaves(mt: MeshTree) -> list:
    """Each distinct leaf object of ``mt`` once, first seen in position
    order (a leaf the positions on one device share counts once)."""
    seen: dict = {}
    for pos in positions(mt.mesh):
        for leaf, _ in _leaves(mt.trees[pos], mt.specs):
            seen.setdefault(id(leaf), leaf)
    return list(seen.values())


def map_placed(fn, mt: MeshTree) -> MeshTree:
    """``mt`` with ``fn`` applied once to each distinct leaf: a leaf that
    positions share stays shared."""
    memo: dict = {}

    def one(leaf, spec, name):
        if id(leaf) not in memo:
            memo[id(leaf)] = fn(leaf)
        return memo[id(leaf)]

    trees = np.empty(mt.trees.shape, dtype=object)
    for pos in positions(mt.mesh):
        trees[pos] = _zip_map(one, mt.trees[pos], mt.specs)
    return MeshTree(mesh=mt.mesh, specs=mt.specs, trees=trees)


def _assemble(parts: list, device) -> torch.Tensor:
    """One array from its slices [(bounds, tensor), ...]; repeated bounds
    (replicas) are written once."""
    shape = tuple(max(b[i][1] for b, _ in parts)
                  for i in range(len(parts[0][0])))
    out = torch.empty(shape, dtype=parts[0][1].dtype, device=device)
    if out.device.type == "meta":
        return out
    done = set()
    for b, x in parts:
        if b not in done:
            done.add(b)
            out[tuple(slice(lo, hi) for lo, hi in b)].copy_(x)
    return out


def gather_tree(mt: MeshTree, device=None):
    """The logical tree of a placement (the inverse of ``shard_tree``):
    every leaf's slices written into one array on ``device`` (default the
    first position's; "meta" gives a skeleton), in position order. A
    QTensor's payload and scales are each assembled by their specs."""
    first = positions(mt.mesh)[0]
    device = torch.device(mt.mesh.devices[first] if device is None
                          else device)
    whole = []
    for entries in _by_leaf(mt):
        leaf0 = entries[0][1]
        if not isinstance(leaf0, QTensor):
            whole.append(_assemble([
                (_slice_bounds(spec, tuple(x.shape), c, mt.mesh), x)
                for _, x, spec, c in entries], device))
            continue
        data = _assemble([(_slice_bounds(spec.data, tuple(x.data.shape), c,
                                         mt.mesh), x.data)
                          for _, x, spec, c in entries], device)
        scale = _assemble([(_slice_bounds(spec.scale, tuple(x.scale.shape),
                                          c, mt.mesh), x.scale)
                           for _, x, spec, c in entries], device)
        shape = tuple(n * data.shape[i] // leaf0.data.shape[i]
                      for i, n in enumerate(leaf0.shape))
        whole.append(QTensor(data=data, scale=scale,
                             precision=leaf0.precision, shape=shape,
                             group=leaf0.group))
    return refill(mt.trees[first], mt.specs, whole)


def fsdp_view(mt: MeshTree, row: int, col: int):
    """Position (``row``, ``col``) of ``position_grid``'s tree for a mesh
    train step: each leaf the specs shard over the data axes becomes an
    ``FSDPLeaf`` of its model column's slices (every data row's, in
    position order) to be gathered on this position's device; every other
    leaf is the position's own (TP-sharded or replicated)."""
    mesh = mt.mesh
    grid = position_grid(mesh)
    fsdp = fsdp_axes(mesh)
    column = [[leaf for leaf, _ in _leaves(mt.trees[grid[r, col]], mt.specs)]
              for r in range(grid.shape[0])]
    own = mt.trees[grid[row, col]]
    device = mesh.devices[grid[row, col]]
    out = []
    for k, (leaf, spec) in enumerate(_leaves(own, mt.specs)):
        if isinstance(leaf, QTensor):
            raise TypeError("a mesh train step takes raw weights, not "
                            "QTensors")
        dims = [i for i, ax in enumerate(spec) if ax == fsdp]
        out.append(FSDPLeaf([c[k] for c in column], dims[0], device)
                   if dims and len(column) > 1 else leaf)
    return refill(own, mt.specs, out)


def serving_param_specs(params, mesh):
    return param_specs(params, mesh, serving=True)


def serving_shard(params, mesh) -> MeshTree:
    """TP-only serving placement of a (possibly segmented / quantized)
    parameter tree."""
    return shard_tree(params, serving_param_specs(params, mesh), mesh)
