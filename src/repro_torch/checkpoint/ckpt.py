"""Checkpoints with atomic step directories, and compiled-plan artifacts.

Layout (the JAX package's format, so an artifact written by either package
loads in the other):

  <dir>/step_00000000/
      manifest.json         # leaf keys, shapes, dtypes, crc32 per payload
      shard_0.npz           # every payload array (one host writes here)
      .complete             # commit marker (tmp dir renamed into place)
  <dir>/plan_manifest.json  # artifacts only: family, plan, segment layout

Leaf keys are the JAX package's pytree paths joined by ``/``. The port's
``SegmentedParams`` and ``Segment`` are plain dataclasses, so the flattener
here spells out the reference's child order: a stack's leaves sit under
``<stack>/0/<segment index>/0/...`` (``SegmentedParams`` child 0 is its
segment list, ``Segment`` child 0 is its params), every other leaf under its
dict path (``embed/tok``, ``final/norm``), a NamedTuple's by field name and
a tuple's by index: a training checkpoint of ``(params, AdamWState)``
keeps ``0/embed/tok``, ``1/count``, ``1/m/embed/tok``, as the reference
writes them. A ``QTensor`` is stored as two
arrays, ``<key>.__qdata`` and ``<key>.__qscale``. npz cannot hold bfloat16,
so bf16 payloads go to disk as their uint16 bits with ``"bfloat16"`` in the
manifest, through a torch view (no ``ml_dtypes``).

Restores go by key into a skeleton tree (tensors on the meta device are
enough: only shapes and the leaf kinds are read), and every leaf moves from
the host arrays straight onto the target device.

A tree placed on a mesh (``sharding.specs.MeshTree``, or a tuple of them:
a mesh train step's ``(params, AdamWState)``) is saved as its logical
arrays under the keys of an unsharded save, so a checkpoint does not
record the mesh that wrote it (beyond what a caller puts in ``extra``),
and ``restore(mesh=, specs=)`` lays it onto any mesh, or none.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.quant.apply import Segment, SegmentedParams
from repro_torch.quant.qtypes import QTensor
from repro_torch.runtime.fault import retry

# numpy dtypes npz stores as they are; bfloat16 is carried as uint16 bits
_NP_OF_TORCH = {torch.float32: np.float32, torch.float64: np.float64,
                torch.float16: np.float16, torch.int8: np.int8,
                torch.uint8: np.uint8, torch.int16: np.int16,
                torch.int32: np.int32, torch.int64: np.int64,
                torch.bool: np.bool_}


class ArtifactCorruptionError(RuntimeError):
    """A checkpoint/artifact payload failed integrity verification. Names
    the bad leaf, so a corrupt artifact is diagnosable at load time instead
    of surfacing as an opaque shape or dtype error."""

    def __init__(self, leaf: str, detail: str):
        super().__init__(f"artifact payload corrupt at leaf {leaf!r}: "
                         f"{detail}")
        self.leaf = leaf


def _crc(arr: np.ndarray) -> int:
    """crc32 of the STORED byte payload (post-bitcast view), read in place
    (no ``tobytes`` copy; the same value)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _check_crc(key: str, meta: dict, stored: list) -> None:
    """Verify the per-leaf checksums stamped at save time. Checkpoints
    without ``crc32`` in a leaf's entry pass unverified."""
    want = meta.get("crc32")
    if want is None:
        return
    got = [_crc(a) for a in stored]
    if got != list(want):
        raise ArtifactCorruptionError(
            key, f"crc32 {got} != manifest {list(want)}: the payload "
            f"was damaged after save (truncated/flipped bytes)")


def _payload(data: dict, name: str, leaf_key: str) -> np.ndarray:
    arr = data.get(name)
    if arr is None:
        raise ArtifactCorruptionError(
            leaf_key, f"stored array {name!r} missing from the shard "
            f"files (truncated checkpoint?)")
    return arr


def _to_storable(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """Tensor -> (array npz can store, numpy dtype name for the manifest).
    bf16 goes to disk as its uint16 bits."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    if t.dtype not in _NP_OF_TORCH:
        raise TypeError(f"cannot store dtype {t.dtype}")
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """Stored array -> tensor on ``device`` (bf16 from its uint16 bits); a
    0-d array stays 0-d (``ascontiguousarray`` alone would make it 1-d)."""
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
        if str(arr.dtype) != dtype:
            raise ValueError(f"stored dtype {arr.dtype} != manifest {dtype}")
    return t.to(device)


def _children(node: Any) -> Optional[list]:
    """(key, child) pairs of a container node in the reference's pytree
    order, or None for a leaf (tensor or QTensor)."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, SegmentedParams):
        return [("0", node.segments)]
    if isinstance(node, Segment):
        return [("0", node.params)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree: Any, prefix: str = "") -> list:
    """[(key, leaf), ...] with the JAX package's ``/``-joined path keys."""
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for k, v in kids:
        out += flatten_with_paths(v, f"{prefix}/{k}" if prefix else k)
    return out


def _rebuild(tree: Any, fn: Callable[[str, Any], Any], prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, key(k)) for k, v in tree.items()}
    if isinstance(tree, SegmentedParams):
        return SegmentedParams(segments=_rebuild(tree.segments, fn, key(0)),
                               num_layers=tree.num_layers)
    if isinstance(tree, Segment):
        return Segment(precision=tree.precision, start=tree.start,
                       stop=tree.stop, params=_rebuild(tree.params, fn,
                                                       key(0)))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, fn, key(k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, key(i)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def _logical(tree: Any) -> Any:
    """``tree`` with each ``MeshTree`` (at the top, or an entry of a top
    tuple or list) gathered to its logical arrays on the host."""
    from repro_torch.sharding.specs import MeshTree, gather_tree
    if isinstance(tree, MeshTree):
        return gather_tree(tree, "cpu")
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_logical(x) for x in tree)
    return tree


def save(directory: str, step: int, tree: Any, *, extra: Optional[dict] = None,
         keep: int = 3, process_index: int = 0) -> str:
    """Atomically save ``tree`` (tensors and QTensors) at ``step``; a
    placed tree as its logical arrays."""
    tree = _logical(tree)
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=directory,
                                        prefix=f".tmp_step_{step:08d}_"))
    try:
        arrays = {}
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for key, leaf in flatten_with_paths(tree):
            if isinstance(leaf, QTensor):
                data, _ = _to_storable(leaf.data)
                scale, scale_dtype = _to_storable(leaf.scale)
                arrays[f"{key}.__qdata"] = data
                arrays[f"{key}.__qscale"] = scale
                manifest["leaves"][key] = {
                    "kind": "qtensor", "precision": leaf.precision,
                    "shape": list(leaf.shape), "group": leaf.group,
                    "scale_dtype": scale_dtype,
                    "crc32": [_crc(data), _crc(scale)]}
            else:
                arr, dtype = _to_storable(leaf)
                arrays[key] = arr
                manifest["leaves"][key] = {
                    "kind": "array", "shape": list(arr.shape),
                    "dtype": dtype, "crc32": [_crc(arr)]}
        np.savez(tmp / f"shard_{process_index}.npz", **arrays)
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
        (tmp / ".complete").touch()
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _retain(directory, keep)
    return str(final)


def _retain(directory: pathlib.Path, keep: int):
    steps = sorted(p for p in directory.glob("step_*") if
                   (p / ".complete").exists())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = sorted(p for p in d.glob("step_*") if (p / ".complete").exists())
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def _load_shards(d: pathlib.Path) -> dict:
    """Read every shard file, with a bounded retry for transient I/O
    faults (flaky network filesystems). Two chaos sites
    (``serving/chaos.py``) let a test inject a transient read failure
    (``artifact.read``, retried) and a one-byte flip of the first loaded
    payload (``artifact.corrupt``), which the per-leaf crc32 must catch."""
    from repro_torch.serving import chaos

    def read():
        chaos.fire("artifact.read")
        data = {}
        for shard_file in sorted(d.glob("shard_*.npz")):
            with np.load(shard_file) as z:
                for k in z.files:
                    data[k] = z[k]
        return data

    data = retry(read, attempts=3, base_delay=0.05,
                 retriable=(OSError, chaos.TransientFault))
    if data and chaos.deny("artifact.corrupt"):
        key = sorted(data)[0]
        arr = np.array(data[key])
        if arr.nbytes:
            arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
            data[key] = arr
    return data


def restore(directory: str, tree_like: Any, *, step: Optional[int] = None,
            device=None, mesh=None, specs=None) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` (shapes and leaf kinds
    are read from it; meta tensors will do), each leaf onto ``device``.
    With ``mesh`` and ``specs`` (a P tree over ``tree_like``) each leaf's
    shards go from the file's host arrays straight to their positions
    (``sharding.specs.shard_tree``), so no device receives more of a leaf
    than its shard, and the tree comes back as a ``MeshTree``. Returns
    (tree, the checkpoint's ``extra``)."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    d = directory / f"step_{step:08d}"
    if not (d / ".complete").exists():
        raise FileNotFoundError(f"checkpoint {d} incomplete")
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    data = _load_shards(d)
    if mesh is not None:
        device = "cpu"                  # host views of the file's arrays
    device = torch.device("cpu") if device is None else torch.device(device)

    def leaf(key, like):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        want_kind = "qtensor" if isinstance(like, QTensor) else "array"
        if meta["kind"] != want_kind:
            raise ValueError(
                f"{key}: checkpoint holds a {meta['kind']}, target expects "
                f"a {want_kind}: quantization group/plan mismatch between "
                f"the artifact manifest and the target model?")
        if meta["kind"] == "qtensor":
            qdata = _payload(data, f"{key}.__qdata", key)
            qscale = _payload(data, f"{key}.__qscale", key)
            _check_crc(key, meta, [qdata, qscale])
            if tuple(qdata.shape) != tuple(like.data.shape):
                raise ValueError(f"{key}: checkpoint qtensor data shape "
                                 f"{tuple(qdata.shape)} != expected "
                                 f"{tuple(like.data.shape)}")
            return QTensor(
                data=_from_storable(qdata, str(qdata.dtype), device),
                scale=_from_storable(qscale,
                                     meta.get("scale_dtype", "float32"),
                                     device),
                precision=meta["precision"], shape=tuple(meta["shape"]),
                group=meta["group"])
        stored = _payload(data, key, key)
        _check_crc(key, meta, [stored])
        if tuple(stored.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(stored.shape)}"
                             f" != expected {tuple(like.shape)}")
        return _from_storable(stored, meta["dtype"], device)

    tree = _rebuild(tree_like, leaf)
    if mesh is not None:
        from repro_torch.sharding.specs import shard_tree
        tree = shard_tree(tree, specs, mesh)
    return tree, manifest["extra"]


# ---------------------------------------------------------------------------
# Compiled-plan artifacts (quant/compiler.py)
#
# An artifact is a step_0 checkpoint of the compiled parameter tree plus a
# top-level ``plan_manifest.json`` holding what rebuilds the tree's
# skeleton without raw weights: family, config name, the QuantPlan, group
# size and the per-stack segment layout.
# ---------------------------------------------------------------------------

_ARTIFACT_MANIFEST = "plan_manifest.json"


def save_artifact(directory: str, tree: Any, manifest: dict) -> str:
    """Persist a compiled quantized-param tree and its plan manifest."""
    path = save(directory, 0, tree, extra={"plan_manifest": manifest},
                keep=1)
    tmp = pathlib.Path(directory) / (_ARTIFACT_MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, pathlib.Path(directory) / _ARTIFACT_MANIFEST)
    return path


def is_artifact(directory: str) -> bool:
    d = pathlib.Path(directory)
    return (d / _ARTIFACT_MANIFEST).exists() and latest_step(d) is not None


def load_artifact_manifest(directory: str) -> dict:
    path = pathlib.Path(directory) / _ARTIFACT_MANIFEST
    if not path.exists():
        raise FileNotFoundError(f"no {_ARTIFACT_MANIFEST} in {directory}")
    with open(path) as f:
        return json.load(f)


def restore_artifact(directory: str, tree_like: Any, *, device=None,
                     mesh=None, specs=None) -> Any:
    """Restore the compiled tree into a (segmented, quantized) skeleton,
    every leaf onto ``device``, or (``mesh``, ``specs``) each shard onto
    its position."""
    tree, _ = restore(directory, tree_like, device=device, mesh=mesh,
                      specs=specs)
    return tree
