"""Device meshes of the port (the JAX package's ``launch/mesh.py``).

A ``Mesh`` names its axes and lays one ``torch.device`` at each position,
as ``jax.sharding.Mesh`` does. The port is single-controller, like the
reference: one process drives every position. A position names a device:
``cuda:i`` on a machine with several cards; a shape with more positions
than cards lays its positions round the cards in order, so on one card
every position is ``cuda:0`` (the counterpart of the reference's virtual
host devices, ``--xla_force_host_platform_device_count``). Each position
holds its own shard of the weights and of the cache all the same.

Meshes are built by functions, never at import: importing this module
touches no device.
"""

from __future__ import annotations

import collections
import itertools
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """``axis_names``, ``shape`` (an ordered dict axis -> size), ``size``
    and ``devices`` (an ndarray of ``torch.device`` over the axes)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of rank {devices.ndim} for axes "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> collections.OrderedDict:
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_set(self) -> list:
        """The distinct devices of the mesh, in position order."""
        out: list = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={self.device_set})"


def _device_list(devices) -> list:
    """``devices`` as torch devices (None: every visible CUDA card)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_mesh found no CUDA device; pass devices=['cpu'] for a "
                "mesh of CPU positions")
        devices = [f"cuda:{i}" for i in range(count)]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def make_mesh(shape, axes, devices=None) -> Mesh:
    """Arbitrary mesh; ``devices`` mirrors ``jax.make_mesh(..., devices=)``
    (default: the visible cards in order)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    devs = _device_list(devices)
    grid = np.empty(int(np.prod(shape)), dtype=object)
    for i in range(grid.size):      # positions laid round the devices
        grid[i] = devs[i % len(devs)]
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 single-pod (256 positions) or 2x16x16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def parse_mesh(axes: str, shape: Optional[str] = None,
               devices=None) -> Mesh:
    """CLI mesh spec -> Mesh (``launch/serve.py`` ``--mesh`` /
    ``--mesh-shape``). ``axes`` is comma-separated axis names
    ("data,model"); ``shape`` is comma-separated sizes ("2,4"). When
    ``shape`` is omitted, every device goes on the LAST axis."""
    axis_names = tuple(a.strip() for a in axes.split(",") if a.strip())
    if not axis_names:
        raise ValueError(f"empty mesh axes spec {axes!r}")
    if shape:
        sizes = tuple(int(s) for s in shape.split(","))
        if len(sizes) != len(axis_names):
            raise ValueError(f"--mesh-shape {shape!r} has {len(sizes)} "
                             f"entries for {len(axis_names)} axes "
                             f"{axis_names}")
    else:
        sizes = ((1,) * (len(axis_names) - 1)
                 + (len(_device_list(devices)),))
    return make_mesh(sizes, axis_names, devices)


def data_axis_names(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def split_data_replicas(mesh: Mesh) -> list:
    """One serving submesh per index along the data axes (the DP x TP
    replica split). A ``(data=R, model=T)`` mesh becomes R submeshes of
    shape ``(data=1, model=T)``: each keeps every axis NAME (so the TP-only
    serving specs resolve unchanged: a size-1 data axis shards nothing) but
    owns a disjoint 1/R slice of the positions. Meshes without a data axis
    (or with data=1) return ``[mesh]``."""
    names = mesh.axis_names
    axes = [names.index(a) for a in data_axis_names(mesh) if a in names]
    sizes = [mesh.devices.shape[a] for a in axes]
    if not axes or int(np.prod(sizes)) == 1:
        return [mesh]
    subs = []
    for idx in itertools.product(*(range(s) for s in sizes)):
        devs = mesh.devices
        for a, i in zip(axes, idx):
            devs = np.take(devs, [i], axis=a)
        subs.append(Mesh(devs, names))
    return subs
