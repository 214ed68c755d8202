"""The collectives of mesh serving and training, over the positions of one
model-axis group (tensor parallelism in one process) or of one model
position's column of data rows (FSDP).

* ``reduce_sum``: the sum of the row-parallel layers' partial outputs, in
  position order and in f32, cast back to the partials' dtype;
* ``gather``: the vocab-sharded logits, or the data-axis slices of an FSDP
  weight (``FSDPLeaf``), concatenated in position order;
* ``broadcast``: a tensor handed back to every position.

Positions on the tensor's own device read the tensor itself; a position on
another card gets a peer copy (``torch.cuda.comm.broadcast`` between
cards). A partial on another card is copied to the destination before the
sum, so the order of the additions, and with it every bit of the result,
is the same wherever the positions sit. On one card the collectives are
plain sums and concatenations, one code path either way.

All three carry gradients (they are built from ``.to``, ``+`` and ``cat``;
``broadcast`` copies a tensor that requires grad with ``.to``), so a mesh
train step differentiates through them: the backward of an FSDP gather
sums each slice's gradient over the data rows that gathered it, and the
backward of ``broadcast`` sums a replicated activation's over the
positions that read it.
"""

from __future__ import annotations

from typing import Sequence

import torch


def reduce_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """sum(parts) on ``device``, accumulated in f32 in position order."""
    device = torch.device(device)
    acc = parts[0].to(device).float()
    for p in parts[1:]:
        acc = acc + p.to(device).float()
    return acc.to(parts[0].dtype)


def gather(parts: Sequence[torch.Tensor], device, dim: int = -1
           ) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` on ``device``."""
    device = torch.device(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


def broadcast(x: torch.Tensor, devices: Sequence) -> list:
    """``x`` for each position in ``devices``: ``x`` itself on its own
    device, one copy per other device (shared by the positions there)."""
    devices = [torch.device(d) for d in devices]
    others = [d for d in dict.fromkeys(devices) if d != x.device]
    copies = {x.device: x}
    if others and all(d.type == "cuda" for d in others) \
            and x.device.type == "cuda" and not x.requires_grad:
        for d, c in zip(others, torch.cuda.comm.broadcast(x, others)):
            copies[d] = c
    else:
        for d in others:
            copies[d] = x.to(d)
    return [copies[d] for d in devices]


class TPGroup:
    """The parameter shards of one model-axis group: ``shards[m]`` is
    position m's tree, on ``devices[m]``. Model code given a TPGroup in
    place of a parameter tree runs each position's heads and MLP slice and
    sums the partial outputs (``models/transformer.py``). In a mesh train
    step a shard's FSDP-sharded leaves are ``FSDPLeaf``s, gathered layer by
    layer where the model calls ``unshard_fsdp``."""

    def __init__(self, shards: Sequence, devices: Sequence):
        self.shards = list(shards)
        self.devices = [torch.device(d) for d in devices]


class FSDPLeaf:
    """A weight leaf of a training placement as one model position of one
    data row sees it: ``parts``, the data-axis slices of the position's
    shard held by the rows of its model column, in position order; ``dim``,
    the dim they split; ``device``, the row position's device.
    ``unshard_fsdp`` (``sharding/ctx.py``) gathers it to the shard's TP-only
    shape. A leaf whose FSDP dim is the layer axis of a stack holds one
    part per layer once unstacked (``dim`` None: moved, not gathered)."""

    def __init__(self, parts: Sequence[torch.Tensor], dim, device):
        self.parts = list(parts)
        self.dim = dim
        self.device = torch.device(device)

    @property
    def shape(self) -> tuple:
        shape = list(self.parts[0].shape)
        if self.dim is not None:
            shape[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return tuple(shape)

    def unshard(self) -> torch.Tensor:
        if self.dim is None:
            return self.parts[0].to(self.device)
        return gather(self.parts, self.device, dim=self.dim)

    def unstack(self, n: int) -> list:
        """The ``n`` layers of a stacked leaf, each part split once by
        ``torch.unbind`` (as ``tree.tree_unstack``)."""
        split = [torch.unbind(p, 0) for p in self.parts]
        if self.dim == 0:               # the data rows split the layers
            per = self.parts[0].shape[0]
            return [FSDPLeaf([split[i // per][i % per]], None, self.device)
                    for i in range(n)]
        return [FSDPLeaf([s[i] for s in split], self.dim - 1, self.device)
                for i in range(n)]


class TPCache:
    """The caches of one model-axis group: ``parts[m]`` holds position m's
    KV heads (a family cache of the position's own shapes)."""

    def __init__(self, parts: Sequence):
        self.parts = list(parts)

    def map(self, fn) -> "TPCache":
        return TPCache([fn(p) for p in self.parts])
