"""The collectives of mesh serving, over the positions of one model-axis
group (tensor parallelism in one process).

* ``reduce_sum``: the sum of the row-parallel layers' partial outputs, in
  position order and in f32, cast back to the partials' dtype;
* ``gather``: the vocab-sharded logits (or any dim) concatenated in
  position order;
* ``broadcast``: a tensor handed back to every position.

Positions on the tensor's own device read the tensor itself; a position on
another card gets a peer copy (``torch.cuda.comm.broadcast`` between
cards). A partial on another card is copied to the destination before the
sum, so the order of the additions, and with it every bit of the result,
is the same wherever the positions sit. On one card the collectives are
plain sums and concatenations, one code path either way.
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
            and x.device.type == "cuda":
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
    sums the partial outputs (``models/transformer.py``)."""

    def __init__(self, shards: Sequence, devices: Sequence):
        self.shards = list(shards)
        self.devices = [torch.device(d) for d in devices]


class TPCache:
    """The caches of one model-axis group: ``parts[m]`` holds position m's
    KV heads (a family cache of the position's own shapes)."""

    def __init__(self, parts: Sequence):
        self.parts = list(parts)

    def map(self, fn) -> "TPCache":
        return TPCache([fn(p) for p in self.parts])
