"""Quantized weight tensor for weight-only quantization.

A QTensor stores:
  data   : int8 tensor. For int8 this is the values; for int4 two nibbles are
           packed per byte along the *last* (contraction-group) axis, low
           nibble = even element; for ternary the values {-1, 0, +1} are
           stored in int8 (size accounting reports the 1.58-bit figure).
  scale  : bf16 per-group scales with shape data_shape[:-1] + (groups,)
  precision: "int8" | "int4" | "ternary"
  shape  : logical (unquantized) shape
  group  : group size along the last axis (contraction dim), default 128.

Shapes used by the kernels are read from ``data``, so a QTensor sliced along
a leading layer axis stays valid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_GROUP = 128


@dataclasses.dataclass
class QTensor:
    data: torch.Tensor
    scale: torch.Tensor
    precision: str
    shape: tuple[int, ...]
    group: int = DEFAULT_GROUP

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def logical_size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def device(self) -> torch.device:
        return self.data.device

    def nbytes_effective(self) -> float:
        """Effective storage bytes (counts ternary at 1.58 bits even though
        the in-memory carrier is int8)."""
        bits = {"int8": 8.0, "int4": 4.0, "ternary": 1.58}[self.precision]
        scale_bytes = float(np.prod(tuple(self.scale.shape))) * 2.0
        return self.logical_size * bits / 8.0 + scale_bytes

    def index(self, i: int) -> "QTensor":
        """Layer ``i`` of a QTensor stacked over a leading layer axis."""
        return QTensor(data=self.data[i], scale=self.scale[i],
                       precision=self.precision, shape=tuple(self.shape[1:]),
                       group=self.group)

