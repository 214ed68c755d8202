"""Apply a QuantPlan to model parameters.

``apply_plan_stacked`` takes leaves stacked over a leading layer axis (the
layout the model runs) and cuts the stack into maximal contiguous
*segments* of equal precision; each segment keeps its stacked layout,
quantized at its precision, and the model runs the segments in order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core.policy import QuantPlan
from repro_torch.quant.qtypes import QTensor
from repro_torch.quant.quantize import quantize
from repro_torch.tree import tree_leaves, tree_map


def _quantizable(x: Any, group: int, min_ndim: int) -> bool:
    return (isinstance(x, torch.Tensor) and x.ndim >= min_ndim
            and x.shape[-1] % group == 0 and x.shape[-1] % 2 == 0)


def quantize_tree(tree: Any, precision: str, group: int = 128,
                  min_ndim: int = 2) -> Any:
    """Quantize every eligible leaf; ineligible leaves pass through.
    ``min_ndim=3`` for layer-stacked trees, where per-layer vectors (norm
    scales) appear as 2-D (L, D) leaves and stay raw."""
    if precision == "raw":
        return tree
    return tree_map(lambda x: quantize(x, precision, group)
                    if _quantizable(x, group, min_ndim) else x, tree)


@dataclasses.dataclass
class Segment:
    precision: str
    start: int          # first layer index (inclusive)
    stop: int           # last layer index (exclusive)
    params: Any         # stacked over [start, stop), quantized unless raw


@dataclasses.dataclass
class SegmentedParams:
    segments: list[Segment]
    num_layers: int

    def nbytes_effective(self) -> float:
        return sum(tree_nbytes(seg.params) for seg in self.segments)


def plan_segments(plan: QuantPlan,
                  cuts: Sequence[int] = ()) -> list[tuple[str, int, int]]:
    """Maximal runs of equal precision over block order, additionally cut
    at the layer indices in ``cuts``."""
    precisions = plan.precisions()
    cutset = set(cuts)
    runs: list[tuple[str, int, int]] = []
    start = 0
    for i in range(1, len(precisions) + 1):
        if (i == len(precisions) or precisions[i] != precisions[start]
                or i in cutset):
            runs.append((precisions[start], start, i))
            start = i
    return runs


def apply_plan_stacked(stacked: Any, plan: QuantPlan, group: int = 128,
                       cuts: Sequence[int] = ()) -> SegmentedParams:
    """``stacked`` leaves have a leading layer axis of length len(plan)."""
    segs = []
    for precision, start, stop in plan_segments(plan, cuts):
        sliced = tree_map(lambda x: x[start:stop], stacked)
        segs.append(Segment(precision=precision, start=start, stop=stop,
                            params=quantize_tree(sliced, precision, group,
                                                 min_ndim=3)))
    return SegmentedParams(segments=segs, num_layers=len(plan.decisions))


def segment_slices(layers: Any) -> list[tuple[Any, int, int]]:
    """``[(stacked_params, start, stop), ...]``: one entry per segment of a
    ``SegmentedParams``, or one full-range entry for a plain stack."""
    if isinstance(layers, SegmentedParams):
        return [(s.params, s.start, s.stop) for s in layers.segments]
    n = tree_leaves(layers)[0].shape[0]
    return [(layers, 0, n)]


def tree_nbytes(tree: Any) -> float:
    """Effective byte count of a tree that may contain QTensors."""
    total = 0.0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes_effective()
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
