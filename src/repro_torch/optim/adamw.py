"""AdamW with a moment dtype of f32, bf16 or int8.

The int8 option stores each moment as group-wise absmax int8 (groups of
128 along the last axis, the quantizer of the EWQ weights,
``quant/quantize.quantize_int8``), dequantized on read and requantized on
write; a leaf whose last axis is not a multiple of 128 keeps f32 moments.
That is the JAX package's 8-bit Adam, and its arithmetic op for op.

``update`` writes the new params and moments into the tensors it is given
(the reference's train step donates them) and walks each leaf in slices of
its rows: the f32 temporaries (the gradient, both moments decoded, the
step) live one slice at a time, never a whole leaf or tree. The update is
elementwise and the int8 groups run along the last axis, so a slice's
results are the whole leaf's, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.quant.qtypes import QTensor
from repro_torch.quant.quantize import dequantize, quantize_int8
from repro_torch.tree import tree_leaves, tree_map

MOMENT_GROUP = 128
# elements of a leaf one slice of the update holds in f32 (256 MB a temp)
SLICE_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    count: torch.Tensor     # 0-d int32: steps taken
    m: Any                  # first moments, the params' tree
    v: Any                  # second moments


def _quantized(shape, dtype: str) -> bool:
    return (dtype == "int8" and len(shape) >= 1
            and shape[-1] % MOMENT_GROUP == 0)


def _zero_moment(p: torch.Tensor, dtype: str):
    """The encoding of a zero moment for ``p``; an int8 one is built
    directly (zero levels and scales: ``quantize_int8`` of zeros, without
    an f32 copy of the leaf)."""
    if dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(dtype)
    if _quantized(p.shape, dtype):
        k = p.shape[-1]
        return QTensor(
            data=torch.zeros(p.shape, dtype=torch.int8, device=p.device),
            scale=torch.zeros(tuple(p.shape[:-1]) + (k // MOMENT_GROUP,),
                              dtype=torch.bfloat16, device=p.device),
            precision="int8", shape=tuple(p.shape), group=MOMENT_GROUP)
    return torch.zeros(p.shape, dtype=(torch.bfloat16 if dtype == "bfloat16"
                                       else torch.float32), device=p.device)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A (rows, last axis) view of a contiguous leaf."""
    if not t.is_contiguous():
        raise ValueError("AdamW updates contiguous tensors in place")
    return t.view(1, 1) if t.ndim == 0 else t.view(-1, t.shape[-1])


class _Moment:
    """Row-slice reads and writes of one stored moment (a tensor or an int8
    QTensor)."""

    def __init__(self, enc):
        self.q = isinstance(enc, QTensor)
        if self.q:
            self.data, self.scale = _rows(enc.data), _rows(enc.scale)
        else:
            self.t = _rows(enc)

    def read(self, lo: int, hi: int) -> torch.Tensor:
        if not self.q:
            return self.t[lo:hi].float()
        k = self.data.shape[1]
        part = QTensor(data=self.data[lo:hi], scale=self.scale[lo:hi],
                       precision="int8", shape=(hi - lo, k),
                       group=MOMENT_GROUP)
        return dequantize(part, torch.float32)

    def write(self, lo: int, hi: int, x: torch.Tensor) -> None:
        if not self.q:
            self.t[lo:hi].copy_(x)
            return
        q = quantize_int8(x, group=MOMENT_GROUP)
        self.data[lo:hi].copy_(q.data)
        self.scale[lo:hi].copy_(q.scale)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Any            # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        first = tree_leaves(params)[0]
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            m=tree_map(lambda p: _zero_moment(p, self.moment_dtype), params),
            v=tree_map(lambda p: _zero_moment(p, self.moment_dtype), params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params,
               grad_scale: Optional[torch.Tensor] = None):
        """One step, in place. ``grad_scale`` (0-d f32) multiplies each
        gradient first, rounded back to its dtype: ``clip_by_global_norm``
        fused into the walk. Returns (params, AdamWState)."""
        count = state.count + 1
        lr = (self.learning_rate(count)
              if callable(self.learning_rate) else self.learning_rate)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** count.to(torch.float32)
        c2 = 1.0 - b2 ** count.to(torch.float32)
        flat_g = tree_leaves(grads)
        flat_m, flat_v = tree_leaves(state.m), tree_leaves(state.v)
        flat_p = tree_leaves(params)
        for g, m_enc, v_enc, p in zip(flat_g, flat_m, flat_v, flat_p):
            g2 = g.reshape(1, 1) if g.ndim == 0 else g.reshape(-1,
                                                               g.shape[-1])
            p2 = _rows(p)
            mm, vm = _Moment(m_enc), _Moment(v_enc)
            step = max(1, SLICE_ELEMS // max(p2.shape[1], 1))
            for lo in range(0, p2.shape[0], step):
                hi = min(lo + step, p2.shape[0])
                gs = g2[lo:hi]
                if grad_scale is not None:
                    gs = (gs.float() * grad_scale).to(gs.dtype)
                gs = gs.float()
                m = b1 * mm.read(lo, hi) + (1 - b1) * gs
                v = b2 * vm.read(lo, hi) + (1 - b2) * gs * gs
                upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
                pf = p2[lo:hi].float()
                if p.ndim >= 2:  # decoupled weight decay on matrices only
                    upd = upd + self.weight_decay * pf
                p2[lo:hi].copy_((pf - lr * upd).to(p.dtype))
                mm.write(lo, hi, m)
                vm.write(lo, hi, v)
        return params, AdamWState(count=count, m=state.m, v=state.v)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (a
    leaf summed slice by slice)."""
    sums = []
    for x in tree_leaves(tree):
        rows = x.reshape(1, -1) if x.ndim == 0 else x.reshape(-1, x.shape[-1])
        step = max(1, SLICE_ELEMS // max(rows.shape[1], 1))
        total = None
        for lo in range(0, rows.shape[0], step):
            part = torch.sum(torch.square(rows[lo:lo + step].float()))
            total = part if total is None else total + part
        sums.append(total)
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)) in f32."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
