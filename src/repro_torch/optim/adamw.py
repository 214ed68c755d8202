"""AdamW with a moment dtype of f32, bf16 or int8.

The int8 option stores each moment as group-wise absmax int8 (groups of
128 along the last axis, the quantizer of the EWQ weights,
``quant/quantize.quantize_int8``), dequantized on read and requantized on
write; a leaf whose last axis is not a multiple of 128 keeps f32 moments.
That is the JAX package's 8-bit Adam, and its arithmetic op for op.

Over a mesh (``sharding/specs.MeshTree``: a mesh train step's params,
gradients and state, placed by ``param_specs`` and ``opt_state_specs``)
``init`` gives each position zero moments shaped as its slice and
``update`` updates each position's own slice in place, a slice that
several positions share once. An int8 moment's payload follows its
param's slice while its scales stay one replicated array (the reference's
``opt_state_specs``): the slices of one row block (equal bounds but along
the last axis) are updated together with their rows of the scales, so a
quantization group split across positions gets one scale, and every copy
of the scales (one a device) is written. The results are the mesh-less
update's, bit for bit.

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

import numpy as np
import torch

from repro_torch.quant.qtypes import QTensor
from repro_torch.quant.quantize import dequantize, quantize_int8
from repro_torch.sharding.specs import (MeshTree, opt_state_specs,
                                        placed_slices, positions, refill)
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
        """Zero moments and count; over a ``MeshTree`` of params, a
        ``MeshTree`` of each position's ``AdamWState``."""
        if isinstance(params, MeshTree):
            return self._init_placed(params)
        first = tree_leaves(params)[0]
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            m=tree_map(lambda p: _zero_moment(p, self.moment_dtype), params),
            v=tree_map(lambda p: _zero_moment(p, self.moment_dtype), params))

    def _init_placed(self, params: MeshTree) -> MeshTree:
        """Each position's zero moments, shaped as its slices; an int8
        moment's scales (chosen by the logical shape) are one zero array of
        the logical leaf's, shared by the positions of a device."""
        mesh = params.mesh
        scales: dict = {}
        moments = {pos: [] for pos in positions(mesh)}
        for k, entries in enumerate(placed_slices(params)):
            shape = tuple(max(b[i][1] for _, b, _ in entries)
                          for i in range(len(entries[0][1])))
            made: dict = {}
            for pos, _, p in entries:
                if id(p) not in made:
                    if _quantized(shape, self.moment_dtype):
                        key = (k, p.device)
                        if key not in scales:
                            scales[key] = [torch.zeros(
                                shape[:-1] + (shape[-1] // MOMENT_GROUP,),
                                dtype=torch.bfloat16, device=p.device)
                                for _ in range(2)]
                        made[id(p)] = tuple(QTensor(
                            data=torch.zeros(p.shape, dtype=torch.int8,
                                             device=p.device),
                            scale=sc, precision="int8", shape=tuple(p.shape),
                            group=MOMENT_GROUP) for sc in scales[key])
                    else:
                        kind = ("float32" if self.moment_dtype == "int8"
                                else self.moment_dtype)
                        made[id(p)] = (_zero_moment(p, kind),
                                       _zero_moment(p, kind))
                moments[pos].append(made[id(p)])
        counts: dict = {}
        trees = np.empty(mesh.devices.shape, dtype=object)
        for pos in positions(mesh):
            dev = mesh.devices[pos]
            if dev not in counts:
                counts[dev] = torch.zeros((), dtype=torch.int32, device=dev)
            own = params.trees[pos]
            trees[pos] = AdamWState(
                count=counts[dev],
                m=refill(own, params.specs, [mv[0] for mv in moments[pos]]),
                v=refill(own, params.specs, [mv[1] for mv in moments[pos]]))
        first = positions(mesh)[0]
        return MeshTree(mesh=mesh, specs=opt_state_specs(
            trees[first], params.specs, mesh), trees=trees)

    def _constants(self, count: torch.Tensor) -> tuple:
        """(lr, bias corrections 1 and 2) of step ``count``."""
        lr = (self.learning_rate(count)
              if callable(self.learning_rate) else self.learning_rate)
        c1 = 1.0 - self.b1 ** count.to(torch.float32)
        c2 = 1.0 - self.b2 ** count.to(torch.float32)
        return lr, c1, c2

    def _update_leaf(self, g, m_enc, v_enc, p, lr, c1, c2,
                     grad_scale) -> None:
        """One leaf's step in place, slice by slice of its rows."""
        b1, b2 = self.b1, self.b2
        g2 = g.reshape(1, 1) if g.ndim == 0 else g.reshape(-1, g.shape[-1])
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

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params,
               grad_scale: Optional[torch.Tensor] = None):
        """One step, in place. ``grad_scale`` (0-d f32) multiplies each
        gradient first, rounded back to its dtype: ``clip_by_global_norm``
        fused into the walk. Returns (params, AdamWState); over a mesh,
        ``grads``, ``state`` and ``params`` are ``MeshTree``s and so is the
        state returned."""
        if isinstance(params, MeshTree):
            return self._update_placed(grads, state, params, grad_scale)
        count = state.count + 1
        lr, c1, c2 = self._constants(count)
        for g, m_enc, v_enc, p in zip(tree_leaves(grads),
                                      tree_leaves(state.m),
                                      tree_leaves(state.v),
                                      tree_leaves(params)):
            self._update_leaf(g, m_enc, v_enc, p, lr, c1, c2, grad_scale)
        return params, AdamWState(count=count, m=state.m, v=state.v)

    def _update_placed(self, grads: MeshTree, state: MeshTree,
                       params: MeshTree, grad_scale) -> tuple:
        mesh = params.mesh
        order = positions(mesh)
        count = state.at(order[0]).count + 1
        consts: dict = {}

        def on(dev) -> tuple:
            """lr, c1, c2 and the clip scale on ``dev``."""
            if dev not in consts:
                consts[dev] = tuple(
                    x.to(dev) if isinstance(x, torch.Tensor) else x
                    for x in self._constants(count) + (grad_scale,))
            return consts[dev]

        m_of = {pos: tree_leaves(state.at(pos).m) for pos in order}
        v_of = {pos: tree_leaves(state.at(pos).v) for pos in order}
        for k, (ps, gs) in enumerate(zip(placed_slices(params),
                                         placed_slices(grads))):
            done: set = set()
            blocks: dict = {}
            for (pos, b, p), (_, _, g) in zip(ps, gs):
                if id(p) in done:
                    continue
                done.add(id(p))
                m, v = m_of[pos][k], v_of[pos][k]
                if isinstance(m, QTensor):
                    blocks.setdefault(b[:-1], []).append((b[-1], p, g, m, v))
                else:
                    self._update_leaf(g, m, v, p, *on(p.device))
            for lead, block in blocks.items():
                self._update_block(lead, block, on)
        counts: dict = {}
        trees = np.empty(state.trees.shape, dtype=object)
        for pos in order:
            dev = mesh.devices[pos]
            counts.setdefault(dev, count.to(dev))
            trees[pos] = state.at(pos)._replace(count=counts[dev])
        return params, MeshTree(mesh=mesh, specs=state.specs, trees=trees)

    def _update_block(self, lead: tuple, block: list, on) -> None:
        """The int8-moment slices of one row block (``lead``: the bounds of
        every dim but the last) updated as one: the distinct last-axis
        slices concatenated in order with the block's rows of the scales
        (whole groups, even where a group spans two positions), then each
        copy of each slice and of the scales written back."""
        by_last: dict = {}
        for last, *rest in block:
            by_last.setdefault(last, []).append(rest)
        lasts = sorted(by_last)
        firsts = [by_last[k][0] for k in lasts]
        home = firsts[0][0].device

        def joined(i, field=None):
            xs = [f[i] if field is None else getattr(f[i], field)
                  for f in firsts]
            return xs[0] if len(xs) == 1 else torch.cat(
                [x.to(home) for x in xs], dim=-1)

        rows = tuple(slice(lo, hi) for lo, hi in lead)
        p, g = joined(0), joined(1)
        m0, v0 = firsts[0][2], firsts[0][3]
        m_scale = m0.scale[rows].contiguous()
        v_scale = v0.scale[rows].contiguous()

        def moment(i, scale):
            data = joined(i, "data")
            return QTensor(data=data, scale=scale.to(home), precision="int8",
                           shape=tuple(data.shape), group=MOMENT_GROUP)

        m, v = moment(2, m_scale), moment(3, v_scale)
        self._update_leaf(g, m, v, p, *on(home))
        lo0 = lasts[0][0]
        for last in lasts:
            cols = slice(last[0] - lo0, last[1] - lo0)
            for copy in by_last[last]:
                for got, dst in ((p, copy[0]), (m.data, copy[2].data),
                                 (v.data, copy[3].data)):
                    if got is not dst:
                        dst.copy_(got[..., cols])
        scales = {}
        for copies in by_last.values():
            for copy in copies:
                scales[id(copy[2].scale)] = (copy[2].scale, m.scale)
                scales[id(copy[3].scale)] = (copy[3].scale, v.scale)
        for dst, got in scales.values():
            if got is not dst:
                dst[rows].copy_(got)


def _logical_leaves(tree) -> list:
    """A tree's leaves; a ``MeshTree``'s slices, each logical element once
    (one slice of each distinct bounds, however many positions hold it)."""
    if not isinstance(tree, MeshTree):
        return tree_leaves(tree)
    out = []
    for entries in placed_slices(tree):
        seen: set = set()
        for _, b, x in entries:
            if b not in seen:
                seen.add(b)
                out.append(x)
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (a
    leaf summed slice by slice); over a ``MeshTree`` each logical element
    counts once, so the norm is the mesh-less one."""
    leaves = _logical_leaves(tree)
    home = leaves[0].device
    sums = []
    for x in leaves:
        rows = x.reshape(1, -1) if x.ndim == 0 else x.reshape(-1, x.shape[-1])
        step = max(1, SLICE_ELEMS // max(rows.shape[1], 1))
        total = None
        for lo in range(0, rows.shape[0], step):
            part = torch.sum(torch.square(rows[lo:lo + step].float()))
            total = part if total is None else total + part
        sums.append(total.to(home))
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)) in f32."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
