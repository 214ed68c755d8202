"""Int8 error-feedback gradient compression for the data-parallel mean (the
JAX package's ``optim/compress.py``).

Each data position quantizes its gradient plus its error-feedback buffer
group-wise to int8 against a scale every position shares (the max over the
positions of each group's absmax, the reference's ``pmax``), the int8
payloads are summed in int32 in position order (its ``psum``), the sum is
decoded to the mean, and each position keeps what its own payload failed to
carry as its next error (Seide et al.-style EF-SGD applied to the mean).

The reference runs it inside ``shard_map`` over the data axes, one replica
per device; the port is single-controller (``launch/mesh.py``), so one call
takes every data position's tree, in position order, and returns each
position's mean (all equal) and its new error. A position's tensors live on
its own device; the shared scale and the sum are formed on the first
position's device and handed back.

Plain PyTorch, as the reference computes it in XLA with no Pallas kernel.
The reference never calls it from its train step, and neither does the
port: ``RunConfig.grad_compression`` is stored and unread in both.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.tree import tree_leaves, tree_map


def _groups(x: torch.Tensor, group: int) -> torch.Tensor:
    """``x`` flattened, zero-padded to a multiple of ``group``, as
    (groups, group)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % group
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, group)


def _ungroup(gr: torch.Tensor, n: int, shape) -> torch.Tensor:
    return gr.reshape(-1)[:n].reshape(shape)


def _leaf(gs: list, es: list, group: int):
    """One leaf over the positions: (means, new errors), one each."""
    n_pos = len(gs)
    home = gs[0].device
    corrected = [g.float() + e for g, e in zip(gs, es)]
    n = corrected[0].numel()
    grs = [_groups(c, group) for c in corrected]
    # phase 1: one scale per group shared by every position (pmax)
    absmax = torch.amax(grs[0].abs(), dim=-1)
    for gr in grs[1:]:
        absmax = torch.maximum(absmax, torch.amax(gr.abs(), dim=-1).to(home))
    scale = absmax / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    # phase 2: quantize against it; the int payloads summed in int32
    qs, q_sum = [], None
    for gr in grs:
        s = safe.to(gr.device)
        q = torch.clamp(torch.round(gr / s[:, None]), -127, 127)
        qs.append(q)
        qi = q.to(torch.int32).to(home)
        q_sum = qi if q_sum is None else q_sum + qi
    decoded = _ungroup(q_sum.float() * scale[:, None] / n_pos, n,
                       gs[0].shape).to(gs[0].dtype)
    means, errors = [], []
    for g, c, q in zip(gs, corrected, qs):
        # error feedback: what this position's payload failed to carry
        local = _ungroup(q * scale.to(q.device)[:, None], n, g.shape)
        errors.append(c - local)
        means.append(decoded.to(g.device))
    return means, errors


def compressed_psum_mean(grads_by_pos: Sequence, errors_by_pos: Sequence,
                         group: int = 256) -> tuple[list, list]:
    """The int8 error-feedback mean of the data positions' gradient trees.

    ``grads_by_pos[i]`` and ``errors_by_pos[i]`` are position i's gradient
    tree and its f32 error tree (``init_error``), in position order.
    Returns (means, new errors): two lists with one tree per position, each
    mean in its gradient's dtype. Leaf by leaf, as the reference:
    corrected = g + e; scale = max over positions of each group's absmax
    / 127; q = clip(round(corrected / scale), -127, 127); mean = (sum of q
    in int32) * scale / n; new error = corrected - q * scale."""
    if len(grads_by_pos) != len(errors_by_pos) or not grads_by_pos:
        raise ValueError(f"{len(grads_by_pos)} gradient trees for "
                         f"{len(errors_by_pos)} error trees")
    per_g = [tree_leaves(g) for g in grads_by_pos]
    per_e = [tree_leaves(e) for e in errors_by_pos]
    means = [[] for _ in grads_by_pos]
    errors = [[] for _ in grads_by_pos]
    for k in range(len(per_g[0])):
        m, e = _leaf([g[k] for g in per_g], [e[k] for e in per_e], group)
        for i in range(len(grads_by_pos)):
            means[i].append(m[i])
            errors[i].append(e[i])

    def rebuild(tree, leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), tree)

    return ([rebuild(t, m) for t, m in zip(grads_by_pos, means)],
            [rebuild(t, e) for t, e in zip(grads_by_pos, errors)])


def init_error(params):
    """f32 zeros shaped as ``params``, on each leaf's device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
