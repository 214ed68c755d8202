"""Loss and train/eval step factories.

The gradients come from autograd over the raw-weight forward (every matmul
a plain product, as the reference leaves them to XLA; no hand-written
kernel has a backward). A train step detaches each param leaf into a
leaf that requires grad, so the caller's tensors carry no graph, and
AdamW then writes the new values into them in place.

Over a mesh (``make_train_step(..., mesh=)``; the dense family) the params
and optimizer state are placed by the reference's training rules (FSDP
over the data axes, TP over "model": ``sharding/specs.py``) and one
process drives every position, as the reference is single-controller. The
batch is split over the data rows by ``batch_specs``; each row runs the
TP forward of its model positions, whose weights are gathered over the
data rows layer by layer (``unshard_fsdp``); the loss is the mean of the
rows' losses in position order (the global-batch mean: the rows are
equal). One ``torch.autograd.grad`` puts each gradient on its position's
slice: the gathers' backward sums a slice's gradient over the rows, a
leaf that positions share is one tensor, and copies of a replicated leaf
on several cards are summed in position order.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.optim.adamw import AdamW, clip_scale, global_norm
from repro_torch.sharding import collective as C
from repro_torch.sharding.specs import (MeshTree, batch_specs,
                                        distinct_leaves, fsdp_view,
                                        map_placed, placed_slices,
                                        position_grid)
from repro_torch.tree import tree_leaves, tree_map

MOE_AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean token cross-entropy. logits (B, S, V_pad) f32; labels (B, S).
    Padded-vocab logits are masked to -1e30 so they never receive mass;
    the gold logit is a select-and-sum over the vocab, as the reference
    takes it."""
    v_pad = logits.shape[-1]
    iota = torch.arange(v_pad, device=logits.device)
    if v_pad != vocab_size:
        logits = torch.where((iota < vocab_size)[None, None, :], logits,
                             torch.full((), -1e30, device=logits.device))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.sum(torch.where(iota[None, None, :] == labels[..., None],
                                 logits, torch.zeros((), device=logits.device)),
                     dim=-1)
    return torch.mean(logz - gold)


def make_loss_fn(model, *, remat: bool = True) -> Callable:
    """loss_fn(params, batch) -> (total, metrics): the cross-entropy plus
    ``MOE_AUX_WEIGHT`` times an MoE model's load-balancing loss."""
    def loss_fn(params, batch):
        logits, aux = model.apply(params, batch["tokens"],
                                  frames=batch.get("frames"), remat=remat,
                                  with_aux=True)
        loss = cross_entropy(logits.float(), batch["labels"],
                             model.cfg.vocab_size)
        total = loss
        if "moe_aux_loss" in aux:
            total = total + MOE_AUX_WEIGHT * aux["moe_aux_loss"]
        return total, {"loss": loss, **aux}

    return loss_fn


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_grad_fn(loss_fn: Callable) -> Callable:
    """grad_fn(params, batch) -> ((total, metrics), grads), the grads a
    tree shaped as params (a leaf the loss does not reach gets zeros)."""
    def grad_fn(params, batch):
        flat = tree_leaves(params)
        req = [p.detach().requires_grad_(True) for p in flat]
        it = iter(req)
        with torch.enable_grad():
            total, metrics = loss_fn(tree_map(lambda _: next(it), params),
                                     batch)
            grads = torch.autograd.grad(total, req, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for g, p in zip(grads, flat)])
        return ((total.detach(), _detached(metrics)),
                tree_map(lambda _: next(it), params))

    return grad_fn


def _sum_copies(grads: MeshTree) -> MeshTree:
    """Each replicated slice's gradient summed over its copies on other
    devices, in position order, and handed back to each (the positions of
    one device share one tensor, whose gradient autograd already summed)."""
    summed: dict = {}
    for entries in placed_slices(grads):
        copies: dict = {}
        for _, b, x in entries:
            copies.setdefault(b, {})[id(x)] = x
        for same in copies.values():
            if len(same) > 1:
                xs = list(same.values())
                total = C.reduce_sum(xs, xs[0].device)
                for x in xs:
                    summed[id(x)] = total.to(x.device)
    return (map_placed(lambda x: summed.get(id(x), x), grads) if summed
            else grads)


def make_mesh_grad_fn(model, loss_fn: Callable, mesh) -> Callable:
    """grad_fn(params, batch) -> ((total, metrics), grads) over ``mesh``:
    ``params`` a ``MeshTree`` placed by ``param_specs``, ``batch`` the
    global batch; the grads a ``MeshTree`` of the params' placement. The
    total and each metric are the mean of the data rows' in position
    order. The dense family only: TP of the others is queued (ROADMAP.md
    queue 1 item 10)."""
    if model.cfg.family != "dense":
        raise NotImplementedError(
            f"mesh training of the {model.cfg.family} family (ROADMAP.md "
            f"queue 1 item 10); the dense family trains over a mesh")
    grid = position_grid(mesh)
    n_rows, n_cols = grid.shape
    home = mesh.devices[grid[0, 0]]

    def row_batch(batch: dict, specs: dict, r: int, device) -> dict:
        return {k: (v.chunk(n_rows, 0)[r] if specs[k][0] is not None
                    else v).to(device) for k, v in batch.items()}

    def grad_fn(params: MeshTree, batch: dict):
        if params.mesh is not mesh:
            raise ValueError("params placed on another mesh than the step's")
        req = map_placed(lambda p: p.detach().requires_grad_(True), params)
        flat = distinct_leaves(req)
        specs = batch_specs(batch, mesh)
        totals, metrics = [], []
        with torch.enable_grad():
            for r in range(n_rows):
                devs = [mesh.devices[grid[r, m]] for m in range(n_cols)]
                group = C.TPGroup([fsdp_view(req, r, m)
                                   for m in range(n_cols)], devs)
                t, mt = loss_fn(group, row_batch(batch, specs, r, devs[0]))
                totals.append(t)
                metrics.append(mt)
            total = C.reduce_sum(totals, home) / n_rows
            grads = torch.autograd.grad(total, flat, allow_unused=True)
        got = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, grads)}
        mean = {k: C.reduce_sum([m[k].detach() for m in metrics], home)
                / n_rows for k in metrics[0]}
        return ((total.detach(), mean),
                _sum_copies(map_placed(lambda p: got[id(p)], req)))

    return grad_fn


def _split(batch: dict, n: int) -> list:
    """n microbatches along the leading axis."""
    parts = {k: torch.chunk(v, n, dim=0) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_train_step(model, opt: AdamW, run: RunConfig,
                    mesh=None) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation over microbatches (``run.microbatch``): the
    batch's leading axis is split, the first microbatch's grads go to f32
    and the others add to them, and loss, metrics and grads are averaged,
    as the reference's scan does. The grads are clipped to
    ``run.grad_clip`` by their global norm, the clip fused into AdamW's
    walk over the leaves; params and optimizer state are updated in place.
    With ``mesh`` the params and state are ``MeshTree``s (``param_specs``
    and ``opt_state_specs``; ``train(mesh=)`` places them) and so are the
    grads; the global norm counts each logical element once, so the clip
    is the mesh-less one. ``run.grad_compression`` is not read: the
    reference's train step never calls ``compressed_psum_mean`` either.
    """
    loss_fn = make_loss_fn(model, remat=run.remat)
    if mesh is None:
        grad_fn = make_grad_fn(loss_fn)
        tmap, leaves = tree_map, tree_leaves
    else:
        grad_fn = make_mesh_grad_fn(model, loss_fn, mesh)
        tmap, leaves = map_placed, distinct_leaves

    def compute_grads(params, batch):
        if run.microbatch is None:
            return grad_fn(params, batch)
        b = batch["tokens"].shape[0]
        mb = run.microbatch
        assert b % mb == 0
        n_micro = b // mb
        micro = _split(batch, n_micro)
        (l, m), g = grad_fn(params, micro[0])
        if n_micro > 1:
            g = tmap(lambda x: x.float(), g)
            for part in micro[1:]:
                (li, mi), gi = grad_fn(params, part)
                for acc, x in zip(leaves(g), leaves(gi)):
                    acc.add_(x)
                m = {k: m[k] + mi[k] for k in m}
                l = l + li
        inv = 1.0 / n_micro
        return ((l * inv, {k: v * inv for k, v in m.items()}),
                tmap(lambda x: x * inv, g))

    def train_step(params, opt_state, batch):
        (_, metrics), grads = compute_grads(params, batch)
        gnorm = global_norm(grads)
        params, opt_state = opt.update(grads, opt_state, params,
                                       grad_scale=clip_scale(gnorm,
                                                             run.grad_clip))
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    train_step.compute_grads = compute_grads   # ((loss, metrics), grads)
    return train_step


def make_eval_step(model) -> Callable:
    loss_fn = make_loss_fn(model, remat=False)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
