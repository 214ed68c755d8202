"""Loss and train/eval step factories.

The gradients come from autograd over the raw-weight forward (every matmul
a plain product, as the reference leaves them to XLA; no hand-written
kernel has a backward). A train step detaches each param leaf into a
leaf that requires grad, so the caller's tensors carry no graph, and
AdamW then writes the new values into them in place.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.optim.adamw import AdamW, clip_scale, global_norm
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


def _split(batch: dict, n: int) -> list:
    """n microbatches along the leading axis."""
    parts = {k: torch.chunk(v, n, dim=0) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_train_step(model, opt: AdamW, run: RunConfig) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation over microbatches (``run.microbatch``): the
    batch's leading axis is split, the first microbatch's grads go to f32
    and the others add to them, and loss, metrics and grads are averaged,
    as the reference's scan does. The grads are clipped to
    ``run.grad_clip`` by their global norm, the clip fused into AdamW's
    walk over the leaves; params and optimizer state are updated in place.
    """
    grad_fn = make_grad_fn(make_loss_fn(model, remat=run.remat))

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
            g = tree_map(lambda x: x.float(), g)
            for part in micro[1:]:
                (li, mi), gi = grad_fn(params, part)
                for acc, x in zip(tree_leaves(g), tree_leaves(gi)):
                    acc.add_(x)
                m = {k: m[k] + mi[k] for k in m}
                l = l + li
        inv = 1.0 / n_micro
        return ((l * inv, {k: v * inv for k, v in m.items()}),
                tree_map(lambda x: x * inv, g))

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
