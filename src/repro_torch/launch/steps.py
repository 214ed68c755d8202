"""Step builders shared by the trainer and the serving launchers: the
optimizer a run asks for, a prefill step and a greedy decode step."""

from __future__ import annotations

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import make_schedule


def make_optimizer(run: RunConfig) -> AdamW:
    sched = make_schedule(run.schedule, base_lr=run.learning_rate,
                          warmup_steps=run.warmup_steps,
                          total_steps=max(run.steps, 1))
    return AdamW(learning_rate=sched, weight_decay=run.weight_decay,
                 moment_dtype=run.moment_dtype)


def make_prefill_step(model):
    @torch.no_grad()
    def prefill_step(params, batch):
        # serving prefill: next-token logits only (no (B, S, V) temp)
        logits = model.apply(params, batch["tokens"],
                             frames=batch.get("frames"), last_only=True)
        return logits[:, -1, :]

    return prefill_step


def make_decode_step(model):
    @torch.no_grad()
    def decode_step(params, cache, tokens):
        logits, new_cache = model.decode_step(params, cache, tokens)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, new_cache

    return decode_step
