"""LR schedules: linear warmup + {cosine, WSD (minicpm), linear} decay.

Each takes a step (a Python int or a 0-d tensor, such as AdamW's count)
and returns a 0-d f32 tensor on the step's device, computed in f32 op for
op as the JAX package computes it, so the rates agree to f32 rounding.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1):
    step = _f32(step)
    warm = base_lr * step / max(warmup_steps, 1)
    frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup_steps, warm, base_lr * cos)


def wsd(step, *, base_lr: float, warmup_steps: int, total_steps: int,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM): warmup, a long stable plateau, then a
    decay linear in log over the last ``decay_frac`` of training."""
    step = _f32(step)
    decay_start = total_steps * (1.0 - decay_frac)
    warm = base_lr * step / max(warmup_steps, 1)
    frac = (step - decay_start) / max(total_steps - decay_start, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    # log(final_frac) in f32, as the reference takes it
    log_final = torch.log(torch.tensor(final_frac, dtype=torch.float32,
                                       device=step.device))
    decayed = base_lr * torch.exp(log_final * frac)
    base = torch.full_like(step, base_lr)
    out = torch.where(step < warmup_steps, warm, base)
    return torch.where(step > decay_start, decayed, out)


def warmup_linear(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.0):
    step = _f32(step)
    warm = base_lr * step / max(warmup_steps, 1)
    frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    lin = base_lr * (1 - (1 - final_frac) * frac)
    return torch.where(step < warmup_steps, warm, lin)


SCHEDULES = {"cosine": warmup_cosine, "wsd": wsd, "linear": warmup_linear}


def make_schedule(name: str, *, base_lr: float, warmup_steps: int,
                  total_steps: int):
    fn = SCHEDULES[name]
    return lambda step: fn(step, base_lr=base_lr, warmup_steps=warmup_steps,
                           total_steps=total_steps)
