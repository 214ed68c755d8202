"""Deterministic synthetic LM data.

Sequences come from a counter-based hash of (step, shard, position), so
any worker can make its shard without coordination, and a restart resumes
the same stream. A light Markov structure (four successors a token) gives
a model something to learn, so perplexity falls under training and
quantization deltas are measurable. The hash stream is numpy, the JAX
package's arithmetic op for op: the same tokens bit for bit. Batches come
back as torch tensors on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _hash(x: np.ndarray) -> np.ndarray:
    x = (x ^ 61) ^ (x >> 16)
    x = (x + (x << 3)) & 0xFFFFFFFF
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & 0xFFFFFFFF
    return x ^ (x >> 15)


def synthetic_tokens(*, batch: int, seq: int, vocab: int, step: int,
                     seed: int = 0, shard: int = 0,
                     num_shards: int = 1) -> np.ndarray:
    """(batch // num_shards, seq + 1) int32 tokens (inputs and the labels
    shifted by one): token_{t+1} = (hash(token_t * 31 + seed) + a 2-bit
    hash of the position) % vocab."""
    assert batch % num_shards == 0
    local = batch // num_shards
    rows = np.arange(local, dtype=np.uint64) + shard * local \
        + np.uint64(step) * np.uint64(batch)
    base = _hash((rows * 2654435761 + seed) & 0xFFFFFFFF)
    toks = np.empty((local, seq + 1), np.int64)
    toks[:, 0] = base % vocab
    state = base.copy()
    branch_bits = 2  # 4 possible successors per token -> learnable
    for t in range(1, seq + 1):
        state = _hash((state + t) & 0xFFFFFFFF)
        succ = _hash((toks[:, t - 1].astype(np.uint64) * 31 + seed)
                     & 0xFFFFFFFF)
        toks[:, t] = (succ + (state & ((1 << branch_bits) - 1))) % vocab
    return toks.astype(np.int32)


def synthetic_batch(cfg, *, batch: int, seq: int, step: int, seed: int = 0,
                    shard: int = 0, num_shards: int = 1,
                    device=None) -> dict:
    """{"tokens", "labels"} (B, seq) int32 on ``device`` (None: the GPU);
    an enc-dec config also gets "frames", (B, encoder_seq, d_model)
    standard normal f32 from ``default_rng(seed * 1_000_003 + step)``
    rounded to bf16."""
    device = resolve_device(device)
    toks = synthetic_tokens(batch=batch, seq=seq, vocab=cfg.vocab_size,
                            step=step, seed=seed, shard=shard,
                            num_shards=num_shards)
    t = torch.from_numpy(toks)
    out = {"tokens": t[:, :-1].contiguous().to(device),
           "labels": t[:, 1:].contiguous().to(device)}
    if cfg.family == "encdec":
        rng = np.random.default_rng(seed * 1_000_003 + step)
        local = batch // num_shards
        frames = rng.standard_normal((local, cfg.encoder_seq, cfg.d_model),
                                     np.float32)
        out["frames"] = torch.from_numpy(frames).to(device).to(
            torch.bfloat16)
    return out


class DataLoader:
    """Shard-aware stepwise loader over the deterministic stream."""

    def __init__(self, cfg, *, global_batch: int, seq: int, seed: int = 0,
                 shard: int = 0, num_shards: int = 1, start_step: int = 0,
                 device=None):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq = seq
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.step = start_step
        self.device = resolve_device(device)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = synthetic_batch(self.cfg, batch=self.global_batch, seq=self.seq,
                            step=self.step, seed=self.seed, shard=self.shard,
                            num_shards=self.num_shards, device=self.device)
        self.step += 1
        return b

    def state(self) -> dict:
        """Checkpointable position: a restart resumes the exact stream."""
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict):
        self.step = int(state["step"])
        self.seed = int(state["seed"])
