"""Attention-free SSM LM (mamba2-780m): stacked Mamba2 SSD blocks.

Layers run in a Python loop, one segment of a ``SegmentedParams`` after
another. Decode keeps a (conv, state) summary per layer, written in place
(``ssm.ssm_decode_step``); the nominal position is kept for the engine's
bookkeeping. A speculative verify scans single-token decode steps and
snapshots the summaries after each one; ``spec_commit`` copies each slot's
snapshot at its accepted length back into the cache.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import ssm as S
from repro_torch.models.common import (dtype_of, embed_init, embed_lookup,
                                       lm_head, norm, remat_call,
                                       select_snapshot)
from repro_torch.quant.apply import segment_slices
from repro_torch.tree import tree_index, tree_leaves, tree_unstack


class SSMLMCache(NamedTuple):
    conv: torch.Tensor    # (L, B, W-1, conv_dim)
    state: torch.Tensor   # (L, B, H, P, N) f32
    pos: torch.Tensor     # int32 nominal position: scalar, or (B,)


CACHE_BATCH_AXES = SSMLMCache(conv=1, state=1, pos=0)
# attention-free: no KV cache for the engine's KV plan to quantize
KV_CACHE_FIELDS = ()


def init(cfg, gen: torch.Generator, device) -> dict:
    """Random weights at the JAX package's init scales, from ``gen``; the
    head is tied to the embedding."""
    dtype = dtype_of(cfg)
    n, d = cfg.num_layers, cfg.d_model
    embed = embed_init(gen, cfg.padded_vocab, d, dtype, device)
    layers = S.init_ssm_params(gen, cfg, n, dtype, device)
    if not cfg.nonparametric_norm:
        layers["ln"] = torch.ones((n, d), dtype=dtype, device=device)
    return {"embed": {"tok": embed}, "layers": layers,
            "final": {"norm": torch.ones((d,), dtype=dtype, device=device)}}


def _head(params, h, cfg, plain):
    h = norm(h, params["final"]["norm"], cfg)
    return lm_head(h, params["embed"]["tok"], plain)


def apply(params, tokens: torch.Tensor, cfg, *, last_only: bool = False,
          plain: bool = False, remat: bool = False, with_aux: bool = False):
    """tokens (B, S) -> logits (B, S, V_pad) f32 (the chunked SSD path);
    ``remat`` recomputes each layer in the backward pass, ``with_aux``
    returns (logits, {}) (no aux loss in this family)."""
    h = embed_lookup(params["embed"]["tok"], tokens, dtype_of(cfg))

    def layer(p, h):
        return h + S.ssm_block(p, norm(h, p.get("ln"), cfg), cfg, plain)

    for part, lo, hi in segment_slices(params["layers"]):
        for p in tree_unstack(part, hi - lo):
            h = remat_call(layer, p, h, remat=remat)
    if last_only:
        h = h[:, -1:, :]
    logits = _head(params, h, cfg, plain)
    return (logits, {}) if with_aux else logits


def init_cache(cfg, batch: int, max_seq: int, device) -> SSMLMCache:
    """The (conv, state) summaries are O(1) in the sequence: ``max_seq``
    sizes nothing."""
    dtype = dtype_of(cfg)
    one = S.init_ssm_cache(batch, cfg, dtype, device)
    n = cfg.num_layers
    return SSMLMCache(
        conv=one.conv[None].expand(n, *one.conv.shape).contiguous(),
        state=one.state[None].expand(n, *one.state.shape).contiguous(),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(params, cache: SSMLMCache, tokens: torch.Tensor, cfg, *,
                plain: bool = False):
    """tokens (B, 1) -> (logits (B, 1, V_pad), cache). conv and state are
    written in place; the returned cache carries ``pos + 1``."""
    if tokens.shape[1] != 1:
        raise ValueError(f"an SSM decode step takes one token per slot, got "
                         f"{tokens.shape[1]}; scan a window token by token")
    h = embed_lookup(params["embed"]["tok"], tokens[:, 0], dtype_of(cfg))
    for part, lo, hi in segment_slices(params["layers"]):
        for i in range(hi - lo):
            p = tree_index(part, i)
            h = h + S.ssm_decode_step(
                p, norm(h, p.get("ln"), cfg),
                S.SSMCache(conv=cache.conv[lo + i],
                           state=cache.state[lo + i]), cfg, plain)
    return (_head(params, h[:, None, :], cfg, plain),
            cache._replace(pos=cache.pos + 1))


def snapshot_verify(decode, cache, tokens: torch.Tensor):
    """Scan single-token ``decode(cache, tokens (B, 1))`` steps over a
    verify window (B, K+1), snapshotting conv and state before the window
    and after every step (K+2 each). Returns (logits (B, K+1, V_pad),
    conv snapshots, state snapshots)."""
    convs, states, logits = [cache.conv.clone()], [cache.state.clone()], []
    for j in range(tokens.shape[1]):
        lg, cache = decode(cache, tokens[:, j:j + 1])
        logits.append(lg[:, 0])
        convs.append(cache.conv.clone())
        states.append(cache.state.clone())
    return (torch.stack(logits, dim=1), torch.stack(convs),
            torch.stack(states))


def spec_verify(params, cache: SSMLMCache, tokens: torch.Tensor, cfg, *,
                plain: bool = False):
    """Score a verify window ``tokens`` (B, K+1) by scanning single-token
    decode steps, checkpointing (conv, state) after every step (snapshot 0
    is the pre-verify state): the O(1) state cannot be rewound by position
    arithmetic, so ``spec_commit`` selects each slot's snapshot at its
    accepted length. Returns (logits (B, K+1, V_pad), snap)."""
    logits, convs, states = snapshot_verify(
        lambda c, t: decode_step(params, c, t, cfg, plain=plain), cache,
        tokens)
    return logits, (cache, convs, states)


def spec_commit(snap, committed: torch.Tensor):
    """Keep ``committed`` (B,) tokens of the verify window: each slot's
    snapshot ``committed`` is copied into the cache's conv and state in
    place (0 restores the pre-verify state), and the position moves by
    ``committed`` (a hybrid cache's K/V rows past it stay in memory, masked
    invalid). Returns the cache (the SSM or hybrid one)."""
    cache, convs, states = snap
    cache.conv.copy_(select_snapshot(convs, committed))
    cache.state.copy_(select_snapshot(states, committed))
    return cache._replace(pos=cache.pos + committed.to(cache.pos.dtype))


def block_params(params) -> list[Any]:
    """[embedding block, layer_0, ..., layer_{L-1}]."""
    layers = params["layers"]
    n = tree_leaves(layers)[0].shape[0]
    return [params["embed"]] + [tree_index(layers, i) for i in range(n)]
