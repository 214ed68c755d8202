"""Hybrid Mamba2 + shared-attention LM (zamba2-2.7b).

``num_layers`` Mamba2 blocks; ONE shared attention+MLP block (shared
weights) runs before every ``shared_attn_period`` Mamba2 layers, so with 54
layers and a period of 6 it runs 9 times, a *unit* being the shared block
and its 6 Mamba2 layers. The KV cache holds one (B, S, Hkv, hd) entry per
shared-block site (U of them: the activations differ per site although the
weights are shared); it is raw, one ``KVPage`` (the shared block has one
precision decision) or a ``PagedKV`` pool, with the U sites as its leading
axis. conv and state stay dense per slot, one per Mamba2 layer.

As in the reference, Zamba2's per-site LoRA adapters are omitted. Units run
in a Python loop; a mixed-precision plan's segments are cut at unit
boundaries by the compiler, and each unit runs the layers of its own
segments (``_layer_stack``). Decode writes K/V, conv and state in place. A
speculative verify scans single-token decode steps: the K/V rows written
past the commit point are rolled back by position (they stay in memory,
masked invalid), and conv/state by selecting each slot's snapshot.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import ssm as S
from repro_torch.models.common import (decode_positions, dense_init,
                                       dtype_of, embed_init, embed_lookup,
                                       lm_head, norm, remat_call)
# the commit is the SSM family's: conv/state take each slot's snapshot in
# place and the position moves (K/V rows past it stay, masked invalid)
from repro_torch.models.ssm_lm import snapshot_verify, spec_commit  # noqa: F401
from repro_torch.quant.apply import SegmentedParams, segment_slices
from repro_torch.quant.kvcache import is_kv_page, kv_layer
from repro_torch.tree import tree_index, tree_leaves, tree_unstack


class HybridCache(NamedTuple):
    conv: torch.Tensor    # (L, B, W-1, conv_dim)
    state: torch.Tensor   # (L, B, H, P, N) f32
    k: Any                # (U, B, S_max, Hkv, hd) U shared-attention sites;
    v: Any                #   raw, a KVPage or a PagedKV pool
    pos: torch.Tensor     # int32 next write position: scalar, or (B,)


CACHE_BATCH_AXES = HybridCache(conv=1, state=1, k=1, v=1, pos=0)
# fields the engine may replace with quantized KVPages
KV_CACHE_FIELDS = ("k", "v")


def num_units(cfg) -> int:
    assert cfg.num_layers % cfg.shared_attn_period == 0
    return cfg.num_layers // cfg.shared_attn_period


def init(cfg, gen: torch.Generator, device) -> dict:
    """Random weights at the JAX package's init scales, from ``gen``; the
    head is tied to the embedding."""
    dtype = dtype_of(cfg)
    n, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff
    embed = embed_init(gen, cfg.padded_vocab, d, dtype, device)
    layers = S.init_ssm_params(gen, cfg, n, dtype, device)
    layers["ln"] = torch.ones((n, d), dtype=dtype, device=device)
    attn = {k: v[0] for k, v in A.init_attention_params(
        gen, cfg, dtype, device, layers=1).items()}
    down = 1.0 / (2 * max(n, 1)) ** 0.5
    mlp = {"w_up": dense_init(gen, (ff, d), dtype, device),
           "w_down": dense_init(gen, (d, ff), dtype, device, scale=down)}
    if cfg.mlp_act == "swiglu":
        mlp["w_gate"] = dense_init(gen, (ff, d), dtype, device)
    ones = torch.ones((d,), dtype=dtype, device=device)
    return {"embed": {"tok": embed}, "layers": layers,
            "shared": {"attn": attn, "mlp": mlp, "ln1": ones,
                       "ln2": ones.clone()},
            "final": {"norm": ones.clone()}}


def _shared_block(shared, h, positions, cfg, cache_kv=None, cache_pos=None,
                  valid_bias=None, plain=False):
    a, _ = A.attention(
        shared["attn"], norm(h, shared["ln1"], cfg),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, positions=positions,
        rope_theta=cfg.rope_theta, causal=True, norm_eps=cfg.norm_eps,
        cache=cache_kv, cache_pos=cache_pos, valid_bias=valid_bias,
        plain=plain)
    h = h + a
    return h + M.mlp(shared["mlp"], norm(h, shared["ln2"], cfg), cfg.mlp_act,
                     plain)


def _layer_stack(layers, cfg) -> list:
    """Per unit, its Mamba2 layers as (segment params, index in the
    segment, layer index). A plain stack or a one-segment plan is one
    segment across every unit; a mixed plan's segments each lie inside one
    unit (the compiler cuts them at unit boundaries), and a unit runs the
    layers of its own segments."""
    period = cfg.shared_attn_period
    mixed = isinstance(layers, SegmentedParams) and len(layers.segments) > 1
    units: list = [[] for _ in range(num_units(cfg))]
    for part, lo, hi in segment_slices(layers):
        if mixed:
            assert lo // period == (hi - 1) // period, \
                f"segment [{lo},{hi}) crosses a unit boundary"
        for i in range(hi - lo):
            units[(lo + i) // period].append((part, i, lo + i))
    return units


def _head(params, h, cfg, plain):
    h = norm(h, params["final"]["norm"], cfg)
    return lm_head(h, params["embed"]["tok"], plain)


def apply(params, tokens: torch.Tensor, cfg, *, last_only: bool = False,
          plain: bool = False, remat: bool = False, with_aux: bool = False):
    """tokens (B, S) -> logits (B, S, V_pad) f32. ``remat`` recomputes each
    shared-block site and each Mamba2 layer in the backward pass (the
    shared weights' gradients sum over the sites); ``with_aux`` returns
    (logits, {})."""
    b, s = tokens.shape
    h = embed_lookup(params["embed"]["tok"], tokens, dtype_of(cfg))
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    shared = params["shared"]

    def site(shared, h):
        return _shared_block(shared, h, positions, cfg, plain=plain)

    def mamba(p, h):
        return h + S.ssm_block(p, norm(h, p["ln"], cfg), cfg, plain)

    layers = {id(part): tree_unstack(part, hi - lo)
              for part, lo, hi in segment_slices(params["layers"])}
    for unit in _layer_stack(params["layers"], cfg):
        h = remat_call(site, shared, h, remat=remat)
        for part, i, _ in unit:
            h = remat_call(mamba, layers[id(part)][i], h, remat=remat)
    if last_only:
        h = h[:, -1:, :]
    logits = _head(params, h, cfg, plain)
    return (logits, {}) if with_aux else logits


def init_cache(cfg, batch: int, max_seq: int, device) -> HybridCache:
    dtype = dtype_of(cfg)
    one = S.init_ssm_cache(batch, cfg, dtype, device)
    n = cfg.num_layers
    kv_shape = (num_units(cfg), batch, max_seq, cfg.num_kv_heads,
                cfg.head_dim)
    return HybridCache(
        conv=one.conv[None].expand(n, *one.conv.shape).contiguous(),
        state=one.state[None].expand(n, *one.state.shape).contiguous(),
        k=torch.zeros(kv_shape, dtype=dtype, device=device),
        v=torch.zeros(kv_shape, dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(params, cache: HybridCache, tokens: torch.Tensor, cfg, *,
                plain: bool = False):
    """tokens (B, 1) -> (logits (B, 1, V_pad), cache). K/V, conv and state
    are written in place; the returned cache carries ``pos + 1``."""
    b, s = tokens.shape
    if s != 1:
        raise ValueError(f"a hybrid decode step takes one token per slot, "
                         f"got {s}; scan a window token by token")
    h = embed_lookup(params["embed"]["tok"], tokens, dtype_of(cfg))
    positions = decode_positions(cache.pos, b, 1)
    # one validity mask for every site (quantized caches mask by position
    # inside decode attention)
    valid_bias = (None if is_kv_page(cache.k) else
                  A.decode_valid_bias(cache.pos, 1, cache.k.shape[2]))
    shared = params["shared"]
    for ui, unit in enumerate(_layer_stack(params["layers"], cfg)):
        h = _shared_block(shared, h, positions, cfg,
                          cache_kv=A.KVCache(k=kv_layer(cache.k, ui),
                                             v=kv_layer(cache.v, ui)),
                          cache_pos=cache.pos, valid_bias=valid_bias,
                          plain=plain)
        h2 = h[:, 0, :]
        for part, i, l in unit:
            p = tree_index(part, i)
            h2 = h2 + S.ssm_decode_step(
                p, norm(h2, p["ln"], cfg),
                S.SSMCache(conv=cache.conv[l], state=cache.state[l]), cfg,
                plain)
        h = h2[:, None, :]
    return _head(params, h, cfg, plain), cache._replace(pos=cache.pos + 1)


def spec_verify(params, cache: HybridCache, tokens: torch.Tensor, cfg, *,
                plain: bool = False):
    """Score a verify window ``tokens`` (B, K+1) by scanning single-token
    decode steps. The shared-attention K/V rows written past the commit
    point are rolled back by position; conv/state are snapshotted after
    every step and selected per slot by ``spec_commit``. Returns (logits
    (B, K+1, V_pad), snap)."""
    logits, convs, states = snapshot_verify(
        lambda c, t: decode_step(params, c, t, cfg, plain=plain), cache,
        tokens)
    return logits, (cache, convs, states)


def block_params(params) -> list[Any]:
    """[embedding, mamba_0, ..., mamba_{L-1}, shared]."""
    layers = params["layers"]
    n = tree_leaves(layers)[0].shape[0]
    return ([params["embed"]] + [tree_index(layers, i) for i in range(n)]
            + [params["shared"]])
