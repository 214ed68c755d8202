"""Decoder-only LM of the dense family (llama3.2-3b, yi-9b, minicpm-2b, ...).

Layers are stacked on a leading axis and run in a Python loop, one segment
of a ``SegmentedParams`` after another; parameters may be raw tensors or
QTensors (EWQ-quantized). The MoE branch of the JAX reference is still to
be ported.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models.common import (decode_positions, dtype_of,
                                       embed_init, embed_lookup, lm_head,
                                       norm)
from repro_torch.quant.apply import segment_slices
from repro_torch.quant.kvcache import is_kv_page, kv_layer, kv_segment
from repro_torch.tree import tree_index, tree_leaves


class DecodeCache(NamedTuple):
    k: Any              # (L, B, S_max, Hkv, hd) raw, or KVPage(s)
    v: Any
    pos: torch.Tensor   # int32 next write position: scalar, or (B,)


# batch axis of each cache field in the slotted layout (pos is (B,))
CACHE_BATCH_AXES = DecodeCache(k=1, v=1, pos=0)
# fields the engine may replace with quantized KVPages
KV_CACHE_FIELDS = ("k", "v")


def _require_dense(cfg) -> None:
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "the MoE branch of the transformer is still to be ported "
            "(ROADMAP.md, 'the other families')")


def init(cfg, gen: torch.Generator, device) -> dict:
    """Random weights at the JAX package's init scales, from ``gen``."""
    _require_dense(cfg)
    dtype = dtype_of(cfg)
    n, d = cfg.num_layers, cfg.d_model
    layers: dict = {"attn": A.init_attention_params(gen, cfg, dtype, device)}
    if not cfg.nonparametric_norm:
        layers["ln1"] = torch.ones((n, d), dtype=dtype, device=device)
        layers["ln2"] = torch.ones((n, d), dtype=dtype, device=device)
    layers["mlp"] = M.init_mlp_params(gen, n, d, cfg.d_ff, dtype, device)
    params = {"embed": {"tok": embed_init(gen, cfg.padded_vocab, d, dtype,
                                          device)},
              "layers": layers, "final": {}}
    if not cfg.nonparametric_norm:
        params["final"]["norm"] = torch.ones((d,), dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        from repro_torch.models.common import dense_init
        params["final"]["head"] = dense_init(gen, (cfg.padded_vocab, d),
                                             dtype, device)
    return params


def _layer(p, h, positions, cfg, cache_kv=None, cache_pos=None,
           valid_bias=None, emit_kv=False, plain=False):
    a, kv = A.attention(
        p["attn"], norm(h, p.get("ln1"), cfg),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, positions=positions,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps, cache=cache_kv, cache_pos=cache_pos,
        valid_bias=valid_bias, emit_kv=emit_kv, plain=plain)
    h = h + a
    m = M.mlp(p["mlp"], norm(h, p.get("ln2"), cfg), cfg.mlp_act, plain)
    return h + m, kv


def _head(params, h, cfg, plain):
    h = norm(h, params["final"].get("norm"), cfg)
    head_w = params["final"].get("head", params["embed"]["tok"])
    return lm_head(h, head_w, plain)


def apply(params, tokens: torch.Tensor, cfg, *, return_cache: bool = False,
          last_only: bool = False, plain: bool = False):
    """tokens (B, S) -> logits (B, S, V_pad) f32; with ``return_cache`` also
    the raw (L, B, S, Hkv, hd) K/V cache at position S. ``last_only`` takes
    the head logits of the final position only (serving prefill)."""
    _require_dense(cfg)
    b, s = tokens.shape
    h = embed_lookup(params["embed"]["tok"], tokens, dtype_of(cfg))
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    ks, vs = [], []
    for part, lo, hi in segment_slices(params["layers"]):
        for i in range(hi - lo):
            h, kv = _layer(tree_index(part, i), h, positions, cfg,
                           emit_kv=return_cache, plain=plain)
            if return_cache:
                ks.append(kv.k)
                vs.append(kv.v)
    if last_only:
        h = h[:, -1:, :]
    logits = _head(params, h, cfg, plain)
    if not return_cache:
        return logits
    pos = torch.tensor(s, dtype=torch.int32, device=tokens.device)
    return logits, DecodeCache(k=torch.stack(ks), v=torch.stack(vs), pos=pos)


def init_cache(cfg, batch: int, max_seq: int, device) -> DecodeCache:
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype_of(cfg)
    return DecodeCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       pos=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(params, cache: DecodeCache, tokens: torch.Tensor, cfg, *,
                plain: bool = False):
    """tokens (B, s) -> (logits (B, s, V_pad), cache). The cache's K/V are
    written in place; the returned cache carries ``pos + s``."""
    _require_dense(cfg)
    b, s = tokens.shape
    h = embed_lookup(params["embed"]["tok"], tokens, dtype_of(cfg))
    positions = decode_positions(cache.pos, b, s)
    # the validity mask is the same for every layer: built once per step
    # (quantized caches mask by position inside decode attention)
    valid_bias = (None if is_kv_page(cache.k) else
                  A.decode_valid_bias(cache.pos, s, cache.k.shape[2]))
    for si, (part, lo, hi) in enumerate(segment_slices(params["layers"])):
        kseg = kv_segment(cache.k, si, lo, hi)
        vseg = kv_segment(cache.v, si, lo, hi)
        for i in range(hi - lo):
            h, _ = _layer(tree_index(part, i), h, positions, cfg,
                          cache_kv=A.KVCache(k=kv_layer(kseg, i),
                                             v=kv_layer(vseg, i)),
                          cache_pos=cache.pos, valid_bias=valid_bias,
                          plain=plain)
    logits = _head(params, h, cfg, plain)
    return logits, cache._replace(pos=cache.pos + s)


def block_params(params) -> list[Any]:
    """[embedding block, layer_0, ..., layer_{L-1}] - paper exec order."""
    layers = params["layers"]
    num_layers = tree_leaves(layers)[0].shape[0]
    return [params["embed"]] + [tree_index(layers, i)
                                for i in range(num_layers)]
