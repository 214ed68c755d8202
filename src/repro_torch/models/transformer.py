"""Decoder-only LM of the dense and MoE families (llama3.2-3b, yi-9b,
minicpm-2b, ...; grok-1-314b, and arctic-480b with its dense residual MLP
beside the experts).

Layers are stacked on a leading axis and run in a Python loop, one segment
of a ``SegmentedParams`` after another; parameters may be raw tensors or
QTensors (EWQ-quantized). An MoE layer's output depends on which tokens
share its call (capacity drops, ``models/moe.py``): a forward routes the
whole (B, S) batch at once, a decode step every slot, a verify window all
of its B * (K + 1) tokens, as the reference does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models import moe as MOE
from repro_torch.models.common import (decode_positions, dtype_of,
                                       embed_init, embed_lookup,
                                       embed_lookup_sharded, lm_head,
                                       lm_head_sharded, norm, remat_call)
from repro_torch.quant.apply import segment_slices
from repro_torch.quant.kvcache import (is_kv_page, kv_layer, kv_segment,
                                       kv_take_layers)
from repro_torch.quant.qtypes import QTensor
from repro_torch.sharding import collective as C
from repro_torch.sharding.ctx import unshard_fsdp
from repro_torch.tree import tree_index, tree_leaves, tree_unstack


class DecodeCache(NamedTuple):
    k: Any              # (L, B, S_max, Hkv, hd) raw, or KVPage(s)
    v: Any
    pos: torch.Tensor   # int32 next write position: scalar, or (B,)


# batch axis of each cache field in the slotted layout (pos is (B,))
CACHE_BATCH_AXES = DecodeCache(k=1, v=1, pos=0)
# fields the engine may replace with quantized KVPages
KV_CACHE_FIELDS = ("k", "v")


def init(cfg, gen: torch.Generator, device) -> dict:
    """Random weights at the JAX package's init scales, from ``gen``."""
    dtype = dtype_of(cfg)
    n, d = cfg.num_layers, cfg.d_model
    layers: dict = {"attn": A.init_attention_params(gen, cfg, dtype, device)}
    if not cfg.nonparametric_norm:
        layers["ln1"] = torch.ones((n, d), dtype=dtype, device=device)
        layers["ln2"] = torch.ones((n, d), dtype=dtype, device=device)
    if cfg.num_experts > 0:
        layers["moe"] = MOE.init_moe_params(
            gen, n, d, cfg.expert_d_ff, cfg.num_experts, cfg.num_layers,
            dtype, device)
    if cfg.num_experts == 0 or cfg.dense_residual:
        layers["mlp"] = M.init_mlp_params(gen, n, d, cfg.d_ff, dtype, device,
                                          cfg.mlp_act)
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
           valid_bias=None, fresh_kv=None, emit_kv=False, plain=False,
           aux=None):
    a, kv = A.attention(
        p["attn"], norm(h, p.get("ln1"), cfg),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, positions=positions,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps, cache=cache_kv, cache_pos=cache_pos,
        valid_bias=valid_bias, fresh_kv=fresh_kv, emit_kv=emit_kv,
        plain=plain)
    h = h + a
    return h + _ffn(p, norm(h, p.get("ln2"), cfg), cfg, plain, aux), kv


def _ffn(p, hn, cfg, plain, aux=None):
    """The layer's MLP, or its experts (plus arctic's dense residual MLP on
    the same input); an MoE layer appends its load-balancing loss to
    ``aux`` when given a list."""
    if cfg.num_experts == 0:
        return M.mlp(p["mlp"], hn, cfg.mlp_act, plain)
    m, a = MOE.moe_block(p["moe"], hn, num_experts=cfg.num_experts,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, plain=plain)
    if aux is not None:
        aux.append(a["moe_aux_loss"])
    if cfg.dense_residual:
        m = m + M.mlp(p["mlp"], hn, cfg.mlp_act, plain)
    return m


def _head(params, h, cfg, plain):
    h = norm(h, params["final"].get("norm"), cfg)
    head_w = params["final"].get("head", params["embed"]["tok"])
    return lm_head(h, head_w, plain)


# --------------------------------------------------------------------------
# Tensor parallelism over a model-axis group (mesh serving)
# --------------------------------------------------------------------------

def _tp_segments(ps: list) -> list:
    """[(each position's segment stack, lo, hi), ...] of a group whose
    positions hold the same segment layout."""
    per = [segment_slices(p["layers"]) for p in ps]
    return [([seg[k][0] for seg in per], per[0][k][1], per[0][k][2])
            for k in range(len(per[0]))]


def _tp_ffn(ps: list, hns: list, cfg, plain):
    """The MLP over a group: each position's slice of d_ff, its partial
    outputs summed; an MLP the rules replicate (d_ff not divisible by the
    axis) runs once."""
    w = ps[0]["mlp"]["w_up"]
    if (w.data if isinstance(w, QTensor) else w).shape[-2] == cfg.d_ff:
        return M.mlp(ps[0]["mlp"], hns[0], cfg.mlp_act, plain)
    return C.reduce_sum([M.mlp(p["mlp"], hn, cfg.mlp_act, plain)
                         for p, hn in zip(ps, hns)], hns[0].device)


def _tp_kv_heads(ps: list, devices: list, cfg) -> tuple[list, int]:
    """(the group's trees, KV heads a position) where position m's KV rows
    hold whole heads for its query heads. When the KV heads do not divide
    the model axis the rules still split wk / wv by rows (the SMOKE
    llama's 2 KV heads over 4 positions: half a head each), so wk and wv
    are gathered over the group and each position keeps the KV heads its
    query heads read (KV heads replicated, as Megatron does; one per query
    head when its query heads straddle KV heads unevenly). Serving refuses
    such a mesh (``serving/batch.py`` ``_check_heads``); training takes it,
    as the reference does."""
    t = len(ps)
    if cfg.num_heads % t:
        raise NotImplementedError(
            f"{cfg.num_heads} query heads over a model axis of {t}: a shard "
            f"would split a head (ROADMAP.md queue 1 item 10)")
    if cfg.num_kv_heads % t == 0:
        return ps, cfg.num_kv_heads // t
    nq, hd = cfg.num_heads // t, cfg.head_dim
    rep = cfg.num_heads // cfg.num_kv_heads
    out = []
    for m, (p, dev) in enumerate(zip(ps, devices)):
        heads = [(m * nq + j) // rep for j in range(nq)]
        uniq = sorted(set(heads))
        if nq % len(uniq) == 0 and heads == [
                uniq[j // (nq // len(uniq))] for j in range(nq)]:
            heads = uniq
        rows = torch.tensor([h * hd + i for h in heads for i in range(hd)],
                            device=dev)
        attn = dict(p["attn"])
        for name in ("wk", "wv"):
            whole = C.gather([q["attn"][name] for q in ps], dev, dim=-2)
            attn[name] = torch.index_select(whole, -2, rows)
        out.append({**p, "attn": attn})
    return out, len(heads)


def _tp_layer(ps: list, devices: list, h, positions: list, cfg, caches=None,
              cache_pos=None, valid_bias=None, emit_kv=False, plain=False):
    """One layer over a model-axis group: position m attends with its
    num_heads / T query heads over its num_kv_heads / T KV heads (its rows
    of wq/wk/wv, its columns of wo), and the row-parallel partials (wo,
    w_down) are summed before each residual add. ``h`` lives on
    ``devices[0]``; the per-position arguments are lists. A training
    placement's FSDP leaves are gathered first (``unshard_fsdp``, where
    the reference's layer body calls it: ``transformer.py:87``, ``:124``)."""
    ps = [unshard_fsdp(p) for p in ps]
    ps, kv_heads = _tp_kv_heads(ps, devices, cfg)
    t = len(ps)
    hns = C.broadcast(norm(h, ps[0].get("ln1"), cfg), devices)
    parts, kvs = [], []
    for m, p in enumerate(ps):
        a, kv = A.attention(
            p["attn"], hns[m], num_heads=cfg.num_heads // t,
            num_kv_heads=kv_heads, head_dim=cfg.head_dim,
            positions=positions[m], rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
            cache=None if caches is None else caches[m],
            cache_pos=None if cache_pos is None else cache_pos[m],
            valid_bias=None if valid_bias is None else valid_bias[m],
            emit_kv=emit_kv, plain=plain)
        parts.append(a)
        kvs.append(kv)
    h = h + C.reduce_sum(parts, h.device)
    hns = C.broadcast(norm(h, ps[0].get("ln2"), cfg), devices)
    return h + _tp_ffn(ps, hns, cfg, plain), kvs


def _tp_head(ps: list, devices: list, h, cfg, plain, tables: list):
    """The vocab-parallel head; a tied head reads the embedding tables
    ``_tp_embed`` gathered (the reference's ``transformer.py:182``)."""
    finals = [unshard_fsdp(p["final"]) for p in ps]
    h = norm(h, finals[0].get("norm"), cfg)
    heads = [f.get("head", tab) for f, tab in zip(finals, tables)]
    return lm_head_sharded(C.broadcast(h, devices), heads, devices,
                           cfg.padded_vocab, plain)


def _tp_embed(ps: list, devices: list, tokens, cfg):
    """(h, each position's embedding table, gathered under a training
    placement: the reference's ``transformer.py:124``)."""
    tables = [unshard_fsdp(p["embed"])["tok"] for p in ps]
    return embed_lookup_sharded(tables, tokens, dtype_of(cfg), devices,
                                cfg.padded_vocab), tables


def _apply_tp(group, tokens, cfg, *, return_cache, last_only, plain,
              remat=False, with_aux=False):
    """``apply`` over a model-axis group; the cache comes back as a
    ``TPCache`` of each position's raw K/V heads. ``remat`` recomputes each
    layer (its FSDP gathers included) in the backward pass; ``with_aux``
    adds the empty aux dict of a dense model."""
    if cfg.num_experts > 0:
        raise NotImplementedError("tensor parallelism of the MoE family "
                                  "(ROADMAP.md queue 1 item 10)")
    ps, devs = group.shards, group.devices
    b, s = tokens.shape
    h, tables = _tp_embed(ps, devs, tokens, cfg)
    positions = C.broadcast(torch.arange(s, dtype=torch.int32,
                                         device=tokens.device)[None]
                            .expand(b, s), devs)

    def layer(layer_ps, h):
        return _tp_layer(layer_ps, devs, h, positions, cfg,
                         emit_kv=return_cache, plain=plain)

    ks: list = [[] for _ in ps]
    vs: list = [[] for _ in ps]
    for parts, lo, hi in _tp_segments(ps):
        stacks = [tree_unstack(pt, hi - lo) for pt in parts]
        for i in range(hi - lo):
            h, kvs = remat_call(layer, [st[i] for st in stacks], h,
                                remat=remat)
            if return_cache:
                for m, kv in enumerate(kvs):
                    ks[m].append(kv.k)
                    vs[m].append(kv.v)
    if last_only:
        h = h[:, -1:, :]
    logits = _tp_head(ps, devs, h, cfg, plain, tables)
    out = (logits,) + (({},) if with_aux else ())
    if return_cache:
        out += (C.TPCache([
            DecodeCache(k=torch.stack(ks[m]), v=torch.stack(vs[m]),
                        pos=torch.tensor(s, dtype=torch.int32,
                                         device=devs[m]))
            for m in range(len(ps))]),)
    return out[0] if len(out) == 1 else out


def _decode_step_tp(group, cache, tokens, cfg, plain):
    """``decode_step`` over a model-axis group and its ``TPCache``."""
    ps, devs = group.shards, group.devices
    b, s = tokens.shape
    parts = cache.parts
    h, tables = _tp_embed(ps, devs, tokens, cfg)
    positions = [decode_positions(c.pos, b, s) for c in parts]
    valid_bias = [None if is_kv_page(c.k) else
                  A.decode_valid_bias(c.pos, s, c.k.shape[2]) for c in parts]
    for si, (segs, lo, hi) in enumerate(_tp_segments(ps)):
        ksegs = [kv_segment(c.k, si, lo, hi) for c in parts]
        vsegs = [kv_segment(c.v, si, lo, hi) for c in parts]
        for i in range(hi - lo):
            h, _ = _tp_layer(
                [tree_index(pt, i) for pt in segs], devs, h, positions, cfg,
                caches=[A.KVCache(k=kv_layer(kseg, i), v=kv_layer(vseg, i))
                        for kseg, vseg in zip(ksegs, vsegs)],
                cache_pos=[c.pos for c in parts], valid_bias=valid_bias,
                plain=plain)
    logits = _tp_head(ps, devs, h, cfg, plain, tables)
    return logits, C.TPCache([c._replace(pos=c.pos + s) for c in parts])


def apply(params, tokens: torch.Tensor, cfg, *, return_cache: bool = False,
          last_only: bool = False, plain: bool = False, remat: bool = False,
          with_aux: bool = False):
    """tokens (B, S) -> logits (B, S, V_pad) f32; with ``return_cache`` also
    the raw (L, B, S, Hkv, hd) K/V cache at position S. ``last_only`` takes
    the head logits of the final position only (serving prefill).
    ``remat`` recomputes each layer in the backward pass instead of keeping
    its activations; ``with_aux`` also returns the aux dict after the
    logits (an MoE model's ``moe_aux_loss``, summed over its layers).
    ``params`` may be a ``TPGroup``: one data row of a mesh, serving or
    (its shards holding ``FSDPLeaf``s) training."""
    if isinstance(params, C.TPGroup):
        return _apply_tp(params, tokens, cfg, return_cache=return_cache,
                         last_only=last_only, plain=plain, remat=remat,
                         with_aux=with_aux)
    b, s = tokens.shape
    h = embed_lookup(params["embed"]["tok"], tokens, dtype_of(cfg))
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)

    def layer(p, h):
        aux: list = []
        h, kv = _layer(p, h, positions, cfg, emit_kv=return_cache,
                       plain=plain, aux=aux)
        return h, kv, (aux[0] if aux else None)

    ks, vs, auxs = [], [], []
    for part, lo, hi in segment_slices(params["layers"]):
        for p in tree_unstack(part, hi - lo):
            h, kv, a = remat_call(layer, p, h, remat=remat)
            if a is not None:
                auxs.append(a)
            if return_cache:
                ks.append(kv.k)
                vs.append(kv.v)
    if last_only:
        h = h[:, -1:, :]
    logits = _head(params, h, cfg, plain)
    out = (logits,)
    if with_aux:
        out += ({"moe_aux_loss": torch.stack(auxs).sum()} if auxs else {},)
    if return_cache:
        pos = torch.tensor(s, dtype=torch.int32, device=tokens.device)
        out += (DecodeCache(k=torch.stack(ks), v=torch.stack(vs), pos=pos),)
    return out[0] if len(out) == 1 else out


def init_cache(cfg, batch: int, max_seq: int, device) -> DecodeCache:
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype_of(cfg)
    return DecodeCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       pos=torch.zeros((), dtype=torch.int32, device=device))


def decode_step(params, cache: DecodeCache, tokens: torch.Tensor, cfg, *,
                plain: bool = False):
    """tokens (B, s) -> (logits (B, s, V_pad), cache). The cache's K/V are
    written in place; the returned cache carries ``pos + s``. Over a
    ``TPGroup`` the cache is its ``TPCache``."""
    if isinstance(params, C.TPGroup):
        return _decode_step_tp(params, cache, tokens, cfg, plain)
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


def draft_propose_step(params, cache: DecodeCache, fresh_k: torch.Tensor,
                       fresh_v: torch.Tensor, count: int,
                       tokens: torch.Tensor, cfg, *, plain: bool = False):
    """One READ-ONLY draft decode step (the fused speculative propose): the
    cache is only read. Each layer's new K/V land in row ``count`` of the
    raw side buffers ``fresh_k``/``fresh_v`` ((L_draft, B, K, Hkv, hd),
    written in place), and decode attention sweeps cache and buffer in one
    pass with buffer rows at positions ``cache.pos + j``. ``params`` may be
    a draft truncated to its first layers; its segments each sit inside
    one cache page (``kv_take_layers``). tokens (B, 1) -> (logits
    (B, 1, V_pad), fresh_k, fresh_v)."""
    b, s = tokens.shape
    h = embed_lookup(params["embed"]["tok"], tokens, dtype_of(cfg))
    positions = decode_positions(cache.pos + count, b, s)
    for part, lo, hi in segment_slices(params["layers"]):
        kseg = kv_take_layers(cache.k, lo, hi)
        vseg = kv_take_layers(cache.v, lo, hi)
        for i in range(hi - lo):
            h, _ = _layer(tree_index(part, i), h, positions, cfg,
                          cache_kv=A.KVCache(k=kv_layer(kseg, i),
                                             v=kv_layer(vseg, i)),
                          cache_pos=cache.pos,
                          fresh_kv=(fresh_k[lo + i], fresh_v[lo + i], count),
                          plain=plain)
    return _head(params, h, cfg, plain), fresh_k, fresh_v


def spec_verify(params, cache: DecodeCache, tokens: torch.Tensor, cfg, *,
                plain: bool = False):
    """Score a verify window ``tokens`` (B, K+1) in one multi-query decode
    step (rows written in place at ``cache.pos``). Returns (logits
    (B, K+1, V_pad), snap); ``spec_commit(snap, committed)`` rolls each
    slot back to its accepted length by position arithmetic alone: rows
    past the commit point stay in memory, masked invalid."""
    logits, new_cache = decode_step(params, cache, tokens, cfg, plain=plain)
    return logits, (new_cache, tokens.shape[1])


def spec_commit(snap, committed: torch.Tensor) -> DecodeCache:
    """Keep ``committed`` (B,) rows of the verify window (0 rolls a slot
    all the way back to its pre-verify position)."""
    cache, s = snap
    return cache._replace(pos=cache.pos - s + committed.to(cache.pos.dtype))


def block_params(params) -> list[Any]:
    """[embedding block, layer_0, ..., layer_{L-1}] - paper exec order."""
    layers = params["layers"]
    num_layers = tree_leaves(layers)[0].shape[0]
    return [params["embed"]] + [tree_index(layers, i)
                                for i in range(num_layers)]
