"""Encoder-decoder transformer (the whisper-medium backbone).

The audio frontend is a stub, as in the JAX reference: a request carries
precomputed frame embeddings (B, encoder_seq, d_model). Encoder layers are
bidirectional self-attention + GeLU MLP; decoder layers are causal
self-attention + cross-attention + GeLU MLP; LayerNorm with a scale, no
rope: sinusoidal positions on both sides.

Both stacks run in a Python loop, one segment of a ``SegmentedParams``
after another. Decode keeps the decoder's self-attention cache (written in
place) and the cross-attention K/V computed once per request from the
encoder output (``precompute_cross_kv``); a quantized cache holds both as
``KVPage``s, and cross-attention then runs the decode attention kernel
with ``causal=False`` over all ``encoder_seq`` rows. Over a paged pool the
self-attention K/V live in the pool and the cross K/V stay a dense field
per slot. A speculative verify window is one multi-query decode step
(cross-attention is non-causal over the fixed encoder rows) and rolls back
by position arithmetic; the family has no read-only propose step, so a
draft proposes on a clone of the whole cache, the slot's cross K/V
included.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.kernels.qmatmul.ops import qdot
from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models.common import (decode_positions, dtype_of,
                                       embed_init, embed_lookup, layer_norm,
                                       lm_head, remat_call,
                                       sinusoidal_positions)
from repro_torch.quant.apply import segment_slices
from repro_torch.quant.kvcache import is_kv_page, kv_layer, kv_segment
from repro_torch.tree import tree_index, tree_leaves, tree_unstack


class EncDecCache(NamedTuple):
    k: Any              # (Ld, B, S_max, Hkv, hd) decoder self-attention,
    v: Any              #   raw or KVPage(s)
    cross_k: Any        # (Ld, B, S_enc, Hkv, hd) encoder K/V per decoder
    cross_v: Any        #   layer, quantized once at admission
    pos: torch.Tensor   # int32 next write position: scalar, or (B,)


# batch axis of each cache field in the slotted layout (pos is (B,))
CACHE_BATCH_AXES = EncDecCache(k=1, v=1, cross_k=1, cross_v=1, pos=0)
# fields the engine may replace with quantized KVPages
KV_CACHE_FIELDS = ("k", "v", "cross_k", "cross_v")


def _ln(x, w, cfg):
    return layer_norm(x, w, cfg.norm_eps)


def _heads(cfg) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, norm_eps=cfg.norm_eps)


def init(cfg, gen: torch.Generator, device) -> dict:
    """Random weights at the JAX package's init scales, from ``gen``."""
    dtype = dtype_of(cfg)
    d, ne, nd = cfg.d_model, cfg.num_encoder_layers, cfg.num_layers

    def ones(n):
        return torch.ones((n, d), dtype=dtype, device=device)

    embed = embed_init(gen, cfg.padded_vocab, d, dtype, device)
    enc = {"attn": A.init_attention_params(gen, cfg, dtype, device,
                                           layers=ne),
           "mlp": M.init_mlp_params(gen, ne, d, cfg.d_ff, dtype, device,
                                    act="gelu"),
           "ln1": ones(ne), "ln2": ones(ne)}
    dec = {"self_attn": A.init_attention_params(gen, cfg, dtype, device),
           "cross_attn": A.init_attention_params(gen, cfg, dtype, device),
           "mlp": M.init_mlp_params(gen, nd, d, cfg.d_ff, dtype, device,
                                    act="gelu"),
           "ln1": ones(nd), "ln_x": ones(nd), "ln2": ones(nd)}
    return {"embed": {"tok": embed}, "enc_layers": enc, "dec_layers": dec,
            "final": {"enc_norm": torch.ones((d,), dtype=dtype, device=device),
                      "norm": torch.ones((d,), dtype=dtype, device=device)}}


def encode(params, frames: torch.Tensor, cfg, *, plain: bool = False,
           remat: bool = False) -> torch.Tensor:
    """frames (B, S_enc, D) precomputed embeddings -> (B, S_enc, D);
    ``remat`` recomputes each layer in the backward pass."""
    dtype = dtype_of(cfg)
    s = frames.shape[1]
    h = (frames.to(dtype)
         + sinusoidal_positions(s, cfg.d_model, frames.device).to(dtype)[None])

    def layer(p, h):
        a, _ = A.attention(p["attn"], _ln(h, p["ln1"], cfg),
                           causal=False, plain=plain, **_heads(cfg))
        h = h + a
        return h + M.mlp(p["mlp"], _ln(h, p["ln2"], cfg), "gelu", plain)

    for part, lo, hi in segment_slices(params["enc_layers"]):
        for p in tree_unstack(part, hi - lo):
            h = remat_call(layer, p, h, remat=remat)
    return _ln(h, params["final"]["enc_norm"], cfg)


def _dec_layer(p, h, cfg, enc_out=None, cache_kv=None, cache_pos=None,
               cross_kv=None, valid_bias=None, plain=False):
    a, _ = A.attention(p["self_attn"], _ln(h, p["ln1"], cfg), causal=True,
                       cache=cache_kv, cache_pos=cache_pos,
                       valid_bias=valid_bias, plain=plain, **_heads(cfg))
    h = h + a
    if cross_kv is not None:
        x, _ = A.attention(p["cross_attn"], _ln(h, p["ln_x"], cfg),
                           cached_kv=cross_kv, plain=plain, **_heads(cfg))
    else:
        x, _ = A.attention(p["cross_attn"], _ln(h, p["ln_x"], cfg),
                           causal=False, kv_x=enc_out, plain=plain,
                           **_heads(cfg))
    h = h + x
    return h + M.mlp(p["mlp"], _ln(h, p["ln2"], cfg), "gelu", plain)


def _head(params, h, cfg, plain):
    # whisper ties the head to the token embedding
    h = _ln(h, params["final"]["norm"], cfg)
    return lm_head(h, params["embed"]["tok"], plain)


def apply(params, tokens: torch.Tensor, frames: torch.Tensor, cfg, *,
          last_only: bool = False, plain: bool = False, remat: bool = False,
          with_aux: bool = False):
    """Full forward: (B, S) tokens + (B, S_enc, D) frames -> logits
    (B, S, V_pad) f32 (``last_only``: the final position only). ``remat``
    recomputes each encoder and decoder layer in the backward pass;
    ``with_aux`` returns (logits, {})."""
    dtype = dtype_of(cfg)
    s = tokens.shape[1]
    enc_out = encode(params, frames, cfg, plain=plain, remat=remat)
    h = embed_lookup(params["embed"]["tok"], tokens, dtype)
    h = h + sinusoidal_positions(s, cfg.d_model, tokens.device).to(dtype)[None]

    def layer(p, h, enc_out):
        return _dec_layer(p, h, cfg, enc_out=enc_out, plain=plain)

    for part, lo, hi in segment_slices(params["dec_layers"]):
        for p in tree_unstack(part, hi - lo):
            h = remat_call(layer, p, h, enc_out, remat=remat)
    if last_only:
        h = h[:, -1:, :]
    logits = _head(params, h, cfg, plain)
    return (logits, {}) if with_aux else logits


def init_cache(cfg, batch: int, max_seq: int, device) -> EncDecCache:
    dtype = dtype_of(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    cross = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
             cfg.head_dim)
    return EncDecCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        cross_k=torch.zeros(cross, dtype=dtype, device=device),
        cross_v=torch.zeros(cross, dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def precompute_cross_kv(params, enc_out: torch.Tensor, cfg, *,
                        plain: bool = False) -> tuple:
    """The encoder K/V of every decoder layer, each (Ld, B, S_enc, Hkv, hd)
    in the model dtype: computed once per request."""
    b, s, _ = enc_out.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    ks, vs = [], []
    for part, lo, hi in segment_slices(params["dec_layers"]):
        for i in range(hi - lo):
            p = tree_index(part, i)["cross_attn"]
            ks.append(qdot(enc_out, p["wk"], plain=plain).reshape(b, s, hkv, hd))
            vs.append(qdot(enc_out, p["wv"], plain=plain).reshape(b, s, hkv, hd))
    return torch.stack(ks), torch.stack(vs)


def _positional(pos: torch.Tensor, b: int, s: int, d: int) -> torch.Tensor:
    """(B, s, D) f32 sinusoidal embedding of the decode positions: the
    reference's f32 arithmetic (and no host-to-device copy, so the step can
    be captured in a CUDA graph)."""
    half = d // 2
    expo = torch.arange(half, dtype=torch.float32, device=pos.device) / half
    freqs = 1.0 / torch.pow(torch.full((), 10000.0, dtype=torch.float32,
                                       device=pos.device), expo)
    ang = decode_positions(pos, b, s).float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def decode_step(params, cache: EncDecCache, tokens: torch.Tensor, cfg, *,
                plain: bool = False):
    """tokens (B, s) -> (logits (B, s, V_pad), cache). The self-attention
    K/V are written in place; the returned cache carries ``pos + s``."""
    dtype = dtype_of(cfg)
    b, s = tokens.shape
    h = embed_lookup(params["embed"]["tok"], tokens, dtype)
    h = h + _positional(cache.pos, b, s, cfg.d_model).to(dtype)
    valid_bias = (None if is_kv_page(cache.k) else
                  A.decode_valid_bias(cache.pos, s, cache.k.shape[2]))
    for si, (part, lo, hi) in enumerate(segment_slices(params["dec_layers"])):
        seg = [kv_segment(f, si, lo, hi)
               for f in (cache.k, cache.v, cache.cross_k, cache.cross_v)]
        for i in range(hi - lo):
            k, v, ck, cv = (kv_layer(f, i) for f in seg)
            h = _dec_layer(tree_index(part, i), h, cfg,
                           cache_kv=A.KVCache(k=k, v=v), cache_pos=cache.pos,
                           cross_kv=A.KVCache(k=ck, v=cv),
                           valid_bias=valid_bias, plain=plain)
    return _head(params, h, cfg, plain), cache._replace(pos=cache.pos + s)


def spec_verify(params, cache: EncDecCache, tokens: torch.Tensor, cfg, *,
                plain: bool = False):
    """Score a verify window ``tokens`` (B, K+1) in one multi-query decode
    step over the decoder stack (rows written in place at ``cache.pos``).
    Returns (logits (B, K+1, V_pad), snap) for ``spec_commit``."""
    logits, new_cache = decode_step(params, cache, tokens, cfg, plain=plain)
    return logits, (new_cache, tokens.shape[1])


def spec_commit(snap, committed: torch.Tensor) -> EncDecCache:
    """Keep ``committed`` (B,) rows of the verify window: position
    arithmetic alone (0 rolls a slot back to its pre-verify position)."""
    cache, s = snap
    return cache._replace(pos=cache.pos - s + committed.to(cache.pos.dtype))


def block_params(params) -> list[Any]:
    """[embed, enc_0 .. enc_{Le-1}, dec_0 .. dec_{Ld-1}]: two stacks, one
    plan."""
    blocks = [params["embed"]]
    for name in ("enc_layers", "dec_layers"):
        layers = params[name]
        n = tree_leaves(layers)[0].shape[0]
        blocks += [tree_index(layers, i) for i in range(n)]
    return blocks
