"""GQA attention with RoPE and a KV cache.

Weights per attention block (all stored (out, in)):
  wq: (H*hd, D)   wk: (Hkv*hd, D)   wv: (Hkv*hd, D)   wo: (D, H*hd)

Prefill runs causal attention in plain tensor ops (materialized scores, or
a chunked online softmax above ``CHUNK_THRESHOLD`` tokens), as the JAX
package leaves it to XLA. Decode writes the new K/V into the cache in place
and attends over it: a raw cache with a validity bias, a quantized
``KVPage`` cache through the decode attention kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.kernels.qmatmul.ops import fused_qkv, qdot
from repro_torch.models.common import dense_init, rms_norm, rope
from repro_torch.quant import kvcache as KV

NEG_INF = -1e30
CHUNK_THRESHOLD = 8192
Q_CHUNK = 2048
KV_CHUNK = 2048


class KVCache(NamedTuple):
    """One layer's attention cache: raw (B, S_max, Hkv, hd) tensors, or
    ``KVPage``s of a quantized cache."""
    k: object
    v: object


def _inv_sqrt(d: int, device) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.full((), float(d), dtype=torch.float32,
                                       device=device))


def decode_valid_bias(cache_pos: torch.Tensor, s: int, t: int
                      ) -> torch.Tensor:
    """Additive decode mask: query i at ``cache_pos + i`` sees cache rows
    ``<= cache_pos + i``. Broadcastable against (B, Hkv, rep, S, T)."""
    dev = cache_pos.device
    rows = torch.arange(t, device=dev)
    qi = torch.arange(s, device=dev)
    zero = torch.zeros((), device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    if cache_pos.ndim == 1:
        valid = rows[None, None, :] <= (cache_pos[:, None, None]
                                        + qi[None, :, None])     # (B, S, T)
        return torch.where(valid, zero, neg)[:, None, None]
    valid = rows[None, :] <= (cache_pos + qi[:, None])            # (S, T)
    return torch.where(valid, zero, neg)[None, None, None]


def _full_attention(q, k, v, mask_bias):
    """Materialized-scores attention (prefill, raw-cache decode)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qh = q.reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bshrd,bthd->bhrst", qh.float(), k.float())
    scores = scores / torch.sqrt(torch.full((), float(d), device=q.device))
    probs = torch.softmax(scores + mask_bias, dim=-1)
    out = torch.einsum("bhrst,bthd->bshrd", probs.to(v.dtype), v)
    return out.reshape(b, s, h, d)


def _chunked_causal_attention(q, k, v):
    """Online-softmax causal attention over (Q_CHUNK, KV_CHUNK) blocks:
    temporaries stay O(q_chunk * kv_chunk) instead of O(S * T)."""
    b, s, h, d = q.shape
    hkv, t = k.shape[2], k.shape[1]
    rep = h // hkv
    q_chunk = Q_CHUNK if s % Q_CHUNK == 0 else s
    kv_chunk = KV_CHUNK if t % KV_CHUNK == 0 else t
    scale = _inv_sqrt(d, q.device)
    qh = q.reshape(b, s, hkv, rep, d)
    outs = []
    for q0 in range(0, s, q_chunk):
        q_blk = qh[:, q0:q0 + q_chunk]
        m = torch.full((b, hkv, rep, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, rep, q_chunk), device=q.device)
        acc = torch.zeros((b, hkv, rep, q_chunk, d), dtype=v.dtype,
                          device=q.device)
        abs_q = q0 + torch.arange(q_chunk, device=q.device)
        for k0 in range(0, t, kv_chunk):
            k_blk, v_blk = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            scores = torch.einsum("bshrd,bthd->bhrst", q_blk.float(),
                                  k_blk.float()) * scale
            abs_k = k0 + torch.arange(kv_chunk, device=q.device)
            causal = abs_q[:, None] >= abs_k[None, :]
            scores = torch.where(causal, scores,
                                 torch.full_like(scores, NEG_INF))
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhrst,bthd->bhrsd", p.to(v_blk.dtype), v_blk)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype))
    out = torch.cat(outs, dim=3)                       # (b, hkv, rep, s, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def attention(p, x, *, num_heads: int, num_kv_heads: int, head_dim: int,
              positions: torch.Tensor, rope_theta: Optional[float],
              qk_norm: bool = False, norm_eps: float = 1e-5,
              cache: Optional[KVCache] = None,
              cache_pos: Optional[torch.Tensor] = None,
              valid_bias: Optional[torch.Tensor] = None,
              emit_kv: bool = False, plain: bool = False):
    """Causal self-attention.

    * prefill (``cache=None``): full or chunked causal attention; with
      ``emit_kv`` the layer's raw K/V come back as a KVCache.
    * decode (``cache`` given, x is (B, 1, D)): K/V are written into the
      cache IN PLACE at ``cache_pos`` (scalar or (B,) per slot), then a raw
      cache is attended with ``valid_bias`` and a quantized cache
      (``KVPage``, quantize-on-write) through the decode attention kernel.
    Returns (out, cache_or_None)."""
    b, s, _ = x.shape
    yq, yk, yv = fused_qkv(x, p["wq"], p["wk"], p["wv"], plain=plain)
    q = yq.reshape(b, s, num_heads, head_dim)
    k = yk.reshape(b, s, num_kv_heads, head_dim)
    v = yv.reshape(b, s, num_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    if rope_theta is not None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)

    if cache is not None:
        if KV.is_kv_page(cache.k):
            KV.update_page(cache.k, k, cache_pos)
            KV.update_page(cache.v, v, cache_pos)
            out = decode_attention(q, cache.k, cache.v,
                                   valid_len=cache_pos + s, plain=plain)
        else:
            KV.write_rows(cache.k, k, cache_pos)
            KV.write_rows(cache.v, v, cache_pos)
            bias = valid_bias if valid_bias is not None else \
                decode_valid_bias(cache_pos, s, cache.k.shape[1])
            out = _full_attention(q, cache.k, cache.v, bias)
        new_cache = cache
    else:
        new_cache = KVCache(k=k, v=v) if emit_kv else None
        if s > CHUNK_THRESHOLD:
            out = _chunked_causal_attention(q, k, v)
        else:
            causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                           device=x.device))
            bias = torch.where(causal, 0.0, NEG_INF)[None, None, None]
            out = _full_attention(q, k, v, bias)
    out = qdot(out.reshape(b, s, num_heads * head_dim), p["wo"], plain=plain)
    return out, new_cache


def init_attention_params(gen, cfg, dtype, device) -> dict:
    """Stacked (layers, out, in) attention weights at the reference's
    scales."""
    n, d = cfg.num_layers, cfg.d_model
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (n, h * hd, d), dtype, device),
        "wk": dense_init(gen, (n, hkv * hd, d), dtype, device),
        "wv": dense_init(gen, (n, hkv * hd, d), dtype, device),
        "wo": dense_init(gen, (n, d, h * hd), dtype, device,
                         scale=1.0 / (2 * max(n, 1)) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((n, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((n, hd), dtype=dtype, device=device)
    return p
