"""Decode attention over a quantized KV cache: ``decode_attention``.

``decode_attention(q, k, v, valid_len=...)`` is what the model calls on the
decode path when its cache holds ``KVPage``s. ``q`` is one decode token per
slot, (B, 1, H, hd); ``k``/``v`` are int8, split-half int4 or bf16 pages of
one layer, (B, S, ...); ``valid_len`` (B,) counts each slot's valid cache
rows including the token just written.

Two implementations side by side:

* the CUDA kernel (``csrc/decode_attn.cu``), launched for tensors on the
  GPU; it takes only the dense single-query causal form and raises on
  anything else;
* ``decode_attention_plain``, which mirrors the JAX package's ``_grouped``
  backend: a chunked online softmax in f32 that dequantizes one KV chunk at
  a time. Like the TPU kernel, it zeroes V rows at or past valid_len, so a
  slot with valid_len 0 gives 0 (the reference's jnp backends give the mean
  of V there; see ROADMAP.md section 3).

A tensor on the CPU takes the plain version; ``plain=True`` asks for it on
the GPU too.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.quant.kvcache import KVPage, dequantize_kv

NEG_INF = -1e30
DEFAULT_KV_CHUNK = 256
_PREC = {"int8": 0, "int4": 1, "bf16": 2}
_SMEM_LIMIT = 48 * 1024


def _page_of(x) -> KVPage:
    """Normalize a cache operand to a KVPage (raw (B, S, Hkv, hd) tensors
    become bf16-style pages with no scales)."""
    if isinstance(x, KVPage):
        return x
    return KVPage(data=x, scale=None, precision="bf16", head_dim=x.shape[-1],
                  group=x.shape[-1])


def _slice_rows(page: KVPage, lo: int, hi: int) -> KVPage:
    return KVPage(data=page.data[:, lo:hi],
                  scale=None if page.scale is None else page.scale[:, lo:hi],
                  precision=page.precision, head_dim=page.head_dim,
                  group=page.group)


def decode_attention_plain(q: torch.Tensor, kp: KVPage, vp: KVPage,
                           valid_len: torch.Tensor,
                           kv_chunk: int = DEFAULT_KV_CHUNK) -> torch.Tensor:
    """Chunked online-softmax (multi-)query GQA attention; query i of s sees
    rows < valid_len - s + 1 + i. Returns (B, s, H, hd) in q's dtype."""
    b, s, h, d = q.shape
    hkv = kp.num_kv_heads
    rep = h // hkv
    t = kp.data.shape[1]
    dev = q.device
    valid = valid_len.to(device=dev, dtype=torch.long).expand(b)
    qh = q.reshape(b, s, hkv, rep, d).permute(0, 2, 3, 1, 4).float()
    inv_sqrt = 1.0 / torch.sqrt(torch.full((), float(d), dtype=torch.float32,
                                           device=dev))
    limit = valid[:, None] - s + 1 + torch.arange(s, device=dev)[None, :]
    m = torch.full((b, hkv, rep, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, rep, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, rep, s, d), dtype=torch.float32, device=dev)
    for lo in range(0, t, kv_chunk):
        hi = min(t, lo + kv_chunk)
        kf = dequantize_kv(_slice_rows(kp, lo, hi))        # (B, C, Hkv, hd)
        vf = dequantize_kv(_slice_rows(vp, lo, hi))
        pos = torch.arange(lo, hi, device=dev)
        vf = torch.where((pos[None, :] < valid[:, None])[..., None, None],
                         vf, torch.zeros_like(vf))
        scores = torch.einsum("bhrsd,bchd->bhrsc", qh, kf) * inv_sqrt
        mask = pos[None, None, :] < limit[:, :, None]      # (B, s, C)
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhrsc,bchd->bhrsd", p, vf)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def decode_attn_cuda(q: torch.Tensor, kp: KVPage, vp: KVPage,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """The decode attention kernel: dense pages, one query per slot,
    causal. Returns (B, 1, H, hd) in q's dtype."""
    b, s, h, d = q.shape
    if s != 1:
        raise NotImplementedError(
            "the decode attention kernel takes one query per slot; the "
            "multi-query window is still to be ported (ROADMAP.md)")
    if kp.precision != vp.precision or kp.group != vp.group:
        raise ValueError("K and V pages must share precision and group")
    if kp.precision not in _PREC:
        raise ValueError(f"unsupported KV precision {kp.precision!r}")
    hkv = kp.num_kv_heads
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    rep = h // hkv
    seq = kp.data.shape[1]
    f = hkv * d
    dev = q.device
    want_data = {"int8": (torch.int8, (b, seq, hkv, d)),
                 "int4": (torch.int8, (b, seq, f // 2)),
                 "bf16": (torch.bfloat16, (b, seq, hkv, d))}[kp.precision]
    for page in (kp, vp):
        if (page.data.dtype, tuple(page.data.shape)) != want_data:
            raise ValueError(f"decode_attn: {kp.precision} page data must be "
                             f"{want_data}, got {page.data.dtype} "
                             f"{tuple(page.data.shape)}")
        tensors = [page.data]
        if page.precision != "bf16":
            if (page.scale is None or page.scale.dtype != torch.bfloat16
                    or tuple(page.scale.shape) != (b, seq, f // page.group)):
                raise ValueError("decode_attn: scales must be bf16 "
                                 f"({b}, {seq}, {f // page.group})")
            tensors.append(page.scale)
        for t in tensors:
            if not t.is_cuda or t.device != dev or not t.is_contiguous():
                raise ValueError("decode_attn: pages must be contiguous on "
                                 f"{dev}")
    lib = build.library("decode_attn")
    if lib.repro_decode_attn_smem(rep, d) > _SMEM_LIMIT:
        raise ValueError(f"decode_attn: rep={rep}, hd={d} exceeds the "
                         "kernel's shared-memory tile")
    qf = q.reshape(b, hkv, rep, d).float().contiguous()
    valid = valid_len.to(device=dev, dtype=torch.int32).expand(b).contiguous()
    out = torch.empty((b, hkv, rep, d), dtype=torch.float32, device=dev)
    if b == 0:
        return out.reshape(b, 1, h, d).to(q.dtype)
    ks = kp.scale if kp.scale is not None else kp.data
    vs = vp.scale if vp.scale is not None else vp.data
    build.LAUNCHES["decode_attn"] += 1
    build.check(lib.repro_decode_attn(
        qf.data_ptr(), kp.data.data_ptr(), ks.data_ptr(), vp.data.data_ptr(),
        vs.data_ptr(), valid.data_ptr(), out.data_ptr(), b, seq, hkv, rep, d,
        kp.group, _PREC[kp.precision], build.stream_ptr(dev)), "decode_attn")
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k, v, *,
                     valid_len: Optional[torch.Tensor] = None,
                     plain: bool = False) -> torch.Tensor:
    """Single-query GQA attention of q (B, 1, H, hd) against one layer's
    cached K/V (KVPage, or raw (B, S, Hkv, hd)). Returns (B, 1, H, hd)."""
    kp, vp = _page_of(k), _page_of(v)
    if valid_len is None:
        valid_len = torch.full((q.shape[0],), kp.data.shape[1],
                               dtype=torch.int32, device=q.device)
    if q.is_cuda and not plain:
        return decode_attn_cuda(q, kp, vp, valid_len)
    return decode_attention_plain(q, kp, vp, valid_len)
