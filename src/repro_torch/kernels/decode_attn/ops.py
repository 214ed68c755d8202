"""Decode attention over a quantized KV cache: ``decode_attention``.

``decode_attention(q, k, v, valid_len=...)`` is what the model calls on the
decode path when its cache holds ``KVPage``s or ``PagedKV`` pools. ``q`` is
one decode token per slot (B, 1, H, hd), or a speculative verify window of
s = K+1 tokens (B, s, H, hd); ``k``/``v`` are int8, split-half int4 or bf16
pages of one layer, (B, S, ...), or one layer's pools (N, P, ...) with
their (B, n_log) page tables, whose logical row t of slot b is row
t % P of physical page table[b, t // P]; ``valid_len`` (B,) counts each
slot's valid cache rows
including the s rows just written. With ``causal=True`` query i sees the
rows ``< valid_len - s + 1 + i``; with ``causal=False`` every query sees
all ``valid_len`` rows (cross-attention).

``fresh_kv=(fresh_k, fresh_v, base)`` adds raw (B, Sf, Hkv, hd) side rows
at logical positions ``base + j`` without writing the cache: they are
quantized with the page's own write math (``quantize_kv``), and cache rows
at positions >= base are masked stale. This is the fused draft propose.

Two implementations side by side:

* the CUDA kernel (``csrc/decode_attn.cu``), launched for tensors on the
  GPU; it raises on anything it does not take;
* ``decode_attention_plain``, which mirrors the JAX package's ``_grouped``
  backend: a chunked online softmax in f32 that dequantizes one KV chunk at
  a time, then the fresh rows as one more block. A pool is read through
  its tables a whole number of pages per chunk, with the dense masking
  arithmetic, so a pool and the dense page gathered from it give the same
  result to the bit. Like the TPU kernel, it zeroes V rows at or past
  valid_len. A query that sees no row gives 0 in both (the reference's
  backends disagree there; see ROADMAP.md section 3).

A tensor on the CPU takes the plain version; ``plain=True`` asks for it on
the GPU too.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.quant.kvcache import (KVPage, PagedKV, dequantize_kv,
                                       quantize_kv)

NEG_INF = -1e30
DEFAULT_KV_CHUNK = 256
_PREC = {"int8": 0, "int4": 1, "bf16": 2}
_SMEM_LIMIT = 227 * 1024        # dynamic shared memory a Hopper block can opt into
_MAX_FRESH = 32                 # fresh rows the kernel's epilogue tile takes


def _page_of(x):
    """Normalize a cache operand to a KVPage (raw (B, S, Hkv, hd) tensors
    become bf16-style pages with no scales); pools pass through."""
    if isinstance(x, (KVPage, PagedKV)):
        return x
    return KVPage(data=x, scale=None, precision="bf16", head_dim=x.shape[-1],
                  group=x.shape[-1])


def _fresh_page(raw: torch.Tensor, like) -> KVPage:
    """Quantize fresh rows with the page's write math (``update_page``'s
    quantize-on-insert), so they read exactly what a cache write would have
    stored."""
    data, scale = quantize_kv(raw, like.precision, like.group)
    return KVPage(data=data.to(like.data.dtype), scale=scale,
                  precision=like.precision, head_dim=raw.shape[-1],
                  group=like.group)


def _slice_rows(page: KVPage, lo: int, hi: int) -> KVPage:
    return KVPage(data=page.data[:, lo:hi],
                  scale=None if page.scale is None else page.scale[:, lo:hi],
                  precision=page.precision, head_dim=page.head_dim,
                  group=page.group)


def _take_pages(pg: PagedKV, lo: int, hi: int) -> KVPage:
    """Logical pages [lo, hi) of every slot, read through the pool's
    table: a dense (B, (hi - lo) * P, ...) KVPage."""
    ids = pg.table[:, lo:hi].long()                       # (B, npg)

    def gat(x):
        y = x[ids]                                        # (B, npg, P, ...)
        return y.reshape(y.shape[0], y.shape[1] * y.shape[2], *y.shape[3:])

    return KVPage(data=gat(pg.data),
                  scale=None if pg.scale is None else gat(pg.scale),
                  precision=pg.precision, head_dim=pg.head_dim,
                  group=pg.group)


def _chunks(kp, vp, kv_chunk: int):
    """(K rows, V rows, first position) of each cache chunk in order: a
    dense page sliced ``kv_chunk`` rows at a time, a pool read through its
    tables a whole number of pages at a time (as ``_grouped`` snaps the
    chunk to pages)."""
    if isinstance(kp, PagedKV):
        p_sz, n_log = kp.page_size, kp.table.shape[-1]
        g = max(1, min(kv_chunk // p_sz, n_log))
        for lo in range(0, n_log, g):
            hi = min(n_log, lo + g)
            yield _take_pages(kp, lo, hi), _take_pages(vp, lo, hi), lo * p_sz
        return
    t = kp.data.shape[1]
    for lo in range(0, t, kv_chunk):
        hi = min(t, lo + kv_chunk)
        yield _slice_rows(kp, lo, hi), _slice_rows(vp, lo, hi), lo


def _limits(valid: torch.Tensor, s: int, causal: bool) -> torch.Tensor:
    """(B, s) rows each query sees: ``valid - s + 1 + i`` or ``valid``."""
    if not causal:
        return valid[:, None].expand(valid.shape[0], s)
    return valid[:, None] - s + 1 + torch.arange(s, device=valid.device)[None]


def decode_attention_plain(q: torch.Tensor, kp, vp,
                           valid_len: torch.Tensor, causal: bool = True,
                           fresh=None,
                           kv_chunk: int = DEFAULT_KV_CHUNK) -> torch.Tensor:
    """Chunked online-softmax (multi-)query GQA attention over KVPages or
    PagedKV pools. ``fresh`` is ``(fresh_k_page, fresh_v_page, base)`` with
    pages already quantized. Returns (B, s, H, hd) in q's dtype."""
    b, s, h, d = q.shape
    hkv = kp.num_kv_heads
    rep = h // hkv
    dev = q.device
    valid = valid_len.to(device=dev, dtype=torch.long).expand(b)
    qh = q.reshape(b, s, hkv, rep, d).permute(0, 2, 3, 1, 4).float()
    inv_sqrt = 1.0 / torch.sqrt(torch.full((), float(d), dtype=torch.float32,
                                           device=dev))
    limit = _limits(valid, s, causal)
    cache_limit = limit
    if fresh is not None:
        base = fresh[2].to(device=dev, dtype=torch.long).expand(b)
        cache_limit = torch.minimum(limit, base[:, None])
    m = torch.full((b, hkv, rep, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, rep, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, rep, s, d), dtype=torch.float32, device=dev)

    def update(kpage, vpage, pos, lim):
        """One online-softmax block over rows at positions ``pos`` (B, C)."""
        nonlocal m, l, acc
        kf = dequantize_kv(kpage)                           # (B, C, Hkv, hd)
        vf = dequantize_kv(vpage)
        vf = torch.where((pos < valid[:, None])[..., None, None], vf,
                         torch.zeros_like(vf))
        scores = torch.einsum("bhrsd,bchd->bhrsc", qh, kf) * inv_sqrt
        mask = (pos[:, None, :] < lim[:, :, None])[:, None, None]  # (B,1,1,s,C)
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # a masked score has probability exactly 0, so a query that sees no
        # row keeps l = 0 and gives 0
        p = torch.where(mask, torch.exp(scores - m_new[..., None]),
                        torch.zeros_like(scores))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhrsc,bchd->bhrsd", p, vf)
        m = m_new

    for kc, vc, lo in _chunks(kp, vp, kv_chunk):
        c = kc.data.shape[1]
        pos = torch.arange(lo, lo + c, device=dev)[None].expand(b, c)
        update(kc, vc, pos, cache_limit)
    if fresh is not None:
        fkp, fvp, _ = fresh
        sf = fkp.data.shape[1]
        pos = base[:, None] + torch.arange(sf, device=dev)[None]
        update(fkp, fvp, pos, limit)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _check_pages(kp, vp, lead: tuple, hkv: int, d: int, dev,
                 what: str) -> list:
    """The kernel's layout: contiguous pages on ``dev`` whose rows are
    indexed by ``lead`` ((B, S) for a dense page, (N, P) for a pool).
    Returns the tensors the kernel reads: K data, K scales, V data, V
    scales (a bf16 page passes its data in place of the scales it does not
    have)."""
    f = hkv * d
    want = {"int8": (torch.int8, (*lead, hkv, d)),
            "int4": (torch.int8, (*lead, f // 2)),
            "bf16": (torch.bfloat16, (*lead, hkv, d))}[kp.precision]
    out = []
    for page in (kp, vp):
        if (page.data.dtype, tuple(page.data.shape)) != want:
            raise ValueError(f"decode_attn: {kp.precision} {what} data must "
                             f"be {want}, got {page.data.dtype} "
                             f"{tuple(page.data.shape)}")
        scale = page.data
        if page.precision != "bf16":
            if (page.scale is None or page.scale.dtype != torch.bfloat16
                    or tuple(page.scale.shape) != (*lead, f // page.group)):
                raise ValueError(f"decode_attn: {what} scales must be bf16 "
                                 f"{(*lead, f // page.group)}")
            scale = page.scale
        for t in (page.data, scale):
            if not t.is_cuda or t.device != dev or not t.is_contiguous():
                raise ValueError(f"decode_attn: {what} pages must be "
                                 f"contiguous CUDA tensors on {dev}")
        out += [page.data, scale]
    return out


def _check_tables(kp: PagedKV, vp: PagedKV, b: int, dev) -> list:
    """Both pools' page tables: (B, n_log) int32, contiguous, on ``dev``,
    over the same page size; at least one physical page."""
    if kp.page_size != vp.page_size:
        raise ValueError("decode_attn: K and V pools must share the page "
                         "size")
    n_log = kp.table.shape[-1]
    for pg in (kp, vp):
        t = pg.table
        if (t.dtype != torch.int32 or tuple(t.shape) != (b, n_log)
                or not t.is_cuda or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"decode_attn: a page table must be a "
                             f"contiguous ({b}, {n_log}) int32 CUDA tensor "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        if pg.data.shape[0] < 1:
            raise ValueError("decode_attn: a pool needs at least one page")
    return [kp.table, vp.table]


def decode_attn_cuda(q: torch.Tensor, kp, vp, valid_len: torch.Tensor,
                     causal: bool = True, fresh=None) -> torch.Tensor:
    """The decode attention kernel: dense pages or paged pools, s >= 1
    queries per slot, causal or not, with optional quantized fresh rows
    ``(fresh_k_page, fresh_v_page, base)``. Returns (B, s, H, hd) in q's
    dtype."""
    b, s, h, d = q.shape
    dev = q.device
    if kp.precision not in _PREC:
        raise ValueError(f"unsupported KV precision {kp.precision!r}")
    if kp.precision != vp.precision or kp.group != vp.group:
        raise ValueError("decode_attn: K and V pages must share precision "
                         "and group")
    paged = isinstance(kp, PagedKV)
    if paged != isinstance(vp, PagedKV):
        raise ValueError("decode_attn: K and V must both be pools or both "
                         "dense pages")
    if fresh is not None:
        fkp, fvp, base = fresh
        if (fkp.precision, fkp.group, fvp.precision, fvp.group) != \
                (kp.precision, kp.group) * 2:
            raise ValueError("decode_attn: fresh rows must share the cache "
                             "pages' precision and group")
        if not 1 <= fkp.data.shape[1] <= _MAX_FRESH:
            raise ValueError(f"decode_attn: the kernel takes 1 to "
                             f"{_MAX_FRESH} fresh rows, got "
                             f"{fkp.data.shape[1]}")
    tables, p_sz, n_log = [0, 0], 1, 0
    if paged:
        tables = [t.data_ptr() for t in _check_tables(kp, vp, b, dev)]
        p_sz, n_log = kp.page_size, kp.table.shape[-1]
    if not q.is_cuda:
        raise ValueError("decode_attn: q must be a CUDA tensor")
    hkv = kp.num_kv_heads
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    rep = h // hkv
    seq = kp.seq_len
    cache = _check_pages(kp, vp, tuple(kp.data.shape[:2]) if paged
                         else (b, seq), hkv, d, dev, "cache")
    lib = build.library("decode_attn")
    if lib.repro_decode_attn_smem(rep * s, d) > _SMEM_LIMIT:
        raise ValueError(f"decode_attn: rep={rep} x s={s} query rows at "
                         f"hd={d} exceed the kernel's shared memory")
    sf = 0
    fresh_ptrs = [0, 0, 0, 0, 0]
    if fresh is not None:
        sf = fkp.data.shape[1]
        fresh_t = _check_pages(fkp, fvp, (b, sf), hkv, d, dev, "fresh")
        base = base.to(device=dev, dtype=torch.int32).expand(b).contiguous()
        fresh_ptrs = [t.data_ptr() for t in fresh_t] + [base.data_ptr()]
    qf = (q.reshape(b, s, hkv, rep, d).permute(0, 2, 3, 1, 4).float()
          .contiguous())                                  # (B, Hkv, rep, s, hd)
    valid = valid_len.to(device=dev, dtype=torch.int32).expand(b).contiguous()
    out = torch.empty((b, hkv, rep, s, d), dtype=torch.float32, device=dev)
    if b > 0:
        # the counter of the form launched (kernels/build.py)
        if fresh is not None:
            form = "_fresh"
        elif s > 1:
            form = "_window"
        else:
            form = "" if causal or paged else "_cross"
        name = "decode_attn" + ("_paged" if paged else "") + form
        build.LAUNCHES[name] += 1
        build.check(lib.repro_decode_attn(
            qf.data_ptr(), *(t.data_ptr() for t in cache), valid.data_ptr(),
            *tables, *fresh_ptrs, out.data_ptr(), b, seq, p_sz, n_log, hkv,
            rep, s, d, kp.group, _PREC[kp.precision], int(causal), sf,
            build.stream_ptr(dev)), name)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k, v, *,
                     valid_len: Optional[torch.Tensor] = None,
                     causal: bool = True, fresh_kv=None,
                     plain: bool = False) -> torch.Tensor:
    """(Multi-)query GQA attention of q (B, s, H, hd) against one layer's
    cached K/V (KVPage, PagedKV, or raw (B, S, Hkv, hd)). ``fresh_kv=
    (fresh_k, fresh_v, base)``: raw (B, Sf, Hkv, hd) rows at positions
    ``base + j`` (scalar or (B,)); ``valid_len`` counts them too. Returns
    (B, s, H, hd)."""
    kp, vp = _page_of(k), _page_of(v)
    if valid_len is None:
        valid_len = torch.full((q.shape[0],), kp.seq_len,
                               dtype=torch.int32, device=q.device)
    fresh = None
    if fresh_kv is not None:
        fk, fv, base = fresh_kv
        fresh = (_fresh_page(fk, kp), _fresh_page(fv, vp),
                 torch.as_tensor(base, device=q.device))
    if q.is_cuda and not plain:
        return decode_attn_cuda(q, kp, vp, valid_len, causal, fresh)
    return decode_attention_plain(q, kp, vp, valid_len, causal, fresh)
