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
  GPU; it raises on anything it does not take. It splits each slot's
  logical rows into splits of ``split_rows(rep * s)`` rows
  (``split_bounds``: boundaries at multiples of the split, never at S, the
  page size or valid_len), attends each split in blocks of its own, and
  merges the per-split partials in split order, the fresh rows last;
* ``decode_attention_plain``: the same splits in f32, one softmax block per
  split (a pool read through its tables), then the fresh rows as one more
  part, merged by ``merge_partials`` in the kernel's order and arithmetic,
  so a pool and the dense page gathered from it give the same result to
  the bit. Like the TPU kernel, it zeroes V rows at or past valid_len. A
  query that sees no row gives 0 in both (the reference's backends
  disagree there; see ROADMAP.md section 3).

A tensor on the CPU takes the plain version; ``plain=True`` asks for it on
the GPU too.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.quant.kvcache import (KVPage, PagedKV, dequantize_kv,
                                       quantize_kv)

SPLIT_ROWS = 128                # logical rows per split (decode_attn.cu split_of)
SPLIT_ROWS_ONE_QUERY = 256      # ... where a KV head has a single query row
_PREC = {"int8": 0, "int4": 1, "bf16": 2}
_Q_DTYPES = {torch.bfloat16: 0, torch.float32: 1}   # q dtype -> qf32 flag
_SMEM_LIMIT = 227 * 1024        # dynamic shared memory a Hopper block can opt into
_MAX_FRESH = 32                 # fresh rows the kernel's epilogue tile takes
HEAD_DIMS = (32, 64, 80, 128)   # head dims decode_attn.cu has copies for


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


def _dense_rows(x) -> KVPage:
    """A dense page, or a pool's logical rows read through its table as a
    (B, n_log * P, ...) dense KVPage."""
    if not isinstance(x, PagedKV):
        return x
    ids = x.table.long()                                  # (B, n_log)

    def gat(t):
        y = t[ids]                                        # (B, n_log, P, ...)
        return y.reshape(y.shape[0], y.shape[1] * y.shape[2], *y.shape[3:])

    return KVPage(data=gat(x.data),
                  scale=None if x.scale is None else gat(x.scale),
                  precision=x.precision, head_dim=x.head_dim, group=x.group)


def split_rows(rows: int) -> int:
    """Logical rows per split for a KV head's ``rows`` = rep * s query
    rows: SPLIT_ROWS_ONE_QUERY for a single one (whisper's heads), else
    SPLIT_ROWS. A shape, never the data, sets it. The wrapper passes it
    with every launch, and the kernel refuses a split other than its own
    (``split_rows`` in decode_attn.cu)."""
    return SPLIT_ROWS_ONE_QUERY if rows == 1 else SPLIT_ROWS


def split_bounds(seq: int, split: int = SPLIT_ROWS) -> list:
    """[lo, hi) logical rows of each of the kernel's splits of a cache of
    ``seq`` rows: boundaries at multiples of ``split`` only, so a cache of
    any length (a pool of any page size, the dense page gathered from it)
    splits its rows alike; at least one split, so the launch's shape never
    depends on the data. A slot's rows past min(valid, base) leave the
    splits that hold them empty."""
    return [(j * split, min((j + 1) * split, seq))
            for j in range(n_splits(seq, split))]


def n_splits(seq: int, split: int = SPLIT_ROWS) -> int:
    """The kernel's splits of a cache of ``seq`` rows: ceil(seq / split),
    at least 1."""
    return max(1, -(-seq // split))


def _limits(valid: torch.Tensor, s: int, causal: bool) -> torch.Tensor:
    """(B, s) rows each query sees: ``valid - s + 1 + i`` or ``valid``."""
    if not causal:
        return valid[:, None].expand(valid.shape[0], s)
    return valid[:, None] - s + 1 + torch.arange(s, device=valid.device)[None]


def _partial(qh, kpage: KVPage, vpage: KVPage, pos, lim, valid, inv_sqrt):
    """One split's (or the fresh rows') softmax state over rows at
    positions ``pos`` (B, C): (m, l, acc) with m = -inf, l = 0, acc = 0 for
    a query row that sees none of them."""
    kf = dequantize_kv(kpage)                             # (B, C, Hkv, hd)
    vf = dequantize_kv(vpage)
    vf = torch.where((pos < valid[:, None])[..., None, None], vf,
                     torch.zeros_like(vf))
    scores = torch.einsum("bhrsd,bchd->bhrsc", qh, kf) * inv_sqrt
    mask = (pos[:, None, :] < lim[:, :, None])[:, None, None]   # (B,1,1,s,C)
    scores = torch.where(mask, scores, torch.full_like(scores, -torch.inf))
    m = scores.amax(dim=-1)
    # a masked score has probability exactly 0
    p = torch.where(mask, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    return m, p.sum(dim=-1), torch.einsum("bhrsc,bchd->bhrsd", p, vf)


def merge_partials(parts: list) -> torch.Tensor:
    """Merge per-split states ``(m, l, acc)`` in list order, as the kernel's
    merge does: w_j = exp(m_j - max m), 0 for a state with m_j = -inf, and
    acc / max(sum w_j l_j, 1e-30). Empty states merge to nothing, so a
    query row that sees no row gives exactly 0."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, lj, aj in parts:
        w = torch.where(m == -torch.inf, torch.zeros_like(m),
                        torch.exp(m - mx))
        l = l + w * lj
        acc = acc + w[..., None] * aj
    return acc / torch.clamp(l, min=1e-30)[..., None]


def decode_attention_plain(q: torch.Tensor, kp, vp,
                           valid_len: torch.Tensor, causal: bool = True,
                           fresh=None, split: Optional[int] = None
                           ) -> torch.Tensor:
    """(Multi-)query GQA attention over KVPages or PagedKV pools, split as
    the kernel splits (``split_bounds`` of ``split_rows(rep * s)`` rows
    unless ``split`` is given), each split one softmax block, the parts
    merged in split order by ``merge_partials``. ``fresh`` is
    ``(fresh_k_page, fresh_v_page, base)`` with pages already quantized.
    Returns (B, s, H, hd) in q's dtype."""
    b, s, h, d = q.shape
    hkv = kp.num_kv_heads
    rep = h // hkv
    split = split_rows(rep * s) if split is None else split
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
    kd, vd = _dense_rows(kp), _dense_rows(vp)
    parts = []
    for lo, hi in split_bounds(kp.seq_len, split):
        pos = torch.arange(lo, hi, device=dev)[None].expand(b, hi - lo)
        parts.append(_partial(qh, _slice_rows(kd, lo, hi),
                              _slice_rows(vd, lo, hi), pos, cache_limit,
                              valid, inv_sqrt))
    if fresh is not None:
        fkp, fvp, _ = fresh
        sf = fkp.data.shape[1]
        pos = base[:, None] + torch.arange(sf, device=dev)[None]
        parts.append(_partial(qh, fkp, fvp, pos, limit, valid, inv_sqrt))
    out = merge_partials(parts)
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
        # the kernel copies rows in 16-byte and scales in 4-byte words
        if page.data.data_ptr() % 16 or scale.data_ptr() % 4:
            raise ValueError(f"decode_attn: {what} data must start on 16 "
                             f"bytes and scales on 4")
        out += [page.data, scale]
    return out


def check_form(hd: int, hkv: int, group: int, precision: str) -> None:
    """Raise ValueError, naming what the kernel takes, for a cache form
    ``decode_attn.cu`` has no copy for: a head dim outside ``HEAD_DIMS``, a
    scale group (int8, int4) that is not a multiple of 16 or does not
    divide F = Hkv * hd, or split-half int4 pages whose halves F / 2 are
    not a multiple of 16 elements (a 16-element chunk would straddle them:
    hd 80 with an odd Hkv). The C entry point refuses the same forms."""
    if precision not in _PREC:
        raise ValueError(f"unsupported KV precision {precision!r}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attn: the kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    f = hkv * hd
    if precision != "bf16" and (group < 16 or group % 16 or f % group):
        raise ValueError(f"decode_attn: the kernel takes scale groups that "
                         f"are multiples of 16 and divide Hkv * hd = {f}, "
                         f"got {group}")
    if precision == "int4" and (f // 2) % 16:
        raise ValueError(f"decode_attn: split-half int4 pages need Hkv * hd "
                         f"/ 2 to be a multiple of 16, got {f // 2} (Hkv "
                         f"{hkv}, hd {hd})")


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
    ``(fresh_k_page, fresh_v_page, base)``. Reads q (bf16 or f32, last dim
    contiguous) in place and returns a new (B, s, H, hd) tensor in q's
    dtype."""
    b, s, h, d = q.shape
    dev = q.device
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
    if q.dtype not in _Q_DTYPES or q.stride(-1) != 1:
        raise ValueError(f"decode_attn: q must be bf16 or f32 with its last "
                         f"dim contiguous, got {q.dtype} strides "
                         f"{q.stride()}")
    hkv = kp.num_kv_heads
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    rep = h // hkv
    grp = kp.group
    check_form(d, hkv, grp, kp.precision)
    seq = kp.seq_len
    cache = _check_pages(kp, vp, tuple(kp.data.shape[:2]) if paged
                         else (b, seq), hkv, d, dev, "cache")
    if kp.data.shape[0] * kp.data.shape[1] >= 2 ** 31:
        raise ValueError("decode_attn: the kernel indexes fewer than 2^31 "
                         "stored rows")
    lib = build.library("decode_attn")
    smem = lib.repro_decode_attn_smem(rep * s, d, _PREC[kp.precision])
    if smem < 0 or smem > _SMEM_LIMIT:
        raise ValueError(f"decode_attn: hd={d} with rep={rep} x s={s} query "
                         f"rows does not fit the kernel's shared memory")
    sf = 0
    fresh_ptrs = [0, 0, 0, 0, 0]
    if fresh is not None:
        sf = fkp.data.shape[1]
        fresh_t = _check_pages(fkp, fvp, (b, sf), hkv, d, dev, "fresh")
        base = base.to(device=dev, dtype=torch.int32).expand(b).contiguous()
        fresh_ptrs = [t.data_ptr() for t in fresh_t] + [base.data_ptr()]
    valid = valid_len.to(device=dev, dtype=torch.int32).expand(b).contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    if b > 0:
        # per-split partials (m, l, acc[hd]) of every query row, f32; the
        # kernel refuses a split other than its own
        split = split_rows(rep * s)
        nparts = n_splits(seq, split) + (sf > 0)
        scratch = torch.empty(b * hkv * nparts * rep * s * (d + 2),
                              dtype=torch.float32, device=dev)
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
            q.data_ptr(), *(t.data_ptr() for t in cache), valid.data_ptr(),
            *tables, *fresh_ptrs, out.data_ptr(), scratch.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2), _Q_DTYPES[q.dtype],
            b, seq, p_sz, n_log, hkv, rep, s, d, grp, _PREC[kp.precision],
            int(causal), sf, split, build.stream_ptr(dev)), name)
    return out


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
