"""Device-side ops for the paged KV pool.

A ``kvcache.PagedKV`` field keeps K/V rows in a shared pool of fixed-size
pages reached through a per-slot page table (``serving/pool.py`` decides
which physical page each logical page maps to):

* ``init_pool_field``   - an empty pool for a cache field, cut into
  per-precision runs exactly like ``quantize_cache_field``;
* ``update_pages``      - decode-step write: s quantized token rows through
  the page table (the paged twin of ``update_page``), in place;
* ``insert_slot_paged`` - admission: quantize a whole prefilled request
  and write it page by page into the slot's physical pages, in place
  (prefix-shared pages are redirected to the dump page);
* ``release_slot_pages`` - point a released slot's table at the dump page;
* ``gather`` / ``gather_rows`` - pool pages back into a dense ``KVPage``
  (the decode attention oracle; prefix-hit prefill seeding);
* ``page_nbytes``       - the bytes one logical page costs;
* ``repack_pool_field`` - a live repack under new precision runs and a new
  pool size (graceful degradation, ``ServeEngine.apply_kv_plan``).

Write safety: decode and verify writes target positions >= prompt_len, and
pages shared through the prefix cache cover only full prompt pages, so no
slot ever writes a shared page. Copy-on-write resolves at admission (the
divergent boundary page is written into a private page by the insert),
never on the decode path.

A port of the JAX package's ``quant/paged.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.quant.kvcache import (KVPage, PagedKV, dequantize_kv,
                                      quantize_kv)

DUMP_PAGE = 0


def _quant_rows(x: torch.Tensor, precision: str, group: int, data_dtype
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantize token rows with the page's write math. "bf16" pools store
    the pool dtype as it is (the raw cache dtype, not forced to bf16), so a
    paged bf16 engine reads the dense raw path's values."""
    if precision == "bf16":
        return x.to(data_dtype), None
    data, scale = quantize_kv(x, precision, group)
    return data.to(data_dtype), scale


def init_pool_field(raw_proto: torch.Tensor,
                    runs: Sequence[tuple[str, int, int]], *, num_pages: int,
                    page_size: int, num_slots: int, group: int,
                    device=None):
    """Empty pool(s) for one cache field on ``device`` (default: the
    prototype's). ``raw_proto``: the dense raw field the pool replaces;
    only its shape (L, B, S, Hkv, hd) and dtype are read (a "meta" tensor
    will do). ``runs``: (precision, lo, hi) layer runs. ``num_pages``
    allocatable pages; physical page 0, the dump page, comes on top. Every
    table starts all-dump."""
    l_total, _, s_max, hkv, hd = raw_proto.shape
    assert runs and runs[-1][2] == l_total, (runs, l_total)
    n_log = logical_pages(s_max, page_size) if s_max else 1
    n_phys = num_pages + 1
    f = hkv * hd
    dev = raw_proto.device if device is None else device
    pools = []
    for precision, lo, hi in runs:
        ll = hi - lo
        if precision not in ("bf16", "int8", "int4"):
            raise ValueError(f"cannot build a {precision!r} pool")
        table = torch.zeros((ll, num_slots, n_log), dtype=torch.int32,
                            device=dev)
        row_shape = (f // 2,) if precision == "int4" else (hkv, hd)
        data = torch.zeros((ll, n_phys, page_size, *row_shape),
                           dtype=(raw_proto.dtype if precision == "bf16"
                                  else torch.int8), device=dev)
        scale = (None if precision == "bf16" else
                 torch.zeros((ll, n_phys, page_size, f // group),
                             dtype=torch.bfloat16, device=dev))
        pools.append(PagedKV(data=data, scale=scale, table=table,
                             precision=precision, head_dim=hd, group=group,
                             page_size=page_size))
    return tuple(pools) if len(pools) > 1 else pools[0]


def logical_pages(max_seq: int, page_size: int) -> int:
    """Pages a slot's table addresses: ceil(max_seq / page_size)."""
    return -(-max_seq // page_size)


# ---------------------------------------------------------------------------
# writes (in place)
# ---------------------------------------------------------------------------

def update_pages(pg: PagedKV, new: torch.Tensor, pos) -> PagedKV:
    """Decode-step write of ``new`` (B, s, Hkv, hd) at position ``pos``
    (scalar or (B,)) through each slot's page table, in place. A row whose
    logical page is unallocated (table entry 0) lands on the dump page; a
    stale slot past its last logical page writes into that page (clamped).
    Repeated dump-page indices in one write are harmless: the dump page is
    never read."""
    b, s = new.shape[:2]
    p_sz, n_log = pg.page_size, pg.table.shape[-1]
    dev = pg.data.device
    data_n, scale_n = _quant_rows(new, pg.precision, pg.group, pg.data.dtype)
    if pg.precision == "int4":
        data_n = data_n.reshape(b, s, -1)                # flat (B, s, F//2)
    pos = torch.as_tensor(pos, device=dev).to(torch.long).expand(b)
    pj = pos[:, None] + torch.arange(s, device=dev)[None, :]     # (B, s)
    lpage = torch.clamp(pj // p_sz, max=n_log - 1)
    phys = pg.table.long().gather(1, lpage)                       # (B, s)
    off = pj % p_sz
    pg.data[phys, off] = data_n
    if scale_n is not None:
        pg.scale[phys, off] = scale_n.to(pg.scale.dtype)
    return pg


def _pagify(x: torch.Tensor, n_log: int, page_size: int) -> torch.Tensor:
    """(L, n_log * P, ...) -> (L, n_log, P, ...)."""
    return x.reshape(x.shape[0], n_log, page_size, *x.shape[2:])


def insert_slot_paged(field, src: torch.Tensor, slot: int, row, wrow):
    """Admit a prefilled request into ``slot`` of a paged field, in place.

    ``src``: raw (L, 1, S, Hkv, hd) batch=1 prefill cache; ``row``: (n_log,)
    int32 physical page per logical page (0 past the request's
    allocation); ``wrow``: the same with prefix-SHARED pages redirected to
    the dump page: the donor's insert wrote their rows, and they are
    refcounted read-only. The whole prompt is quantized and written in one
    index write per leaf."""
    pages = field if isinstance(field, tuple) else (field,)
    lo = 0
    for pg in pages:
        hi = lo + pg.data.shape[0]
        _insert_one(pg, src[lo:hi], slot, row, wrow)
        lo = hi
    return field


def _insert_one(pg: PagedKV, src: torch.Tensor, slot: int, row,
                wrow) -> None:
    l, _, s = src.shape[:3]
    p_sz, n_log = pg.page_size, pg.table.shape[-1]
    dev = pg.data.device
    rows = src[:, 0]                                     # (L, S, Hkv, hd)
    pad = n_log * p_sz - s
    if pad:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
    data_n, scale_n = _quant_rows(rows, pg.precision, pg.group,
                                  pg.data.dtype)
    if pg.precision == "int4":
        data_n = data_n.reshape(l, n_log * p_sz, -1)
    wrow = torch.as_tensor(wrow, device=dev).to(torch.long)
    # one index write over the page axis; duplicate dump-page indices
    # are harmless (which write wins on a garbage page does not matter)
    pg.data[:, wrow] = _pagify(data_n, n_log, p_sz)
    if scale_n is not None:
        pg.scale[:, wrow] = _pagify(scale_n.to(pg.scale.dtype), n_log, p_sz)
    pg.table[:, slot] = torch.as_tensor(row, device=dev).to(torch.int32)


def release_slot_pages(field, slot: int):
    """Point a released slot's table at the dump page, in place, so its
    masked in-flight writes cannot touch pages the allocator hands out
    again."""
    for pg in field if isinstance(field, tuple) else (field,):
        pg.table[:, slot] = DUMP_PAGE
    return field


# ---------------------------------------------------------------------------
# reads (dense materialization)
# ---------------------------------------------------------------------------

def _dense_view(pg: PagedKV, data, scale) -> KVPage:
    return KVPage(data=data, scale=scale, precision=pg.precision,
                  head_dim=pg.head_dim, group=pg.group)


def gather(pg: PagedKV) -> KVPage:
    """Single-layer pool (table (B, n_log)) -> dense (B, n_log * P, ...)
    KVPage of every slot."""
    t = pg.table.long()

    def gat(x):
        y = x[t]                                         # (B, n_log, P, ...)
        return y.reshape(y.shape[0], t.shape[1] * pg.page_size, *y.shape[3:])

    return _dense_view(pg, gat(pg.data),
                       None if pg.scale is None else gat(pg.scale))


def gather_rows(pg: PagedKV, row) -> KVPage:
    """Layered pool + one explicit page row (n_log,) -> dense batch=1
    (L, 1, n_log * P, ...) KVPage (prefix-hit prefill seeding)."""
    row = torch.as_tensor(row, device=pg.data.device).to(torch.long)

    def gat(x):
        y = x[:, row]                                    # (L, n_log, P, ...)
        return y.reshape(y.shape[0], row.shape[0] * pg.page_size,
                         *y.shape[3:])[:, None]

    return _dense_view(pg, gat(pg.data),
                       None if pg.scale is None else gat(pg.scale))


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def page_nbytes(field) -> float:
    """Physical bytes ONE logical page costs across a field's pools
    (payload + scales, summed over layer runs; the table is excluded)."""
    total = 0.0
    for pg in field if isinstance(field, tuple) else (field,):
        for leaf in (pg.data, pg.scale):
            if leaf is not None:
                total += float(leaf.numel() * leaf.element_size()) \
                    / leaf.shape[1]
    return total


# ---------------------------------------------------------------------------
# live repack (graceful degradation)
# ---------------------------------------------------------------------------

def repack_pool_field(field, runs_new: Sequence[tuple[str, int, int]], *,
                      perm, inv, group: int, raw_dtype):
    """Rebuild one paged field under new precision runs and pool size,
    carrying every live page's payload across the transition; returns the
    new field (the old one is left as it was).

    Pages move through ``inv`` (new physical id -> old physical id;
    ``inv[0] = 0`` keeps the dump page), are dequantized to ``raw_dtype``
    (the dense cache dtype) and requantized with the write math an
    admission at the new precision applies, so a demoted page holds what
    it would hold had its request been admitted at the lower tier. Page
    tables remap through ``perm`` (old physical id -> new; dead pages ->
    the dump page). Equal to the JAX package's ``repack_pool_field`` to the
    bit; it gathers the pages before it dequantizes them (the same values:
    dequantization is elementwise) and works one new run at a time, so the
    raw copy it holds is one run of the new pool's pages."""
    pages = field if isinstance(field, tuple) else (field,)
    p_sz = pages[0].page_size
    dev = pages[0].data.device
    inv_t = torch.as_tensor(inv, device=dev).to(torch.long)
    perm_t = torch.as_tensor(perm, device=dev).to(torch.long)
    old_runs, lo = [], 0
    for pg in pages:
        old_runs.append((pg, lo, lo + pg.data.shape[0]))
        lo += pg.data.shape[0]
    table_full = torch.cat([pg.table for pg in pages], 0)
    new_table = perm_t[table_full.long()].to(torch.int32)
    out = []
    for precision, lo, hi in runs_new:
        parts = []
        for pg, olo, ohi in old_runs:
            a, b = max(lo, olo), min(hi, ohi)
            if a >= b:
                continue
            sub = KVPage(
                data=pg.data[a - olo:b - olo].index_select(1, inv_t),
                scale=(None if pg.scale is None else
                       pg.scale[a - olo:b - olo].index_select(1, inv_t)),
                precision=pg.precision, head_dim=pg.head_dim,
                group=pg.group)
            parts.append(dequantize_kv(sub, raw_dtype))
        seg = torch.cat(parts, 0) if len(parts) > 1 else parts[0]
        parts = None
        data_dtype = raw_dtype if precision == "bf16" else torch.int8
        data, scale = _quant_rows(seg, precision, group, data_dtype)
        seg = None
        if precision == "int4":
            data = data.reshape(*data.shape[:3], -1)
        out.append(PagedKV(data=data, scale=scale,
                           table=new_table[lo:hi].clone(),
                           precision=precision, head_dim=pages[0].head_dim,
                           group=group, page_size=p_sz))
    return tuple(out) if len(out) > 1 else out[0]
