"""The port's paged KV pool against the JAX package on the CPU: the host
allocator (one seeded sequence of match / admit / register / release /
unpin / flush through both, state equal after every op), the pool's device
ops (bit-exact for bf16, int8 and int4 pools), the bridge carrying a JAX
pool state, and the plain version of paged decode attention (single query,
the verify window causal and not, the fresh rows of the fused propose)
against JAX's Pallas kernel in interpret mode and ``_grouped`` at 1e-5 in
f32, and to the bit against the port's dense plain version on the rows
gathered through the table. Tables are permuted, map one physical page from
two slots, and point past each allocation at the dump page."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import _grouped, _pallas
from repro.quant import kvcache as JKV
from repro.quant import paged as JPG
from repro.serving.pool import OutOfPages as JOutOfPages
from repro.serving.pool import PoolSession as JPoolSession
from repro_torch.bridge import from_jax
from repro_torch.kernels.decode_attn import ops as TDA
from repro_torch.quant import paged as TPG
from repro_torch.quant.kvcache import KVPage, PagedKV, update_page
from repro_torch.serving.pool import OutOfPages, PoolSession

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return from_jax(jax.tree.map(np.asarray, x), device="cpu")


# ---------------------------------------------------------------------------
# host allocator
# ---------------------------------------------------------------------------

def _pool_state(pool) -> dict:
    pc = pool.prefix
    return dict(
        free=list(pool._free), ref=pool._ref.tolist(),
        slots={k: [int(p) for p in v] for k, v in pool._slot_pages.items()},
        prefix=None if pc is None else (
            {k: dict(v) for k, v in pc._children.items()},
            list(pc._lru.items())),
        stats=(pool.peak_pages, pool.cow_copies, pool.prefix_hits,
               pool.prefix_hit_tokens, pool.prompt_tokens, pool.admitted,
               pool.pages_in_use, pool.pages_free))


@pytest.mark.parametrize("seed,sharing", [(0, True), (1, True), (2, False)])
def test_allocator_matches_reference_op_for_op(seed, sharing):
    """Prompts share prefixes (some page-aligned, some identical), so the
    sequence hits full pages, COW donors, demotions, LRU eviction and
    OutOfPages on both allocators."""
    rng = np.random.default_rng(seed)
    args = dict(num_pages=10, page_size=4, n_log=6, prefix_sharing=sharing)
    jp, tp = JPoolSession(**args), PoolSession(**args)
    bases = [list(rng.integers(0, 5, size=16)) for _ in range(3)]
    live: dict = {}
    ops = {"admit": 0, "release": 0, "unpin": 0, "oop": 0, "flush": 0}
    for _ in range(120):
        op = rng.choice(["admit", "admit", "release", "unpin", "flush"],
                        p=[0.35, 0.2, 0.3, 0.1, 0.05])
        free_slots = [s for s in range(4) if s not in live]
        if op == "admit" and free_slots:
            slot = int(rng.choice(free_slots))
            base = bases[int(rng.integers(0, 3))]
            n = int(rng.integers(3, 21))
            toks = (base + list(rng.integers(0, 5, size=8)))[:n]
            if rng.random() < 0.2:
                toks = base[:n]                    # an identical prompt
            jm, tm = jp.match(toks), tp.match(toks)
            assert (tm.hit, tm.full_ids, tm.donor, tm.donor_tokens) == \
                (jm.hit, jm.full_ids, jm.donor, jm.donor_tokens)
            need = max(len(tm.full_ids),
                       tp.pages_for(n + int(rng.integers(0, 6))))
            assert tp.pages_for(n) == jp.pages_for(n)
            assert tp.can_admit(need) == jp.can_admit(need)
            try:
                jrows = jp.admit(slot, toks, need, jm)
            except JOutOfPages:
                with pytest.raises(OutOfPages):
                    tp.admit(slot, toks, need, tm)
                ops["oop"] += 1
            else:
                trows = tp.admit(slot, toks, need, tm)
                for a, b in zip(trows, jrows):
                    np.testing.assert_array_equal(a, b)
                jp.register(slot, toks, n)
                tp.register(slot, toks, n)
                live[slot] = toks
                ops["admit"] += 1
        elif op == "release" and live:
            slot = int(rng.choice(sorted(live)))
            jp.release(slot)
            tp.release(slot)
            del live[slot]
            ops["release"] += 1
        elif op == "unpin":
            toks = bases[int(rng.integers(0, 3))][:int(rng.integers(5, 17))]
            jp.unpin(jp.match(toks))
            tp.unpin(tp.match(toks))
            ops["unpin"] += 1
        elif op == "flush":
            assert tp.flush_prefix() == jp.flush_prefix()
            ops["flush"] += 1
        jp.check_invariants()
        tp.check_invariants()
        assert _pool_state(tp) == _pool_state(jp)
    assert ops["admit"] > 10 and ops["release"] > 5 and ops["oop"] > 0
    if sharing:
        assert tp.prefix_hits > 0 and tp.cow_copies > 0


def test_allocator_rebuild_matches_reference():
    """``rebuild`` onto a remapped page space carries refcounts, slot maps,
    the prefix cache and stats across, as the reference does."""
    args = dict(num_pages=8, page_size=4, n_log=6)
    pools = JPoolSession(**args), PoolSession(**args)
    toks = list(range(12))
    for p in pools:
        p.admit(0, toks, 4, p.match(toks))
        p.register(0, toks, 12)
        p.admit(1, toks, 4, p.match(toks))
        p.release(0)
    perm = np.zeros(9, np.int64)
    live = [pid for pid in range(1, 9) if pools[0]._ref[pid] > 0]
    for new, old in enumerate(live, start=1):
        perm[old] = new
    jn, tn = (p.rebuild(perm, 6) for p in pools)
    assert _pool_state(tn) == _pool_state(jn)


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------

L, B, S, HKV, HD, P, GROUP = 2, 3, 32, 2, 8, 4, 8


def _pools(precision):
    """An empty JAX pool (two layers, f32 raw dtype) and the port's."""
    proto = jnp.zeros((L, B, S, HKV, HD), jnp.float32)
    kw = dict(num_pages=12, page_size=P, num_slots=B, group=GROUP)
    jpool = JPG.init_pool_field(proto, [(precision, 0, L)], **kw)
    tpool = TPG.init_pool_field(torch.zeros(L, B, S, HKV, HD),
                                [(precision, 0, L)], **kw)
    return jpool, tpool


def _assert_pool_equal(tpool, jpool, skip_dump=True):
    """Leaf for leaf and bit for bit; the dump page's content is undefined
    (repeated writes to it land in either order) and is skipped."""
    lo = 1 if skip_dump else 0
    assert isinstance(tpool, PagedKV)
    assert (tpool.precision, tpool.head_dim, tpool.group, tpool.page_size) \
        == (jpool.precision, jpool.head_dim, jpool.group, jpool.page_size)
    assert torch.equal(tpool.table, _t(jpool.table))
    for t, j in ((tpool.data, jpool.data), (tpool.scale, jpool.scale)):
        if t is None:
            assert j is None
            continue
        jt = _t(j)
        assert t.dtype == jt.dtype and t.shape == jt.shape
        if t.dtype == torch.bfloat16:
            t, jt = t.view(torch.int16), jt.view(torch.int16)
        assert torch.equal(t[:, lo:], jt[:, lo:])


# slot 0: pages 1-3 (3 logical pages), slot 1: maps slot 0's first page as
# a shared prefix page and owns 7, 4; slot 2: one page, the rest dump
ROWS = np.array([[3, 9, 1, 0, 0, 0, 0, 0],
                 [3, 7, 4, 0, 0, 0, 0, 0],
                 [12, 0, 0, 0, 0, 0, 0, 0]], np.int32)
WROWS = ROWS.copy()
WROWS[1, 0] = 0                            # the shared page is not rewritten


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
def test_pool_device_ops_match_reference(precision):
    rng = np.random.default_rng(3)
    jpool, tpool = _pools(precision)
    assert TPG.page_nbytes(tpool) == JPG.page_nbytes(jpool)
    _assert_pool_equal(tpool, jpool, skip_dump=False)
    assert (tpool.seq_len, tpool.num_pages, tpool.num_kv_heads) == \
        (jpool.seq_len, jpool.num_pages, jpool.num_kv_heads)
    # admission: the whole prompt cache into each slot, the shared page
    # redirected to the dump page
    for slot in range(B):
        src = rng.standard_normal((L, 1, S, HKV, HD)).astype(np.float32)
        jpool = JPG.insert_slot_paged(jpool, jnp.asarray(src), slot,
                                      ROWS[slot], WROWS[slot])
        out = TPG.insert_slot_paged(tpool, torch.from_numpy(src), slot,
                                    ROWS[slot], WROWS[slot])
        assert out is tpool                         # in place
        _assert_pool_equal(tpool, jpool)
    # decode writes through the tables, per layer: s = 3 rows at per-slot
    # positions, slot 2 past its last logical page (clamped)
    pos = np.array([5, 9, S + 2], np.int32)
    for layer in range(L):
        new = rng.standard_normal((B, 3, HKV, HD)).astype(np.float32)
        jl = jax.tree.map(lambda x: x[layer], jpool)
        jl = JKV.update_page(jl, jnp.asarray(new), jnp.asarray(pos))
        jpool = jax.tree.map(lambda a, x: a.at[layer].set(x), jpool, jl)
        update_page(tpool.layer(layer), torch.from_numpy(new),
                    torch.from_numpy(pos))
        _assert_pool_equal(tpool, jpool)
    # reads: every slot through its table, one explicit row
    for layer in range(L):
        jg = JPG.gather(jax.tree.map(lambda x: x[layer], jpool))
        tg = TPG.gather(tpool.layer(layer))
        assert isinstance(tg, KVPage)
        for t, j in ((tg.data, jg.data), (tg.scale, jg.scale)):
            if t is not None:
                assert torch.equal(t.float(), _t(j).float())
    jr = JPG.gather_rows(jpool, jnp.asarray(ROWS[1]))
    tr = TPG.gather_rows(tpool, ROWS[1])
    for t, j in ((tr.data, jr.data), (tr.scale, jr.scale)):
        if t is not None:
            assert t.shape == _t(j).shape
            assert torch.equal(t.float(), _t(j).float())
    # release: the slot's table rows all dump
    jpool = JPG.release_slot_pages(jpool, 1)
    TPG.release_slot_pages(tpool, 1)
    assert torch.all(tpool.table[:, 1] == TPG.DUMP_PAGE)
    _assert_pool_equal(tpool, jpool)


def test_bridge_carries_a_pool_state():
    """A JAX pool state (a mixed int8/int4 field, tuple of pools) carries
    across as PagedKV pools with their tables and page size, never as
    dense pages; plain KVPages still carry as KVPages."""
    rng = np.random.default_rng(4)
    proto = jnp.zeros((3, B, S, HKV, HD), jnp.float32)
    field = JPG.init_pool_field(proto, [("int8", 0, 1), ("int4", 1, 3)],
                                num_pages=12, page_size=P, num_slots=B,
                                group=GROUP)
    src = rng.standard_normal((3, 1, S, HKV, HD)).astype(np.float32)
    field = JPG.insert_slot_paged(field, jnp.asarray(src), 0, ROWS[0],
                                  WROWS[0])
    got = _t(field)
    assert isinstance(got, tuple) and len(got) == 2
    for t, j in zip(got, field):
        _assert_pool_equal(t, j, skip_dump=False)
    page = JKV.make_page(jnp.asarray(src[0]), "int8", GROUP)
    assert isinstance(_t(page), KVPage)


# ---------------------------------------------------------------------------
# paged decode attention, plain version
# ---------------------------------------------------------------------------

def _attn_pools(precision, valid, seed, page=P, s_max=S):
    """JAX and port K/V pools of one layer: each slot holds the pages its
    valid rows need at a permuted set of physical ids, slots 1 and 2 map
    slot 0's first page (a shared prefix page), and every other entry is
    the dump page, which holds large garbage."""
    rng = np.random.default_rng(seed)
    n_log = s_max // page
    need = [-(-int(v) // page) for v in valid]
    pairs = [(i, j) for i in range(len(valid)) for j in range(need[i])
             if not (i > 0 and j == 0)]
    perm = rng.permutation(len(pairs)) + 1
    table = np.zeros((len(valid), n_log), np.int32)
    for (i, j), pid in zip(pairs, perm):
        table[i, j] = pid
    table[1:, 0] = np.where(np.array(need[1:]) > 0, table[0, 0], 0)
    out = []
    for _ in range(2):
        raw = rng.standard_normal((len(pairs) + 1, page, HKV, HD)).astype(
            np.float32)
        raw[0] *= 100.0
        if precision == "bf16":
            jp = JKV.PagedKV(data=jnp.asarray(raw), scale=None,
                             table=jnp.asarray(table), precision="bf16",
                             head_dim=HD, group=GROUP, page_size=page)
        else:
            pg = JKV.make_page(jnp.asarray(raw), precision, GROUP)
            jp = JKV.PagedKV(data=pg.data, scale=pg.scale,
                             table=jnp.asarray(table), precision=precision,
                             head_dim=HD, group=GROUP, page_size=page)
        out += [jp, _t(jp)]
    return out


def _check_attention(q, valid, precision, causal=True, fresh=None, seed=0,
                     page=P):
    """The port's plain paged attention against JAX Pallas (interpret) and
    ``_grouped`` on queries that see a row (0 elsewhere), and to the bit
    against the port's dense plain version on the gathered rows."""
    s = q.shape[1]
    rows = valid if fresh is None else fresh[2] + fresh[0].shape[1]
    jk, tk, jv, tv = _attn_pools(precision, rows, seed, page=page)
    tfresh = jfresh = None
    if fresh is not None:
        tfresh = tuple(torch.from_numpy(np.asarray(a)) for a in fresh)
        jfresh = tuple(jnp.asarray(a) for a in fresh)
    got = TDA.decode_attention(torch.from_numpy(q), tk, tv,
                               valid_len=torch.from_numpy(valid),
                               causal=causal, fresh_kv=tfresh).numpy()
    limit = (valid[:, None] - s + 1 + np.arange(s)[None, :] if causal
             else np.repeat(valid[:, None], s, axis=1))
    sees = limit > 0
    assert np.all(got[~sees] == 0.0)
    jq, jvalid = jnp.asarray(q), jnp.asarray(valid)
    for want in (_pallas(jq, jk, jv, jvalid, page, causal, fresh=jfresh,
                         interpret=True),
                 _grouped(jq, jk, jv, jvalid, 16, causal, fresh=jfresh)):
        np.testing.assert_allclose(got[sees], np.asarray(want)[sees], **TOL)
    # the dense plain version on the same rows, split alike (splits of 16
    # logical rows: several per slot)
    fq = None
    if tfresh is not None:
        fq = (TDA._fresh_page(tfresh[0], tk), TDA._fresh_page(tfresh[1], tv),
              tfresh[2])
    paged = TDA.decode_attention_plain(torch.from_numpy(q), tk, tv,
                                       torch.from_numpy(valid), causal, fq,
                                       split=16)
    dense = TDA.decode_attention_plain(torch.from_numpy(q), TPG.gather(tk),
                                       TPG.gather(tv),
                                       torch.from_numpy(valid), causal, fq,
                                       split=16)
    assert torch.equal(paged, dense)


def _q(seed, b, s):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, HKV * 3, HD)).astype(np.float32)


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("page", [4, 8])
def test_paged_decode_attention_single_query(precision, page):
    valid = np.array([13, 30, 21, 1], np.int32)
    _check_attention(_q(5, 4, 1), valid, precision, seed=page, page=page)


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("causal", [True, False])
def test_paged_decode_attention_window(precision, causal):
    """qs 3; slot 3 has fewer valid rows than queries, so its first causal
    queries see no row and give 0."""
    valid = np.array([13, 32, 21, 2], np.int32)
    _check_attention(_q(6, 4, 3), valid, precision, causal=causal, seed=7)


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
def test_paged_decode_attention_fresh_rows(precision):
    """The fused propose over a pool: fresh rows at base + j, cache rows
    at or past base stale, count fresh rows already written."""
    rng = np.random.default_rng(9)
    sf = 3
    fk = rng.standard_normal((4, sf, HKV, HD)).astype(np.float32)
    fv = rng.standard_normal((4, sf, HKV, HD)).astype(np.float32)
    base = np.array([5, 12, 28, 1], np.int32)
    for count in range(sf):
        _check_attention(_q(10 + count, 4, 1), base + count + 1, precision,
                         fresh=(fk, fv, base), seed=11)
