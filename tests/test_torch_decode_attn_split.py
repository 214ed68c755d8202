"""The split-KV plan of the port's decode attention kernel and its plain
version on the CPU, against the JAX reference.

The CUDA kernel (csrc/decode_attn.cu) splits each slot's logical rows into
splits of SPLIT_ROWS, attends each split in a block of its own and merges
the per-split partials (m, l, acc) in split order, the fresh rows last.
The plain version computes the same splits and merges them with
``merge_partials`` in the kernel's order and arithmetic, so these tests
hold the plan and the merge: boundaries at multiples of the split only
(never at S, the page size or valid_len), the same for a pool and the
dense page gathered from it; the merged result within 1e-5 of JAX Pallas
(interpret) and ``_grouped`` for bf16, int8 and int4, one query and the
verify window (causal or not), with fresh rows; empty splits, slots whose
valid rows end on a boundary and queries that see no row give 0 and no
NaN. Splits of 16 rows keep several splits per slot at SMOKE sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import _grouped, _pallas
from repro.quant import kvcache as JKV
from repro_torch.bridge import from_jax
from repro_torch.kernels.decode_attn import ops as TDA
from repro_torch.quant import paged as TPG
from repro_torch.quant.kvcache import PagedKV, make_page

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT = 16
B, HKV, REP, HD, GROUP = 4, 2, 3, 32, 32


def _t(x):
    return from_jax(jax.tree.map(np.asarray, x), device="cpu")


def _limits(valid, s, causal):
    if not causal:
        return np.repeat(valid[:, None], s, axis=1)
    return valid[:, None] - s + 1 + np.arange(s)[None, :]


def _q(seed, s):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, s, HKV * REP, HD)).astype(np.float32)


def _dense_pages(seed, t, precision):
    rng = np.random.default_rng(seed)
    k, v = ((rng.standard_normal((B, t, HKV, HD)) * 0.5).astype(np.float32)
            for _ in range(2))
    jk, jv = (JKV.make_page(jnp.asarray(a), precision, GROUP) for a in (k, v))
    return jk, jv, _t(jk), _t(jv)


def _pools(seed, valid, precision, page, n_log):
    """JAX and port K/V pools: each slot's pages at a permuted set of
    physical ids, the rest of the table the dump page 0, which holds large
    garbage. K and V share the table, as the reference's pools do (its
    Pallas kernel reads both through K's)."""
    rng = np.random.default_rng(seed)
    need = [-(-int(v) // page) for v in valid]
    pairs = [(i, j) for i in range(B) for j in range(need[i])]
    table = np.zeros((B, n_log), np.int32)
    for (i, j), pid in zip(pairs, rng.permutation(len(pairs)) + 1):
        table[i, j] = pid
    out = []
    for _ in range(2):
        raw = rng.standard_normal((len(pairs) + 1, page, HKV, HD)).astype(
            np.float32)
        raw[0] *= 100.0
        pg = JKV.make_page(jnp.asarray(raw), precision, GROUP)
        jp = JKV.PagedKV(data=pg.data, scale=pg.scale, table=jnp.asarray(table),
                         precision=precision, head_dim=HD, group=GROUP,
                         page_size=page)
        out += [jp, _t(jp)]
    return out


def _check_against_reference(got, q, jk, jv, valid, causal, chunk,
                             jfresh=None):
    """``got`` within 1e-5 of Pallas (interpret) and ``_grouped`` on the
    queries that see a row, 0 on the rest."""
    s = q.shape[1]
    sees = _limits(valid, s, causal) > 0
    assert np.isfinite(got).all()
    assert np.all(got[~sees] == 0.0)
    jq, jvalid = jnp.asarray(q), jnp.asarray(valid)
    for want in (_pallas(jq, jk, jv, jvalid, chunk, causal, fresh=jfresh,
                         interpret=True),
                 _grouped(jq, jk, jv, jvalid, 16, causal, fresh=jfresh)):
        np.testing.assert_allclose(got[sees], np.asarray(want)[sees], **TOL)


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 3, 15])
@pytest.mark.parametrize("seq", [0, 1, 24, 127, 128, 129, 300, 1032, 2048])
def test_split_plan_covers_the_rows_on_fixed_boundaries(seq, rows):
    """The splits tile [0, S) exactly, in order, at multiples of the split
    only: the splits of a shorter cache are those of a longer one, cut at
    its end (so a cache of another length adds only empty splits). The
    split follows the KV head's query rows (rep * s), a shape: 256 rows for
    a single one, else 128."""
    L = TDA.split_rows(rows)
    assert L == (TDA.SPLIT_ROWS_ONE_QUERY if rows == 1 else TDA.SPLIT_ROWS)
    bounds = TDA.split_bounds(seq, L)
    assert len(bounds) == TDA.n_splits(seq, L) == max(1, -(-seq // L))
    assert bounds[0][0] == 0 and bounds[-1][1] == seq
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2
    for j, (lo, hi) in enumerate(bounds):
        assert lo == j * L and hi - lo <= L
    longer = TDA.split_bounds(seq + 3 * L + 5, L)
    for (lo, hi), (llo, lhi) in zip(bounds, longer):
        assert (lo, min(lhi, seq)) == (llo, hi)


@pytest.mark.parametrize("page", [4, 24, 64, 100])
def test_split_plan_is_the_same_for_a_pool_and_its_gathered_page(page):
    """A pool of n_log pages of any size and the dense page gathered from
    it have the same logical length, hence the same splits; boundaries
    fall wherever the split puts them, inside a page if need be."""
    n_log = 11
    pool = PagedKV(data=torch.zeros(5, page, 2, 16, dtype=torch.int8),
                   scale=torch.zeros(5, page, 2, dtype=torch.bfloat16),
                   table=torch.zeros(3, n_log, dtype=torch.int32),
                   precision="int8", head_dim=16, group=16, page_size=page)
    dense = TPG.gather(pool)
    assert dense.seq_len == pool.seq_len == n_log * page
    assert TDA.split_bounds(pool.seq_len) == TDA.split_bounds(dense.seq_len)
    assert all(lo % TDA.SPLIT_ROWS == 0
               for lo, _ in TDA.split_bounds(pool.seq_len))


# ---------------------------------------------------------------------------
# merge_partials
# ---------------------------------------------------------------------------

def _state(rng, shape, d, empty=False):
    if empty:
        return (torch.full(shape, -torch.inf), torch.zeros(shape),
                torch.zeros((*shape, d)))
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.uniform(0.5, 3, shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((*shape, d)).astype(
                np.float32)))


def test_merge_partials_of_empty_states_gives_zero_not_nan():
    rng = np.random.default_rng(0)
    empty = _state(rng, (2, 3), 8, empty=True)
    out = TDA.merge_partials([empty, empty])
    assert torch.equal(out, torch.zeros(2, 3, 8))


def test_merge_partials_ignores_empty_states_to_the_bit():
    """An empty split anywhere in the order (a longer cache's extra
    splits, a split past valid_len) leaves the merged result unchanged to
    the bit; a state that is empty in some rows only merges per row."""
    rng = np.random.default_rng(1)
    a, b = _state(rng, (2, 3), 8), _state(rng, (2, 3), 8)
    empty = _state(rng, (2, 3), 8, empty=True)
    want = TDA.merge_partials([a, b])
    for parts in ([a, empty, b], [a, b, empty, empty], [empty, a, b]):
        assert torch.equal(TDA.merge_partials(parts), want)
    half = tuple(torch.where(torch.arange(3) < 2, e, x) if e.dim() == 2
                 else torch.where((torch.arange(3) < 2)[:, None], e, x)
                 for e, x in zip(empty, b))
    got = TDA.merge_partials([a, half])
    assert torch.equal(got[:, 2], want[:, 2])
    torch.testing.assert_close(got[:, :2], a[2][:, :2] / a[1][:, :2, None],
                               rtol=1e-6, atol=1e-6)


def test_merge_partials_equals_one_softmax_over_all_rows():
    """Per-split partials of one score row, merged, equal one softmax over
    the whole row (the rescale by exp(m_j - m) is what makes them)."""
    rng = np.random.default_rng(2)
    scores = torch.from_numpy(rng.standard_normal(50).astype(np.float32) * 4)
    v = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    parts = []
    for lo in range(0, 50, 16):
        s, vv = scores[lo:lo + 16], v[lo:lo + 16]
        m = s.max()
        p = torch.exp(s - m)
        parts.append((m, p.sum(), p @ vv))
    want = torch.softmax(scores, 0) @ v
    torch.testing.assert_close(TDA.merge_partials(parts), want, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the plain version's splits against the reference
# ---------------------------------------------------------------------------

WINDOWS = [(1, True), (3, True), (3, False)]


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("s,causal", WINDOWS)
def test_split_partials_match_reference(precision, s, causal):
    """70 rows in splits of 16 (the last one ragged): valid_len 0, ends on
    a boundary (32), one past it (17) and the whole cache; with s = 3
    slot 0 sees nothing and causal queries of short slots see no row."""
    t = 70
    jk, jv, tk, tv = _dense_pages(10 + s, t, precision)
    q = _q(20 + s, s)
    valid = np.array([0, 32, 17, 70], np.int32)
    got = TDA.decode_attention_plain(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(valid), causal,
                                     split=SPLIT).numpy()
    _check_against_reference(got, q, jk, jv, valid, causal, 16)


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
def test_split_partials_with_fresh_rows_match_reference(precision):
    """The fresh rows are one more part, merged last: cache rows at or
    past base are stale; base on a split boundary (16) and inside one."""
    rng = np.random.default_rng(30)
    sf, t = 4, 64
    jk, jv, tk, tv = _dense_pages(31, t, precision)
    fk, fv = (rng.standard_normal((B, sf, HKV, HD)).astype(np.float32)
              for _ in range(2))
    base = np.array([16, 0, 47, 33], np.int32)
    for count in range(sf):
        valid = base + count + 1
        q = _q(40 + count, 1)
        fresh = tuple(torch.from_numpy(a) for a in (fk, fv, base))
        fq = (TDA._fresh_page(fresh[0], tk), TDA._fresh_page(fresh[1], tv),
              fresh[2])
        got = TDA.decode_attention_plain(torch.from_numpy(q), tk, tv,
                                         torch.from_numpy(valid), True, fq,
                                         split=SPLIT).numpy()
        _check_against_reference(got, q, jk, jv, valid, True, 16,
                                 tuple(jnp.asarray(a) for a in
                                       (fk, fv, base)))


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("s,causal", WINDOWS)
def test_split_partials_over_a_pool_whose_pages_straddle_splits(
        precision, s, causal):
    """Pages of 12 rows under splits of 16: a split boundary falls inside
    a page. The pool gives the dense plain version's result on the
    gathered rows to the bit, and matches the reference."""
    page, n_log = 12, 6
    valid = np.array([16, 33, 71, 2], np.int32)
    rows = np.minimum(valid, n_log * page)
    jk, tk, jv, tv = _pools(50 + s, rows, precision, page, n_log)
    q = _q(60 + s, s)
    got = TDA.decode_attention_plain(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(valid), causal,
                                     split=SPLIT)
    dense = TDA.decode_attention_plain(torch.from_numpy(q), TPG.gather(tk),
                                       TPG.gather(tv),
                                       torch.from_numpy(valid), causal,
                                       split=SPLIT)
    assert torch.equal(got, dense)
    _check_against_reference(got.numpy(), q, jk, jv, valid, causal, page)


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
def test_empty_splits_and_blind_queries_give_zero_and_no_nan(precision):
    """Slots with valid_len 0 and ending on split boundaries, most splits
    empty, a window whose first queries see no row: no NaN, 0 where a
    query sees nothing, and a cache twice as long (only more empty
    splits) gives the same result to the bit."""
    t = 64
    jk, jv, tk, tv = _dense_pages(70, t, precision)
    q = torch.from_numpy(_q(71, 3))
    valid = torch.tensor([0, 16, 32, 2], dtype=torch.int32)
    got = TDA.decode_attention_plain(q, tk, tv, valid, True, split=SPLIT)
    assert torch.isfinite(got).all()
    blind = torch.from_numpy(_limits(valid.numpy(), 3, True) <= 0)
    assert blind.any() and bool((got[blind] == 0).all())
    longer = [make_page(torch.zeros(B, 2 * t, HKV, HD), precision, GROUP)
              for _ in range(2)]
    for pg, src in zip(longer, (tk, tv)):
        pg.data[:, :t] = src.data
        if src.scale is not None:
            pg.scale[:, :t] = src.scale
    assert len(TDA.split_bounds(2 * t, SPLIT)) == 2 * len(
        TDA.split_bounds(t, SPLIT))
    again = TDA.decode_attention_plain(q, *longer, valid, True, split=SPLIT)
    assert torch.equal(got, again)
