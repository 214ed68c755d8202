"""The plain version of the port's decode attention kernel against the JAX
reference on the CPU, for bf16, int8 and split-half int4 pages: against
JAX ``grouped`` and ``simple`` on queries that see at least one row, and
against the Pallas kernel in interpret mode on every slot, including
valid_len 0 (where the reference's jnp backends average V and the TPU
kernel, like the port, gives 0). The single-query step, the multi-query
verify window (causal and not) and the fresh-row form of the fused draft
propose. f32, 1e-5. The paged forms are in tests/test_torch_paged.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.kernel import decode_attn_pallas
from repro.kernels.decode_attn.ops import _pallas
from repro.kernels.decode_attn.ops import decode_attention as jdecode
from repro.quant import kvcache as JKV
from repro_torch.bridge import from_jax
from repro_torch.kernels.decode_attn import ops as TDA
from repro_torch.quant.kvcache import PagedKV, make_page

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, b, s, hkv, rep, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hkv * rep, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("s,valid", [(40, (0, 40, 17)), (300, (299, 1, 300))])
def test_decode_attention_plain_matches_reference(precision, s, valid):
    b, hkv, rep, hd, group = 3, 2, 3, 32, 32
    q, k, v = _inputs(s, b, s, hkv, rep, hd)
    jk, jv = (JKV.make_page(jnp.asarray(a), precision, group) for a in (k, v))
    tk, tv = (from_jax(jax.tree.map(np.asarray, p), device="cpu")
              for p in (jk, jv))
    valid = np.asarray(valid, np.int32)
    got = TDA.decode_attention(torch.from_numpy(q), tk, tv,
                               valid_len=torch.from_numpy(valid)).numpy()
    live = valid > 0
    assert np.all(got[~live] == 0.0)        # an empty slot gives 0
    for backend in ("grouped", "simple"):
        want = np.asarray(jdecode(jnp.asarray(q), jk, jv,
                                  valid_len=jnp.asarray(valid),
                                  backend=backend, kv_chunk=16))
        np.testing.assert_allclose(got[live], want[live], **TOL)

    def flat(p):
        data = p.data.reshape(b, s, -1)
        scale = (jnp.ones((b, s, 1), jnp.bfloat16) if p.scale is None
                 else p.scale)
        return data, scale

    chunk = 8 if s == 40 else 64          # 300 rows: a ragged final chunk
    pallas = decode_attn_pallas(
        jnp.asarray(q).reshape(b, hkv, rep, 1, hd), *flat(jk), *flat(jv),
        jnp.asarray(valid)[:, None], precision=precision, group=group,
        head_dim=hd, kv_chunk=chunk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas).reshape(got.shape),
                               **TOL)


def test_raw_cache_operand_is_a_bf16_page():
    q, k, v = _inputs(1, 2, 24, 2, 2, 16)
    valid = np.array([5, 24], np.int32)
    got = TDA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               valid_len=torch.from_numpy(valid)).numpy()
    want = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              valid_len=jnp.asarray(valid),
                              backend="grouped", kv_chunk=8))
    np.testing.assert_allclose(got, want, **TOL)


def _window_inputs(seed, b, t, s, hkv, rep, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hkv * rep, hd)).astype(np.float32)
    k = (rng.standard_normal((b, t, hkv, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, t, hkv, hd)) * 0.5).astype(np.float32)
    return q, k, v


def _pages(k, v, precision, group):
    jk, jv = (JKV.make_page(jnp.asarray(a), precision, group) for a in (k, v))
    return jk, jv, from_jax(jax.tree.map(np.asarray, jk), device="cpu"), \
        from_jax(jax.tree.map(np.asarray, jv), device="cpu")


def _limits(valid, s, causal):
    if not causal:
        return np.repeat(valid[:, None], s, axis=1)
    return valid[:, None] - s + 1 + np.arange(s)[None, :]


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("s", [2, 5])
@pytest.mark.parametrize("causal", [True, False])
def test_window_plain_matches_reference(precision, s, causal):
    """The verify window: query i sees rows < valid - s + 1 + i (causal) or
    < valid. Slot 0 has fewer valid rows than queries, so its first causal
    queries see no row: 0 in the port, compared with JAX only where a
    query sees at least one row. 40 rows in chunks of 16 (grouped) and 16
    (Pallas) leave a ragged final chunk."""
    b, t, hkv, rep, hd, group = 3, 40, 2, 3, 32, 32
    q, k, v = _window_inputs(s, b, t, s, hkv, rep, hd)
    jk, jv, tk, tv = _pages(k, v, precision, group)
    valid = np.array([1, 40, 13], np.int32)
    got = TDA.decode_attention(torch.from_numpy(q), tk, tv,
                               valid_len=torch.from_numpy(valid),
                               causal=causal).numpy()
    sees = _limits(valid, s, causal) > 0                        # (B, s)
    assert np.all(got[~sees] == 0.0)
    assert causal == (not sees.all())
    for backend in ("grouped", "simple"):
        want = np.asarray(jdecode(jnp.asarray(q), jk, jv,
                                  valid_len=jnp.asarray(valid),
                                  backend=backend, kv_chunk=16,
                                  causal=causal))
        np.testing.assert_allclose(got[sees], want[sees], **TOL)
    want = np.asarray(_pallas(jnp.asarray(q), jk, jv, jnp.asarray(valid), 16,
                              causal, interpret=True))
    np.testing.assert_allclose(got[sees], want[sees], **TOL)


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
def test_fresh_rows_plain_match_reference(precision):
    """The fused draft propose: raw fresh rows at positions base + j,
    quantized with the page's write math; cache rows at or past base are
    stale (the cache holds garbage there). Per-slot base, and count = the
    fresh rows already written, so valid = base + count + 1."""
    b, t, sf, hkv, rep, hd, group = 3, 40, 4, 2, 3, 32, 32
    q, k, v = _window_inputs(7, b, t, 1, hkv, rep, hd)
    rng = np.random.default_rng(8)
    fk = rng.standard_normal((b, sf, hkv, hd)).astype(np.float32)
    fv = rng.standard_normal((b, sf, hkv, hd)).astype(np.float32)
    jk, jv, tk, tv = _pages(k, v, precision, group)
    base = np.array([5, 0, 33], np.int32)
    for count in range(sf):
        valid = base + count + 1
        got = TDA.decode_attention(
            torch.from_numpy(q), tk, tv, valid_len=torch.from_numpy(valid),
            fresh_kv=(torch.from_numpy(fk), torch.from_numpy(fv),
                      torch.from_numpy(base))).numpy()
        jfresh = (jnp.asarray(fk), jnp.asarray(fv), jnp.asarray(base))
        for backend in ("grouped", "simple"):
            want = np.asarray(jdecode(jnp.asarray(q), jk, jv,
                                      valid_len=jnp.asarray(valid),
                                      backend=backend, kv_chunk=16,
                                      fresh_kv=jfresh))
            np.testing.assert_allclose(got, want, **TOL)
        want = np.asarray(_pallas(jnp.asarray(q), jk, jv, jnp.asarray(valid),
                                  16, True, fresh=jfresh, interpret=True))
        np.testing.assert_allclose(got, want, **TOL)


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel wrapper refuses what the kernel does not take, with no
    fallback to the plain version: CPU tensors, K/V pages of mixed
    precision, fresh rows at another precision than the cache, more fresh
    rows than its epilogue tile; for a paged pool, a page table on the CPU
    or of the wrong shape or dtype, a V pool at another precision than
    K's, a dense page beside a pool."""
    q = torch.zeros(1, 2, 4, 16)
    kp = make_page(torch.zeros(1, 8, 2, 16), "int8", 16)
    vp = make_page(torch.zeros(1, 8, 2, 16), "int4", 16)
    valid = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TDA.decode_attn_cuda(q, kp, kp, valid)
    with pytest.raises(ValueError, match="share precision"):
        TDA.decode_attn_cuda(q, kp, vp, valid)
    fresh = (make_page(torch.zeros(1, 2, 2, 16), "int4", 16),) * 2 + (valid,)
    with pytest.raises(ValueError, match="fresh rows must share"):
        TDA.decode_attn_cuda(q, kp, kp, valid, fresh=fresh)
    many = (make_page(torch.zeros(1, 33, 2, 16), "int8", 16),) * 2 + (valid,)
    with pytest.raises(ValueError, match="1 to 32 fresh rows"):
        TDA.decode_attn_cuda(q, kp, kp, valid, fresh=many)
    pool = PagedKV(data=torch.zeros(3, 4, 2, 16, dtype=torch.int8),
                   scale=torch.zeros(3, 4, 2, dtype=torch.bfloat16),
                   table=torch.zeros(1, 2, dtype=torch.int32),
                   precision="int8", head_dim=16, group=16, page_size=4)
    for table in (torch.zeros(1, 2, dtype=torch.int32),      # on the CPU
                  torch.zeros(2, 2, dtype=torch.int32),      # wrong shape
                  torch.zeros(1, 2, dtype=torch.int64)):     # wrong dtype
        bad = dataclasses.replace(pool, table=table)
        with pytest.raises(ValueError, match="page table"):
            TDA.decode_attn_cuda(q, bad, bad, valid)
    v4 = PagedKV(data=torch.zeros(3, 4, 16, dtype=torch.int8),
                 scale=torch.zeros(3, 4, 2, dtype=torch.bfloat16),
                 table=pool.table, precision="int4", head_dim=16, group=16,
                 page_size=4)
    with pytest.raises(ValueError, match="share precision"):
        TDA.decode_attn_cuda(q, pool, v4, valid)
    with pytest.raises(ValueError, match="both be pools"):
        TDA.decode_attn_cuda(q, pool, kp, valid)
