"""The plain version of the port's decode attention kernel against the JAX
reference on the CPU, for bf16, int8 and split-half int4 pages: against
JAX ``grouped`` and ``simple`` on slots with at least one valid row, and
against the Pallas kernel in interpret mode on every slot, including
valid_len 0 (where the reference's jnp backends average V and the TPU
kernel, like the port, gives 0). f32, 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.kernel import decode_attn_pallas
from repro.kernels.decode_attn.ops import decode_attention as jdecode
from repro.quant import kvcache as JKV
from repro_torch.bridge import from_jax
from repro_torch.kernels.decode_attn import ops as TDA

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
    tk, tv = (from_jax(jax.tree.map(np.asarray, p)) for p in (jk, jv))
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


def test_kernel_wrapper_takes_only_single_query():
    q = torch.zeros(1, 2, 4, 16)
    page = TDA._page_of(torch.zeros(1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="one query"):
        TDA.decode_attn_cuda(q, page, page, torch.ones(1, dtype=torch.int32))
