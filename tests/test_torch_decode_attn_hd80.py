"""Decode attention at head dim 80 (zamba2-2.7b's shared attention), with
scale groups that cross heads or are not powers of two, and split-half
int4 pages with an odd number of KV heads: the port's plain version (the
kernel's yardstick) against the JAX Pallas kernel in interpret mode and
against ``_grouped`` on queries that see a row (1e-5, f32), in every form:
the single-query step, the verify window causal and not, the fresh rows
of a draft propose, dense pages and paged pools (the pool to the bit
against the dense plain version on the gathered rows). The kernel's own
form check (``check_form``, which the CUDA wrapper runs before it
launches) takes these forms and refuses, naming what it takes, the ones
``decode_attn.cu`` has no copy for."""

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

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, PAGE = 3, 48, 8


def _t(x):
    return from_jax(jax.tree.map(np.asarray, x), device="cpu")


def _pages(rng, hkv, hd, precision, group, paged, rows):
    """JAX and port K/V of one layer: dense (B, S) pages, or pools whose
    slots map permuted physical pages (slot 1 maps slot 0's first page;
    the rest point at the dump page 0, which holds large garbage)."""
    out = []
    if not paged:
        for _ in range(2):
            raw = rng.standard_normal((B, S, hkv, hd)).astype(np.float32)
            jp = JKV.make_page(jnp.asarray(raw), precision, group)
            out += [jp, _t(jp)]
        return out
    n_log = S // PAGE
    need = [-(-int(v) // PAGE) for v in rows]
    pairs = [(i, j) for i in range(B) for j in range(need[i])
             if not (i == 1 and j == 0)]
    table = np.zeros((B, n_log), np.int32)
    for (i, j), pid in zip(pairs, rng.permutation(len(pairs)) + 1):
        table[i, j] = pid
    if need[1] > 0:
        table[1, 0] = table[0, 0]
    for _ in range(2):
        raw = rng.standard_normal((len(pairs) + 1, PAGE, hkv, hd)).astype(
            np.float32)
        raw[0] *= 100.0
        pg = JKV.make_page(jnp.asarray(raw), precision, group)
        jp = JKV.PagedKV(data=pg.data, scale=pg.scale,
                         table=jnp.asarray(table), precision=precision,
                         head_dim=hd, group=group, page_size=PAGE)
        out += [jp, _t(jp)]
    return out


def _check(hkv, rep, hd, group, precision, *, qs=1, causal=True,
           fresh=False, paged=False, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, qs, hkv * rep, hd)).astype(np.float32)
    valid = np.array([17, 48 if not fresh else 30, 3], np.int32)
    if qs > 1:
        valid[2] = 2                 # its first causal queries see no row
    tfresh = jfresh = None
    rows = valid
    if fresh:
        sf = 3
        fk, fv = (rng.standard_normal((B, sf, hkv, hd)).astype(np.float32)
                  for _ in range(2))
        base = valid - 1
        valid = base + 2             # one fresh row already written
        rows = base + sf
        tfresh = tuple(torch.from_numpy(a) for a in (fk, fv, base))
        jfresh = tuple(jnp.asarray(a) for a in (fk, fv, base))
    jk, tk, jv, tv = _pages(rng, hkv, hd, precision, group, paged, rows)
    got = TDA.decode_attention(torch.from_numpy(q), tk, tv,
                               valid_len=torch.from_numpy(valid),
                               causal=causal, fresh_kv=tfresh).numpy()
    limit = (valid[:, None] - qs + 1 + np.arange(qs)[None] if causal
             else np.repeat(valid[:, None], qs, axis=1))
    sees = limit > 0
    assert np.all(got[~sees] == 0.0)
    jq, jvalid = jnp.asarray(q), jnp.asarray(valid)
    chunk = PAGE if paged else 16
    for want in (_pallas(jq, jk, jv, jvalid, chunk, causal, fresh=jfresh,
                         interpret=True),
                 _grouped(jq, jk, jv, jvalid, chunk, causal, fresh=jfresh)):
        np.testing.assert_allclose(got[sees], np.asarray(want)[sees], **TOL)
    if paged:
        fq = None
        if tfresh is not None:
            fq = (TDA._fresh_page(tfresh[0], tk),
                  TDA._fresh_page(tfresh[1], tv), tfresh[2])
        args = (torch.from_numpy(valid), causal, fq)
        assert torch.equal(
            TDA.decode_attention_plain(torch.from_numpy(q), tk, tv, *args,
                                       split=16),
            TDA.decode_attention_plain(torch.from_numpy(q), TPG.gather(tk),
                                       TPG.gather(tv), *args, split=16))
    TDA.check_form(hd, hkv, group, precision)    # the kernel takes it


FORMS = {"step": dict(), "window": dict(qs=3),
         "window-noncausal": dict(qs=3, causal=False),
         "noncausal": dict(causal=False), "fresh": dict(fresh=True)}


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("rep", [1, 2])
def test_hd80_groups_cross_heads(rep, precision, form, paged):
    """hd 80 over scale groups of 64 (head 1 covers elements 80-159, in
    groups 1 and 2), 4 KV heads."""
    _check(4, rep, 80, 64, precision, paged=paged, seed=rep,
           **FORMS[form])


@pytest.mark.parametrize("form", ["step", "window", "fresh"])
def test_group_80_at_hd80(form):
    """A group that is a multiple of 16 but not a power of two, dividing
    Hkv * hd = 320."""
    _check(4, 2, 80, 80, "int8", seed=3, **FORMS[form])
    _check(4, 2, 80, 80, "int8", seed=4, paged=True, **FORMS[form])


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("form", ["step", "window", "fresh"])
def test_int4_odd_kv_heads(hd, form):
    """Split-half int4 over 3 KV heads: F / 2 falls inside head 1, whose
    first chunks are low nibbles and the rest high nibbles."""
    _check(3, 2, hd, 32, "int4", seed=hd, **FORMS[form])
    _check(3, 2, hd, 32, "int4", seed=hd + 1, paged=True, **FORMS[form])


@pytest.mark.parametrize("hd,hkv,group,precision", [
    (80, 32, 64, "int8"), (80, 32, 64, "int4"), (80, 32, 64, "bf16"),
    (80, 32, 80, "int8"), (80, 4, 16, "int4"), (64, 3, 64, "int4"),
    (32, 3, 32, "int4"), (128, 6, 48, "int8"), (32, 2, 16, "int8")])
def test_kernel_form_check_takes(hd, hkv, group, precision):
    TDA.check_form(hd, hkv, group, precision)


@pytest.mark.parametrize("hd,hkv,group,precision,match", [
    (72, 16, 64, "int8", "head dims"), (96, 4, 64, "bf16", "head dims"),
    (128, 8, 24, "int8", "multiples of 16"),
    (80, 16, 48, "int8", "divide"), (80, 3, 16, "int4", "int4"),
    (80, 1, 80, "int4", "int4"), (64, 8, 64, "int2", "precision")])
def test_kernel_form_check_refuses(hd, hkv, group, precision, match):
    with pytest.raises(ValueError, match=match):
        TDA.check_form(hd, hkv, group, precision)
    if match == "head dims":
        with pytest.raises(ValueError, match=r"\(32, 64, 80, 128\)"):
            TDA.check_form(hd, hkv, group, precision)
