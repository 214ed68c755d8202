"""Plain versions of the port's quantized matmul kernels (qdot, fused_qkv,
fused_mlp) against the JAX reference on the CPU.

* against JAX ``backend="simple"``, which they mirror (dequantize to bf16,
  multiply in f32): 1e-5 in f32;
* against JAX ``backend="grouped"`` and the Pallas kernels in interpret
  mode, which dequantize in f32 without the bf16 rounding: 2e-2 in bf16
  and on random weights (tests/test_kernels.py:68), and 1e-4 in f32 on
  weights whose group scales are powers of two, where the bf16 dequant is
  exact and only the summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qmatmul import ops as JOPS
from repro.kernels.qmatmul.kernel import qkv_pallas, qmatmul_pallas, qmlp_pallas
from repro.quant.quantize import quantize as jquantize
from repro_torch.bridge import from_jax
from repro_torch.kernels.qmatmul import ops as TOPS

torch.set_num_threads(2)

PRECISIONS = ("int8", "int4", "ternary")
MS = (1, 3, 128)
GROUP = 64


def _weight(seed, n, k, precision, exact):
    rng = np.random.default_rng(seed)
    if not exact:
        return (rng.standard_normal((n, k)) * 0.2).astype(np.float32)
    # levels times a power-of-two scale, with the largest level in every
    # group, so the group scale comes out a power of two
    qmax = {"int8": 127, "int4": 7, "ternary": 1}[precision]
    lv = rng.integers(-qmax, qmax + 1, size=(n, k))
    if precision == "ternary":
        lv = rng.choice([-1, 1], size=(n, k))
    lv[:, ::GROUP] = qmax
    step = {"int8": 2.0 ** -11, "int4": 2.0 ** -7, "ternary": 2.0 ** -5}
    return (lv * step[precision]).astype(np.float32)


def _pair(seed, n, k, precision, exact=False):
    jq = jquantize(jnp.asarray(_weight(seed, n, k, precision, exact)),
                   precision, GROUP)
    return jq, from_jax(jax.tree.map(np.asarray, jq))


def _x(seed, m, k, dtype):
    x = (np.random.default_rng(seed).standard_normal((m, k)) * 0.5
         ).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("m", MS)
def test_qdot_plain_matches_reference(precision, m):
    jw, tw = _pair(m, 96, 256, precision)
    for dtype in (jnp.float32, jnp.bfloat16):
        jx, tx = _x(m + 1, m, 256, dtype)
        got = _np(TOPS.qdot(tx, tw))
        tol = 1e-5 if dtype == jnp.float32 else 2e-2
        np.testing.assert_allclose(
            got, _np(JOPS.qdot(jx, jw, backend="simple")), rtol=tol, atol=tol)
        np.testing.assert_allclose(
            got, _np(JOPS.qdot(jx, jw, backend="grouped")), rtol=2e-2,
            atol=2e-2)
        np.testing.assert_allclose(
            got, _np(qmatmul_pallas(jx.astype(jnp.float32), jw.data,
                                    jw.scale, group=GROUP,
                                    precision=precision, interpret=True)),
            rtol=2e-2, atol=2e-2)
    # exact dequant: f32 agreement with the f32-dequant paths
    jw, tw = _pair(m + 7, 96, 256, precision, exact=True)
    jx, tx = _x(m + 2, m, 256, jnp.float32)
    got = _np(TOPS.qdot(tx, tw))
    for want in (JOPS.qdot(jx, jw, backend="grouped"),
                 qmatmul_pallas(jx, jw.data, jw.scale, group=GROUP,
                                precision=precision, interpret=True)):
        np.testing.assert_allclose(got, _np(want), rtol=1e-4, atol=1e-4)


def test_qdot_raw_weight_matches_reference():
    w = np.random.default_rng(0).standard_normal((48, 64)).astype(np.float32)
    jx, tx = _x(1, 5, 64, jnp.float32)
    np.testing.assert_allclose(
        _np(TOPS.qdot(tx, torch.from_numpy(w))),
        _np(JOPS.qdot(jx, jnp.asarray(w), backend="simple")), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("m", MS)
def test_fused_qkv_plain_matches_reference(precision, m):
    k = 256
    pairs = [_pair(10 * i + m, n, k, precision, exact=True)
             for i, n in enumerate((128, 64, 64))]
    jws, tws = [p[0] for p in pairs], [p[1] for p in pairs]
    jx, tx = _x(m, m, k, jnp.float32)
    got = [_np(g) for g in TOPS.fused_qkv_plain(tx, *tws)]
    simple = JOPS.fused_qkv(jx, *jws, backend="simple")
    pallas = qkv_pallas(jx, *(a for w in jws for a in (w.data, w.scale)),
                        group=GROUP, precision=precision, interpret=True)
    for g, s, p in zip(got, simple, pallas):
        np.testing.assert_allclose(g, _np(s), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, _np(p), rtol=1e-4, atol=1e-4)
    jx, tx = _x(m, m, k, jnp.bfloat16)
    got = TOPS.fused_qkv_plain(tx, *tws)
    for g, s in zip(got, JOPS.fused_qkv(jx, *jws, backend="grouped")):
        np.testing.assert_allclose(_np(g), _np(s), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("m", MS)
def test_fused_mlp_plain_matches_reference(precision, m):
    d, ff = 128, 256
    (jg, tg), (ju, tu) = (_pair(m + i, ff, d, precision, exact=True)
                          for i in (1, 2))
    jd, td = _pair(m + 3, d, ff, precision, exact=True)
    jx, tx = _x(m, m, d, jnp.float32)
    got = _np(TOPS.fused_mlp_plain(tx, tg, tu, td))
    np.testing.assert_allclose(
        got, _np(JOPS.fused_mlp(jx, jg, ju, jd, backend="simple")),
        rtol=1e-5, atol=1e-5)
    pallas = qmlp_pallas(jx, jg.data, jg.scale, ju.data, ju.scale, jd.data,
                         jd.scale, group=GROUP, precision=precision,
                         interpret=True)
    np.testing.assert_allclose(got, _np(pallas), rtol=1e-4, atol=1e-4)
    jx, tx = _x(m, m, d, jnp.bfloat16)
    np.testing.assert_allclose(
        _np(TOPS.fused_mlp_plain(tx, tg, tu, td)),
        _np(JOPS.fused_mlp(jx, jg, ju, jd, backend="grouped")),
        rtol=2e-2, atol=2e-2)


def test_mixed_weights_take_the_qdot_sequence():
    """Weights of different precisions (or raw) cannot share one fused
    launch: the entry points run the per-weight sequence, as JAX does."""
    (jq, tq), (jk, tk) = _pair(1, 64, 128, "int8"), _pair(2, 32, 128, "int4")
    wv = np.random.default_rng(3).standard_normal((32, 128)).astype(np.float32)
    jx, tx = _x(4, 3, 128, jnp.float32)
    got = TOPS.fused_qkv(tx, tq, tk, torch.from_numpy(wv))
    want = JOPS.fused_qkv(jx, jq, jk, jnp.asarray(wv), backend="simple")
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)
