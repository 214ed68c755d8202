"""Weight and KV-cache quantization of the PyTorch port against the JAX
reference: payloads and bf16 scales bit for bit, dequantization and the
segment layout equal."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import BlockDecision, QuantPlan
from repro.quant import apply as JA
from repro.quant import kvcache as JKV
from repro_torch.bridge import from_jax, to_torch
from repro_torch.core.policy import QuantPlan as TQuantPlan
from repro_torch.quant import apply as TA
from repro_torch.quant import kvcache as TKV
from repro_torch.quant import quantize as TQ

JQ = importlib.import_module("repro.quant.quantize")

torch.set_num_threads(2)


def _bits(a):
    """Raw bytes of a numpy/JAX/torch array (bf16 compared bit for bit)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.cpu().numpy().tobytes()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return a.tobytes()


def _weights(seed, shape, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("precision", ["int8", "int4", "ternary", "int3"])
@pytest.mark.parametrize("shape,group", [((96, 256), 128), ((3, 40, 128), 64),
                                          ((16, 512), 32)])
def test_weight_quantization_bit_exact(precision, shape, group):
    w = _weights(len(precision) * 1000 + shape[-1] + len(shape), shape)
    w[0, :group] = 0.0                          # an all-zero group: scale 0
    jq = JQ.quantize(jnp.asarray(w), precision, group)
    tq = TQ.quantize(torch.from_numpy(w), precision, group)
    assert tq.precision == jq.precision and tq.shape == tuple(jq.shape)
    assert _bits(tq.data) == _bits(jq.data)
    assert _bits(tq.scale) == _bits(jq.scale)
    for dtype, tdt in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        assert _bits(TQ.dequantize(tq, tdt)) == _bits(JQ.dequantize(jq, dtype))


def test_int4_unpack_matches_reference():
    packed = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    got = TQ.unpack_int4(torch.from_numpy(packed)).numpy()
    want = np.asarray(JQ.unpack_int4(jnp.asarray(packed)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("precision", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("shape,group", [((2, 24, 2, 32), 32),
                                          ((3, 1, 4, 16), 64)])
def test_kv_quantization_bit_exact(precision, shape, group):
    x = _weights(7, shape, 1.5)
    x[0, 0] = 0.0
    jd, js = JKV.quantize_kv(jnp.asarray(x), precision, group)
    td, ts = TKV.quantize_kv(torch.from_numpy(x), precision, group)
    assert _bits(td) == _bits(jd)
    assert (ts is None) == (js is None)
    if ts is not None:
        assert _bits(ts) == _bits(js)
    jp = JKV.make_page(jnp.asarray(x), precision, group)
    tp = TKV.make_page(torch.from_numpy(x), precision, group)
    assert _bits(TKV.dequantize_kv(tp)) == _bits(JKV.dequantize_kv(jp))
    assert tp.num_kv_heads == jp.num_kv_heads


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_kv_page_writes_match_reference(precision):
    """update_page (per-slot positions, clamped at the cache end) and
    insert_slot write the same bytes as the reference."""
    b, s, hkv, hd, group = 3, 10, 2, 16, 32
    raw = _weights(3, (2, b, s, hkv, hd), 1.0)
    jpage = JKV.make_page(jnp.asarray(raw), precision, group)
    tpage = TKV.make_page(torch.from_numpy(raw), precision, group)
    new = _weights(4, (b, 1, hkv, hd), 1.0)
    pos = np.array([0, 4, 12], np.int32)           # 12: past the end
    jl = JKV.update_page(jax.tree.map(lambda x: x[1], jpage),
                         jnp.asarray(new), jnp.asarray(pos))
    tl = TKV.update_page(tpage.layer(1), torch.from_numpy(new),
                         torch.from_numpy(pos))
    assert _bits(tl.data) == _bits(jl.data)
    assert _bits(tl.scale) == _bits(jl.scale)
    assert _bits(tpage.data[1]) == _bits(jl.data)   # the view wrote through
    src = _weights(5, (2, 1, s, hkv, hd), 1.0)
    jf = JKV.insert_slot(jpage, jnp.asarray(src), 1)
    tf = TKV.insert_slot(tpage, torch.from_numpy(src), 1)
    assert _bits(tf.data[:, 1]) == _bits(jf.data[:, 1])
    assert _bits(tf.scale[:, 1]) == _bits(jf.scale[:, 1])


def _plan(cls_plan, cls_dec, precisions):
    ds = [cls_dec(block_index=i, exec_index=i + 1, entropy=0.0,
                  num_parameters=0, precision=p)
          for i, p in enumerate(precisions)]
    return cls_plan(decisions=ds, mu=0.0, sigma=0.0, threshold=0.0,
                    x_factor=1.0)


@pytest.mark.parametrize("precisions,cuts", [
    (["int8", "int8", "raw", "int4", "int4", "ternary"], ()),
    (["raw"] * 4, ()),
    (["int8"] * 6, (2, 4)),
])
def test_segments_and_stacked_plan_match_reference(precisions, cuts):
    from repro_torch.core.policy import BlockDecision as TBD
    jplan = _plan(QuantPlan, BlockDecision, precisions)
    tplan = _plan(TQuantPlan, TBD, precisions)
    assert TA.plan_segments(tplan, cuts) == JA.plan_segments(jplan, cuts)
    n = len(precisions)
    stacked = {"w": _weights(9, (n, 32, 128)), "ln": np.ones((n, 128),
                                                             np.float32)}
    jseg = JA.apply_plan_stacked(jax.tree.map(jnp.asarray, stacked), jplan,
                                 group=64, cuts=cuts)
    tseg = TA.apply_plan_stacked({k: torch.from_numpy(v)
                                  for k, v in stacked.items()}, tplan,
                                 group=64, cuts=cuts)
    bridged = from_jax(jax.tree.map(np.asarray, jseg))
    assert len(tseg.segments) == len(bridged.segments)
    for ts, bs in zip(tseg.segments, bridged.segments):
        assert (ts.precision, ts.start, ts.stop) == (bs.precision, bs.start,
                                                     bs.stop)
        for key in ("w", "ln"):
            a, b = ts.params[key], bs.params[key]
            if isinstance(a, torch.Tensor):
                assert _bits(a) == _bits(b)
            else:
                assert _bits(a.data) == _bits(b.data)
                assert _bits(a.scale) == _bits(b.scale)
    assert [(lo, hi) for _, lo, hi in TA.segment_slices(tseg)] == \
        [(lo, hi) for _, lo, hi in JA.segment_slices(jseg)]
    assert TA.segment_slices({"w": torch.zeros(n, 2)})[0][1:] == (0, n)
    assert tseg.nbytes_effective() == pytest.approx(jseg.nbytes_effective())


def test_bridge_carries_bf16_bit_exact():
    w = jnp.asarray(_weights(1, (8, 16))).astype(jnp.bfloat16)
    t = to_torch(np.asarray(w))
    assert t.dtype == torch.bfloat16 and _bits(t) == _bits(w)
