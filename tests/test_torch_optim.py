"""The port's optimizer (``repro_torch.optim``) against the JAX package's.

Schedules: all three, at every step of a run and past it, within f32
rounding (1e-6 relative); one step late (a planted fault) is outside it.

AdamW, in each moment dtype: the JAX optimizer takes two steps, its state
is carried into the port through the bridge (``AdamWState``: the 0-d
count, f32 / bf16 moments, int8 ``QTensor`` moments, small or ragged
leaves f32), then both take one step on identical grads. Params within
rtol 1e-5 (``tests/test_optim.py:26``; atol 1e-7), f32 moments likewise,
bf16 moments within one bf16 step; int8 moments: payloads equal to the bit
on the first step from zero moments (each moment a single product there),
later within one level, with the count of differing levels printed and
under 1%. The planted fault, the port's step taken from the previous
count (a stale bias correction and learning rate), fails the params'
limit. The clip: the global norm within 1e-6, clipped grads likewise, and
the clip fused into the update equal to the bit to clipping first. A leaf
walked in slices equals the leaf walked whole, to the bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import schedule as JS
from repro_torch.bridge import from_jax
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedule as TS
from repro_torch.quant.qtypes import QTensor
from repro_torch.tree import tree_leaves

SCHED_RTOL = 1e-6
RTOL, ATOL = 1e-5, 1e-7
BF16_STEP = 2.0 ** -7


@pytest.mark.parametrize("name", ["cosine", "wsd", "linear"])
@pytest.mark.parametrize("warmup,total", [(3, 30), (10, 100), (0, 7)])
def test_schedule_matches_reference(name, warmup, total):
    jf = JS.make_schedule(name, base_lr=1e-3, warmup_steps=warmup,
                          total_steps=total)
    tf = TS.make_schedule(name, base_lr=1e-3, warmup_steps=warmup,
                          total_steps=total)
    steps = range(0, total + 3)
    want = np.array([float(jf(s)) for s in steps])
    got = np.array([float(tf(s)) for s in steps])
    got_t = np.array([float(tf(torch.tensor(s, dtype=torch.int32)))
                      for s in steps])
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=0)
    np.testing.assert_array_equal(got, got_t)
    late = np.array([float(tf(s + 1)) for s in steps])
    assert np.abs(late - want).max() > SCHED_RTOL * np.abs(want).max()


def _tree(rng, scale=1.0):
    """Matrices (int8-eligible and ragged), a stack and vectors."""
    return {"w": rng.standard_normal((4, 256)).astype(np.float32) * scale,
            "stack": {"a": rng.standard_normal((3, 2, 128)).astype(
                np.float32) * scale,
                      "ragged": rng.standard_normal((5, 24)).astype(
                          np.float32) * scale},
            "b": rng.standard_normal((7,)).astype(np.float32) * scale,
            "v128": rng.standard_normal((128,)).astype(np.float32) * scale}


def _opts(moment_dtype):
    sched = dict(base_lr=1e-2, warmup_steps=2, total_steps=10)
    return (JA.AdamW(learning_rate=JS.make_schedule("cosine", **sched),
                     moment_dtype=moment_dtype),
            TA.AdamW(learning_rate=TS.make_schedule("cosine", **sched),
                     moment_dtype=moment_dtype))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_np(tree) -> list:
    out = []
    for x in tree_leaves(tree):
        if isinstance(x, QTensor):
            out.append(("q", x.data.numpy(), x.scale.float().numpy()))
        else:
            out.append(("t", x.float().numpy()))
    return out


def _ref_run(moment_dtype, steps=2):
    """(params, state, next grads) of the JAX optimizer after ``steps``."""
    rng = np.random.default_rng(0)
    jopt, _ = _opts(moment_dtype)
    params = jax.tree.map(jnp.asarray, _tree(rng))
    state = jopt.init(params)
    for _ in range(steps):
        grads = jax.tree.map(jnp.asarray, _tree(rng, 0.1))
        params, state = jopt.update(grads, state, params)
    return params, state, jax.tree.map(jnp.asarray, _tree(rng, 0.1))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_step_matches_reference(moment_dtype):
    jopt, topt = _opts(moment_dtype)
    jp, js, jg = _ref_run(moment_dtype)
    tp, ts, tg = (from_jax(_np(t), "cpu") for t in (jp, js, jg))
    assert isinstance(ts, TA.AdamWState) and int(ts.count) == 2
    assert ts.count.dtype == torch.int32 and ts.count.ndim == 0
    # the fault first, on copies: the step taken from the previous count
    fp = from_jax(_np(jp), "cpu")
    fs = from_jax(_np(js), "cpu")
    fp, _ = topt.update(tg, fs._replace(count=fs.count - 1), fp)
    jp, js = jopt.update(jg, js, jp)
    tp, ts = topt.update(tg, ts, tp)
    assert int(ts.count) == int(js.count) == 3
    want_p = tree_leaves(from_jax(_np(jp), "cpu"))
    for got, want in zip(tree_leaves(tp), want_p):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert any(not np.allclose(f.numpy(), w.numpy(), rtol=RTOL, atol=ATOL)
               for f, w in zip(tree_leaves(fp), want_p))
    for name in ("m", "v"):
        got = _leaves_np(getattr(ts, name))
        want = _leaves_np(from_jax(_np(getattr(js, name)), "cpu"))
        assert [g[0] for g in got] == [w[0] for w in want]
        for g, w in zip(got, want):
            if g[0] == "q":
                dq = np.abs(g[1].astype(np.int32) - w[1].astype(np.int32))
                n = int((dq > 0).sum())
                print(f"{name}: {n} of {dq.size} int8 levels differ by 1")
                assert dq.max() <= 1 and n <= 0.01 * dq.size
                np.testing.assert_allclose(g[2], w[2], rtol=BF16_STEP)
            elif moment_dtype == "bfloat16":
                np.testing.assert_allclose(g[1], w[1], rtol=BF16_STEP,
                                           atol=1e-30)
            else:
                np.testing.assert_allclose(g[1], w[1], rtol=RTOL, atol=ATOL)


def test_int8_moments_first_step_equal_bits():
    """From zero moments the first step's moments are single products
    ((1 - b1) * g, (1 - b2) * g * g): the int8 payloads and scales equal
    the reference's to the bit, and the int8 layout is the reference's
    (QTensor leaves where the last axis is a multiple of 128)."""
    jopt, topt = _opts("int8")
    rng = np.random.default_rng(1)
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    jg = jax.tree.map(jnp.asarray, _tree(rng, 0.1))
    tp, tg = from_jax(_np(jp), "cpu"), from_jax(_np(jg), "cpu")
    ts = topt.init(tp)
    _, js = jopt.update(jg, jopt.init(jp), jp)
    _, ts = topt.update(tg, ts, tp)
    for name in ("m", "v"):
        got = _leaves_np(getattr(ts, name))
        want = _leaves_np(from_jax(_np(getattr(js, name)), "cpu"))
        assert [g[0] for g in got] == [w[0] for w in want] == \
            ["t", "q", "t", "q", "q"]
        for g, w in zip(got, want):
            for a, b in zip(g[1:], w[1:]):
                np.testing.assert_array_equal(a, b)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    jg = jax.tree.map(jnp.asarray, _tree(rng))
    tg = from_jax(_np(jg), "cpu")
    for max_norm in (1.0, 1e6):
        jc, jn = JA.clip_by_global_norm(jg, max_norm)
        tc, tn = TA.clip_by_global_norm(tg, max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for got, want in zip(tree_leaves(tc),
                             tree_leaves(from_jax(_np(jc), "cpu"))):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=0)
    # below the limit the grads are untouched, to the bit
    tc, _ = TA.clip_by_global_norm(tg, 1e6)
    for got, want in zip(tree_leaves(tc), tree_leaves(tg)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_fused_clip_and_slices_equal_bits(moment_dtype, monkeypatch):
    """``update(grad_scale=clip_scale(norm))`` equals clipping first, and a
    walk in slices of 2 rows equals the walk over whole leaves, to the
    bit (params and moments; one norm for all three runs)."""
    _, topt = _opts(moment_dtype)
    rng = np.random.default_rng(3)
    base = _tree(rng)
    grads = from_jax(_tree(rng, 3.0), "cpu")
    clipped, norm = TA.clip_by_global_norm(grads, 1.0)
    scale = TA.clip_scale(norm, 1.0)

    def run(g, grad_scale=None):
        params = from_jax(base, "cpu")
        params, state = topt.update(g, topt.init(params), params,
                                    grad_scale=grad_scale)
        return _leaves_np(params) + _leaves_np(state.m) + _leaves_np(state.v)

    want = run(clipped)
    fused = run(grads, scale)
    monkeypatch.setattr(TA, "SLICE_ELEMS", 256)
    for got in (fused, run(grads, scale)):
        for g, w in zip(got, want):
            for a, b in zip(g[1:], w[1:]):
                np.testing.assert_array_equal(a, b)
