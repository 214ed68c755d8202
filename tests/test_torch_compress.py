"""The port's int8 error-feedback gradient mean
(``repro_torch.optim.compress``) held to the JAX package's
``compressed_psum_mean`` on the CPU.

The reference runs inside ``shard_map`` over the data axes; here
``jax.vmap(..., axis_name="data")`` serves as the data axis (its ``pmax``
and ``psum`` reduce over the mapped positions, and nothing in the
reference's body changes). The port takes the same positions' trees in
position order. Held to the bit: each position's mean and new error, the
shared scale and the levels (through the error's identity ``corrected -
new_error == q * scale``). Beside it, the reference test's property (the
mean within 0.05 of the true mean, ``tests/test_sharding.py:223``), error
feedback keeping the bias of a 5-step running sum within half of one
step's scale (the telescoping identity), and a leaf whose size does not
divide the group (the padding).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compress import compressed_psum_mean as jcompressed
from repro_torch.optim.compress import compressed_psum_mean, init_error

torch.set_num_threads(2)

BOUND = 0.05        # the reference test's relative bound on the mean


def _inputs(n: int, shapes: dict, seed: int = 0, err_scale: float = 0.0):
    rng = np.random.default_rng(seed)
    grads = {k: (rng.standard_normal((n,) + s) * 0.1).astype(np.float32)
             for k, s in shapes.items()}
    errs = {k: (rng.standard_normal((n,) + s) * err_scale).astype(np.float32)
            for k, s in shapes.items()}
    return grads, errs


def _reference(grads: dict, errs: dict, group: int = 256):
    fn = functools.partial(jcompressed, axis_names=("data",), group=group)
    mean, err = jax.vmap(fn, axis_name="data")(grads, errs)
    return (jax.tree.map(np.asarray, mean), jax.tree.map(np.asarray, err))


def _port(grads: dict, errs: dict, group: int = 256):
    n = next(iter(grads.values())).shape[0]
    gs = [{k: torch.from_numpy(v[i].copy()) for k, v in grads.items()}
          for i in range(n)]
    es = [{k: torch.from_numpy(v[i].copy()) for k, v in errs.items()}
          for i in range(n)]
    return compressed_psum_mean(gs, es, group=group)


def _scale(grads: dict, errs: dict, key: str, group: int) -> np.ndarray:
    """The reference's shared scale: each group's absmax of g + e, the max
    over the positions, over 127 (jnp, as its body computes it)."""
    c = jnp.asarray(grads[key]) + jnp.asarray(errs[key])
    flat = c.reshape(c.shape[0], -1)
    pad = (-flat.shape[1]) % group
    gr = jnp.pad(flat, ((0, 0), (0, pad))).reshape(flat.shape[0], -1, group)
    return np.asarray(jnp.max(jnp.max(jnp.abs(gr), axis=-1), axis=0) / 127.0)


@pytest.mark.parametrize("n,err_scale", [(2, 0.0), (4, 0.003), (8, 0.0)])
def test_matches_reference_to_the_bit(n, err_scale):
    shapes = {"w": (16, 64), "b": (64,), "emb": (5, 128)}
    grads, errs = _inputs(n, shapes, seed=n, err_scale=err_scale)
    jmean, jerr = _reference(grads, errs)
    means, new_errs = _port(grads, errs)
    for i in range(n):
        for k in shapes:
            np.testing.assert_array_equal(means[i][k].numpy(), jmean[k][i])
            np.testing.assert_array_equal(new_errs[i][k].numpy(), jerr[k][i])
            assert torch.equal(means[i][k], means[0][k])
    # the levels times the shared scale: what each position's payload
    # carried (corrected - new error), equal to the bit on both sides, each
    # value a whole number of the reference's scale in [-127, 127]
    for k in shapes:
        scale = _scale(grads, errs, k, 256)
        for i in range(n):
            corrected = grads[k][i] + errs[k][i]
            carried = corrected - new_errs[i][k].numpy()
            np.testing.assert_array_equal(carried, corrected - jerr[k][i])
            flat = np.pad(carried.reshape(-1), (0, (-carried.size) % 256))
            q = flat.reshape(-1, 256) / np.where(scale == 0, 1,
                                                 scale)[:, None]
            assert np.abs(q).max() <= 127 + 1e-4
            np.testing.assert_allclose(q, np.round(q), atol=1e-4)


def test_mean_within_the_reference_bound():
    """The reference test: 8 positions of (64,) gradients, every position's
    mean within 0.05 of the true mean, relative to its largest entry."""
    grads, errs = _inputs(8, {"g": (64,)}, seed=0)
    want = grads["g"].mean(axis=0)
    means, _ = _port(grads, errs)
    for m in means:
        rel = np.abs(m["g"].numpy() - want).max() / (np.abs(want).max()
                                                     + 1e-9)
        assert rel < BOUND, rel


def test_error_feedback_bounds_the_bias():
    """Five steps of the same gradients: with error feedback the running
    sum of the means drifts from 5 x the true mean by minus the mean of the
    last errors (sum_t decoded = T g - e_T), within half of the last step's
    scale; without it, each step repeats the same rounding and the bias
    grows with the steps."""
    n, steps = 4, 5
    grads, _ = _inputs(n, {"g": (3, 200)}, seed=3)
    gs = [{"g": torch.from_numpy(grads["g"][i].copy())} for i in range(n)]
    want = grads["g"].mean(axis=0).astype(np.float64)
    errs = [init_error(g) for g in gs]
    total = np.zeros_like(want)
    no_ef = np.zeros_like(want)
    for _ in range(steps):
        means, errs = compressed_psum_mean(gs, errs)
        total += means[0]["g"].numpy()
        m0, _ = compressed_psum_mean(gs, [init_error(g) for g in gs])
        no_ef += m0[0]["g"].numpy()
    last = np.mean([e["g"].numpy() for e in errs], axis=0)
    np.testing.assert_allclose(total - steps * want, -last, atol=1e-5)
    bias = np.abs(total - steps * want).max()
    half_scale = np.abs(grads["g"] + 0).max() / 127 / 2
    assert bias <= half_scale * 1.01, (bias, half_scale)
    assert np.abs(no_ef - steps * want).max() > 2 * bias


@pytest.mark.parametrize("shape,group", [((3, 50), 256), ((7,), 4),
                                         ((130,), 128)])
def test_padding_of_a_ragged_leaf(shape, group):
    """A leaf whose size does not divide the group: the last group is
    padded with zeros and the padding dropped from the mean and the
    error, as the reference does."""
    grads, errs = _inputs(2, {"g": shape}, seed=11, err_scale=0.01)
    jmean, jerr = _reference(grads, errs, group)
    means, new_errs = _port(grads, errs, group)
    for i in range(2):
        assert tuple(means[i]["g"].shape) == shape
        np.testing.assert_array_equal(means[i]["g"].numpy(), jmean["g"][i])
        np.testing.assert_array_equal(new_errs[i]["g"].numpy(),
                                      jerr["g"][i])


def test_mean_keeps_the_gradient_dtype():
    """A bf16 gradient's mean comes back bf16 (the reference casts the
    decoded mean to g.dtype), its error f32; ``init_error`` is f32 zeros
    of the params' shapes."""
    g = [{"w": torch.randn(4, 256, generator=torch.Generator().manual_seed(i))
          .to(torch.bfloat16)} for i in range(2)]
    errs = [init_error(x) for x in g]
    assert errs[0]["w"].dtype == torch.float32
    assert not errs[0]["w"].any()
    means, new = compressed_psum_mean(g, errs)
    assert means[0]["w"].dtype == torch.bfloat16
    assert new[0]["w"].dtype == torch.float32
    with pytest.raises(ValueError):
        compressed_psum_mean(g, errs[:1])
