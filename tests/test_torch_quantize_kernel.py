"""The port's group-wise int8 quantization (``kernels/quantize``) against
the JAX package at the reference test's shapes (tests/test_kernels.py:
75-84): payload and f32 scales bit-identical to ``quantize_int8_ref``;
against ``quantize_int8_pallas`` in interpret mode, the payload equal and
the scales within the reference test's rtol 1e-6. The interpreted Pallas
kernel's scales are not the correctly rounded quotient absmax / 127 (they
differ from its own ``quantize_int8_ref`` in the last bit), so a weight
that sits on a half level after the division can round the other way
there (``test_quantize_int8_ties_match_ref``; ROADMAP.md section 3). The
CUDA kernel is held bit for bit to the plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize.kernel import quantize_int8_pallas
from repro.kernels.quantize.ref import quantize_int8_ref
from repro_torch.kernels.quantize import ops as Q

torch.set_num_threads(2)


def _weight(n, k, dtype, seed, tie=False):
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.3
         ).astype(np.float32)
    w[0, :128] = 0.0                       # an all-zero group divides by 1
    if tie:                                # w / scale lands on 63.5
        w[1, 5] = 0.5 * float(np.abs(w[1, :128]).max())
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(torch.bfloat16 if dtype == jnp.bfloat16
                                else torch.float32)
    return jw, tw


SHAPES = [(128, 256, 128, 128), (256, 512, 128, 256), (512, 1024, 256, 512)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("n,k,bn,bk", SHAPES)
def test_quantize_int8_plain_matches_reference(n, k, bn, bk, dtype):
    jw, tw = _weight(n, k, dtype, seed=n + k)
    q, s = Q.quantize_int8(tw)
    qr, sr = quantize_int8_ref(jw)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (n, k // 128)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


@pytest.mark.parametrize("n,k,bn,bk", SHAPES)
def test_quantize_int8_plain_matches_pallas_interpret(n, k, bn, bk):
    """f32 weights, as the reference's own kernel test uses (on bf16
    weights the interpreted kernel and ``quantize_int8_ref`` already
    disagree on a payload element at the first shape)."""
    jw, tw = _weight(n, k, jnp.float32, seed=n + k)
    q, s = Q.quantize_int8(tw)
    qk, sk = quantize_int8_pallas(jw, bn=bn, bk=bk, interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qk))
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_int8_ties_match_ref(dtype):
    """A weight at half the group's absmax divides to 63.5 up to the last
    bit of the scale: the port rounds it as ``quantize_int8_ref`` does."""
    jw, tw = _weight(128, 256, dtype, seed=384, tie=True)
    q, s = Q.quantize_int8(tw)
    qr, sr = quantize_int8_ref(jw)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


@pytest.mark.parametrize("group", [32, 64])
def test_quantize_int8_other_groups_match_reference(group):
    jw, tw = _weight(64, 256, jnp.float32, seed=group)
    q, s = Q.quantize_int8(tw, group)
    qr, sr = quantize_int8_ref(jw, group=group)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


def test_quantize_int8_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never quietly runs the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        Q.quantize_int8_cuda(torch.zeros(4, 128))
