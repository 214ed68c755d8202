"""The fused MLP's f32 reference, ``fused_mlp_f32`` (what chip_smoke.py holds
the CUDA kernel to, within QMLP_F32), against the JAX ``qmlp_pallas`` in
interpret mode at the SMOKE width (d_model 128, d_ff 256), in both forms and
all three precisions, at M = 1, 4 and a ragged 7.

Both compute the same thing: x in f32, every weight dequantized to f32
(levels times bf16 scales, exact in f32), the hidden kept in f32; only the
order of the f32 sums and the last bits of silu / tanh may differ. So the
tolerance is 1e-5 relative to the output's largest magnitude, on f32 x and
on bf16 x alike (both cast bf16 x to f32 exactly before the products).

Also: ``fused_mlp`` on a CPU tensor takes the plain version (no kernel
launch), and the kernel wrapper refuses a CPU tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qmatmul.kernel import qmlp_pallas
from repro.quant.quantize import quantize as jquantize
from repro_torch.bridge import from_jax
from repro_torch.kernels import build
from repro_torch.kernels.qmatmul import ops as TOPS

torch.set_num_threads(2)

D, FF, GROUP = 128, 256, 64
PRECISIONS = ("int8", "int4", "ternary")
REL = 1e-5


def _weights(seed, form, precision):
    """(JAX QTensors, port QTensors) of gate (None for gelu), up, down,
    quantized by the JAX package from numpy-seeded weights."""
    rng = np.random.default_rng(seed)
    shapes = [(FF, D), (FF, D), (D, FF)]
    if form == "gelu":
        shapes = shapes[1:]
    jws = [jquantize(jnp.asarray((rng.standard_normal(s) / s[1] ** 0.5)
                                 .astype(np.float32)), precision, GROUP)
           for s in shapes]
    tws = [from_jax(jax.tree.map(np.asarray, w), device="cpu") for w in jws]
    if form == "gelu":
        return [None, *jws], [None, *tws]
    return jws, tws


def _x(seed, m, dtype):
    x = (np.random.default_rng(seed).standard_normal((m, D)) * 0.5
         ).astype(np.float32)
    if dtype == "bfloat16":
        tx = torch.from_numpy(x).to(torch.bfloat16)
        return jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16), tx
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("m", (1, 4, 7))
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("form", ("swiglu", "gelu"))
def test_f32_reference_matches_pallas_interpret(form, precision, m, dtype):
    (jg, ju, jd), (tg, tu, td) = _weights(m + len(precision), form,
                                          precision)
    jx, tx = _x(m, m, dtype)
    got = TOPS.fused_mlp_f32(tx, tg, tu, td, act=form)
    assert got.dtype == torch.float32 and got.shape == (m, D)
    gate = (None, None) if jg is None else (jg.data, jg.scale)
    want = np.asarray(qmlp_pallas(jx, *gate, ju.data, ju.scale, jd.data,
                                  jd.scale, group=GROUP, precision=precision,
                                  act=form, bf=128, interpret=True))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=REL, atol=REL * scale)


@pytest.mark.parametrize("form", ("swiglu", "gelu"))
def test_fused_mlp_on_cpu_takes_the_plain_path(form, monkeypatch):
    _, (tg, tu, td) = _weights(3, form, "int8")
    _, tx = _x(5, 4, "bfloat16")

    def no_kernel(*a, **k):
        raise AssertionError("the kernel wrapper ran for a CPU tensor")

    monkeypatch.setattr(TOPS, "qmlp_cuda", no_kernel)
    build.reset_launches()
    got = TOPS.fused_mlp(tx, tg, tu, td, act=form)
    assert build.LAUNCHES["qmlp"] == build.LAUNCHES["qmlp_gelu"] == 0
    want = TOPS.fused_mlp(tx, tg, tu, td, act=form, plain=True)
    assert got.dtype == tx.dtype and torch.equal(got, want)
    # the plain path rounds h to x's dtype; the f32 reference does not
    ref = TOPS.fused_mlp_f32(tx, tg, tu, td, act=form)
    torch.testing.assert_close(got.float(), ref, rtol=2e-2, atol=2e-2)


def test_kernel_wrapper_refuses_a_cpu_tensor():
    _, (tg, tu, td) = _weights(4, "swiglu", "int8")
    _, tx = _x(6, 4, "bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        TOPS.qmlp_cuda(tx, tg, tu, td)
