"""The port's entropy kernel path (``kernels/entropy``, ``mode="kernel"``)
against the JAX package: the plain version against ``entropy_pallas`` in
interpret mode and ``entropy_ref`` at the reference test's shapes and
dtypes, within its tolerance 1e-3 * max(1, |H|) (tests/test_kernels.py:
24-41); then ``analyze_blocks(mode="kernel")`` and the 4bit/8bit plan on
the SMOKE llama and whisper models against the reference's kernel mode
(``entropy_ref`` on the CPU), per block within 1e-5 relative (f32, one
formula on both sides), with the same decisions. The CUDA kernel is held
to the plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import entropy as JE
from repro.core import planner as JP
from repro.kernels.entropy.kernel import CHUNK, entropy_pallas
from repro.kernels.entropy.ref import entropy_ref
from repro.models.model import build as jbuild
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.core import entropy as TE
from repro_torch.core import planner as TP
from repro_torch.kernels.entropy import ops as E
from repro_torch.models.model import build

torch.set_num_threads(2)


def _pair(shape, dtype, seed, scale=0.7):
    w = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(torch.bfloat16 if dtype == jnp.bfloat16
                                else torch.float32)
    return jw, tw


@pytest.mark.parametrize("shape", [(7,), (1024,), (CHUNK,), (CHUNK + 3,),
                                   (3 * CHUNK,), (123, 45), (256, 128)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_entropy_plain_matches_reference(shape, dtype):
    jw, tw = _pair(shape, dtype, seed=int(np.prod(shape)))
    got = float(E.matrix_entropy(tw))
    for want in (float(entropy_pallas(jw, interpret=True)),
                 float(entropy_ref(jw))):
        assert abs(got - want) < 1e-3 * max(1.0, abs(want))
    assert float(TE.matrix_entropy(tw, mode="kernel")) == got


@pytest.mark.parametrize("n,scale", [(1, 1.0), (4999, 0.01), (777, 5.0)])
def test_entropy_plain_matches_reference_property_points(n, scale):
    """Points of the reference's property test (sizes 1-5000, scales
    0.01-5; tolerance 2e-3 * max(1, |H|))."""
    jw, tw = _pair((n,), jnp.float32, seed=n, scale=scale)
    want = float(entropy_pallas(jw, interpret=True))
    assert abs(float(E.matrix_entropy(tw)) - want) < \
        2e-3 * max(1.0, abs(want))


def test_entropy_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        E.entropy_cuda(torch.ones(8))


@pytest.fixture(scope="module")
def smoke_models():
    out = {}
    for arch in ("llama3.2-3b", "whisper-medium"):
        jmodel = jbuild(jget_config(arch, smoke=True))
        jparams = jmodel.init(jax.random.PRNGKey(5))
        tparams = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        out[arch] = (jmodel, jparams, build(get_config(arch, smoke=True)),
                     tparams)
    return out


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-medium"])
def test_kernel_mode_analysis_and_plan_match_reference(smoke_models, arch):
    jmodel, jparams, tmodel, tparams = smoke_models[arch]
    jblocks = jmodel.block_params(jparams)
    tblocks = tmodel.block_params(tparams)
    assert len(tblocks) == len(jblocks)
    jents = JE.analyze_blocks(jblocks, mode="kernel", first_exec_index=1)
    tents = TE.analyze_blocks(tblocks, mode="kernel", first_exec_index=1)
    for je, te in zip(jents, tents):
        assert te.num_parameters == je.num_parameters
        assert sorted(te.per_matrix) == sorted(je.per_matrix)
        assert te.entropy == pytest.approx(je.entropy, rel=1e-5)
    jplan = JP.plan_model(jmodel, jparams, variant="4bit/8bit", mode="kernel")
    tplan = TP.plan_model(tmodel, tparams, variant="4bit/8bit", mode="kernel")
    assert tplan.precisions() == jplan.precisions()
    assert tplan.threshold == pytest.approx(jplan.threshold, rel=1e-5)
