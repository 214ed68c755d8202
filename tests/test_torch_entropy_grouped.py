"""The grouped entropy kernel's plan (``kernels/entropy``) against the JAX
package on the CPU.

``entropy_tiled_plain`` runs the CUDA kernel's plan in plain PyTorch: every
array cut into tiles of TILE elements (a tile never spans two arrays),
each tile's (max, Z, S), each array's partials merged in the kernel's
pass-2 order (``merge_partials``). It, ``entropy_many_plain`` and
``analyze_blocks(mode="kernel")`` (every matrix of every block in one
grouped call) are held to ``entropy_ref`` and ``entropy_pallas`` in
interpret mode within the reference test's 1e-3 * max(1, |H|)
(tests/test_kernels.py:32), and the plan to a float64 closed form within
2e-5: arrays smaller than one tile, one element either side of a tile
boundary, ragged tails, more tiles than the merge has threads, bf16 and
f32 in one list. An array's H does not depend on the rest of the list.
Stream mode over many thousands of chunks stays within 1e-6 of the
float64 closed form.
A list with a CUDA tensor never takes the plain version, and one longer
than a launch holds is cut into launches. The CUDA kernel itself is held
to the plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import entropy as JE
from repro.kernels.entropy.kernel import entropy_pallas
from repro.kernels.entropy.ref import entropy_ref
from repro.models.model import build as jbuild
from repro_torch.bridge import from_jax
from repro_torch.configs.registry import get_config
from repro_torch.core import entropy as TE
from repro_torch.kernels.entropy import ops as E
from repro_torch.models.model import build

torch.set_num_threads(2)

T = E.TILE


def _pair(shape, dtype, seed, scale=0.7):
    w = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(torch.bfloat16 if dtype == jnp.bfloat16
                                else torch.float32)
    return jw, tw


def _closed_form_f64(tw) -> float:
    x = tw.reshape(-1).double()
    m = x.max()
    e = torch.exp(x - m)
    return float((m + torch.log(e.sum())) - (x * e).sum() / e.sum())


def _close(got, want, tol=1e-3):
    assert abs(got - want) < tol * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("shape", [(7,), (1000,), (T - 1,), (T,), (T + 1,),
                                   (2 * T - 1,), (3 * T + 5,), (123, 45)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_tiled_plan_matches_reference(shape, dtype):
    jw, tw = _pair(shape, dtype, seed=int(np.prod(shape)))
    got = float(E.entropy_tiled_plain([tw])[0])
    for want in (float(entropy_pallas(jw, interpret=True)),
                 float(entropy_ref(jw))):
        _close(got, want)
    assert abs(got - _closed_form_f64(tw)) < 2e-5


@pytest.mark.parametrize("n,tile", [(64 * 1500 + 3, 64), (33 * 2048, 32),
                                    (5, 64)])
def test_merge_runs_of_many_partials(n, tile):
    """More tiles than the merge has threads (runs of 2-3 partials a
    thread, the last run short), and fewer than one warp."""
    assert E.tile_plan([n], tile)[-1] == -(-n // tile)
    jw, tw = _pair((n,), jnp.float32, seed=n, scale=2.0)
    got = float(E.entropy_tiled_plain([tw], tile)[0])
    _close(got, float(entropy_ref(jw)))
    assert abs(got - _closed_form_f64(tw)) < 2e-5


@pytest.mark.parametrize("n,chunk", [(1 << 22, 256), (1 << 21, 64)])
def test_stream_mode_over_many_chunks_matches_f64(n, chunk):
    """Stream mode (``matrix_entropy_stream``) over 16384 and 32768 chunks,
    as an MoE expert stack of billions of elements is in its default
    chunks: its running Z and S merge in f64, so H stays within 1e-6 of
    the float64 closed form (about 2e-7 here; a running merge in f32 read
    5e-6 to 7e-6 on these arrays)."""
    _, tw = _pair((n,), jnp.bfloat16, seed=5, scale=1.0)
    got = float(TE.matrix_entropy_stream(tw, chunk))
    assert abs(got - _closed_form_f64(tw)) < 1e-6


def test_mixed_list_each_matches_reference_and_alone():
    """bf16 and f32 in one list, sizes on and off tile boundaries: each H
    within the reference's tolerance, and equal to the bit to the same
    array's H in a list of one (the plan gives it the same tiles and the
    same merge whatever else the list holds)."""
    specs = [((T,), jnp.bfloat16), ((5,), jnp.float32),
             ((T + 1,), jnp.float32), ((64, 300), jnp.bfloat16),
             ((2 * T - 1,), jnp.bfloat16), ((1,), jnp.float32)]
    pairs = [_pair(shape, dt, seed=i) for i, (shape, dt) in enumerate(specs)]
    group = E.entropy_tiled_plain([tw for _, tw in pairs])
    plain = E.entropy_many_plain([tw for _, tw in pairs])
    assert group.dtype == plain.dtype == torch.float32
    assert group.shape == plain.shape == (len(specs),)
    for i, (jw, tw) in enumerate(pairs):
        want = float(entropy_ref(jw))
        _close(float(group[i]), want)
        _close(float(plain[i]), want)
        _close(float(plain[i]), float(entropy_pallas(jw, interpret=True)))
        assert torch.equal(group[i], E.entropy_tiled_plain([tw])[0])
    reordered = E.entropy_tiled_plain([tw for _, tw in pairs[::-1]])
    assert torch.equal(reordered, group.flip(0))


def test_tile_plan_first_tiles():
    assert E.tile_plan([1, T, T + 1, 3 * T]) == [0, 1, 2, 4, 7]
    assert E.tile_plan([]) == [0]
    assert E.tile_plan([10, 11], tile=5) == [0, 2, 5]


def test_entropy_many_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        E.entropy_many([torch.ones(8)])
    with pytest.raises(ValueError, match="CUDA"):
        E.entropy_cuda(torch.ones(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="empty"):
        E.entropy_many([torch.ones(0)])
    with pytest.raises(TypeError, match="bf16 or f32"):
        E.entropy_many([torch.ones(8, dtype=torch.float16)])
    with pytest.raises(ValueError, match="no arrays"):
        E.entropy_many([])


class _OnCard:
    """Stands in for a contiguous bf16 CUDA tensor, which the CPU cannot
    make: what ``entropies`` and the kernel's checks read of one, and the
    CPU tensor ``t`` it holds."""

    is_cuda = True
    dtype = torch.bfloat16
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t = t

    def numel(self):
        return self.t.numel()

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0

    def get_device(self):
        return 0


def test_entropies_refuses_a_mixed_list():
    """A list holding any CUDA tensor goes to the kernel, which raises on
    a CPU tensor among them: the CUDA ones never take the plain version."""
    cpu = torch.ones(8, dtype=torch.bfloat16)
    for ws in ([_OnCard(cpu), cpu], [cpu, _OnCard(cpu)]):
        with pytest.raises(ValueError, match="CUDA"):
            E.entropies(ws)
    assert torch.equal(E.entropies([cpu, cpu]),
                       E.entropy_many_plain([cpu, cpu]))


def test_entropies_cuts_long_lists_into_launches(monkeypatch):
    """Past MAX_ARRAYS arrays, ``entropies`` makes one launch a run of
    MAX_ARRAYS, in order; as an array's H does not depend on the rest of
    its launch, the result equals one launch over the whole list to the
    bit (the launch here is the kernel's plan, ``entropy_tiled_plain``)."""
    ts = [_pair((n,), jnp.bfloat16, seed=n)[1]
          for n in (7, T - 1, T + 1, 300, 2 * T, 5, 64)]
    launches = []

    def launch(ws):
        launches.append(len(ws))
        return E.entropy_tiled_plain([w.t for w in ws])

    monkeypatch.setattr(E, "MAX_ARRAYS", 3)
    monkeypatch.setattr(E, "entropy_many", launch)
    got = E.entropies([_OnCard(t) for t in ts])
    assert launches == [3, 3, 1]
    assert torch.equal(got, E.entropy_tiled_plain(ts))
    launches.clear()
    E.entropies([_OnCard(t) for t in ts[:3]])
    assert launches == [3]


def test_entropy_many_refuses_more_than_one_launch_holds():
    with pytest.raises(ValueError, match="at most"):
        E.entropy_many([_OnCard(torch.ones(8))] * (E.MAX_ARRAYS + 1))


@pytest.fixture(scope="module")
def smoke_models():
    out = {}
    for arch in ("llama3.2-3b", "whisper-medium", "zamba2-2.7b",
                 "mamba2-780m"):
        jmodel = jbuild(jget_config(arch, smoke=True))
        jparams = jmodel.init(jax.random.PRNGKey(7))
        tparams = from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        out[arch] = (jmodel, jparams, build(get_config(arch, smoke=True)),
                     tparams)
    return out


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-medium",
                                  "zamba2-2.7b", "mamba2-780m"])
def test_grouped_kernel_mode_analysis(smoke_models, arch):
    """Kernel mode gathers every matrix of every block into one call: the
    same matrices, sizes and per-block entropies as the reference's kernel
    mode (1e-5 relative), each block exactly the per-matrix path's
    weighting of the same entropies, and each matrix's entropy the tiled
    plan's within the reference's tolerance."""
    jmodel, jparams, tmodel, tparams = smoke_models[arch]
    jblocks = jmodel.block_params(jparams)
    tblocks = tmodel.block_params(tparams)
    jents = JE.analyze_blocks(jblocks, mode="kernel", first_exec_index=1)
    tents = TE.analyze_blocks(tblocks, mode="kernel", first_exec_index=1)
    assert len(tents) == len(jents) == len(tblocks)
    mats = []
    for je, te, blk in zip(jents, tents, tblocks):
        assert te.num_parameters == je.num_parameters
        assert list(te.per_matrix) == sorted(je.per_matrix)
        assert te.entropy == pytest.approx(je.entropy, rel=1e-5)
        h, n, per = TE.block_entropy_from_matrices(
            TE.flatten_block_params(blk), mode="kernel")
        assert (h, n, per) == (te.entropy, te.num_parameters, te.per_matrix)
        mats += [w for _, w in TE._block_matrices(
            TE.flatten_block_params(blk))]
    tiled = E.entropy_tiled_plain(mats).tolist()
    hs = [h for te in tents for h, _ in te.per_matrix.values()]
    assert len(tiled) == len(hs)
    for got, want in zip(tiled, hs):
        _close(got, want)
