"""The port's synthetic data (``repro_torch.data.synthetic``) against the
JAX package's: tokens and labels to the bit over steps, seeds, shards and
vocabularies, whisper's frames to the bit (bf16 through a uint16 view),
and the loader's state round trip. A loader restored one step late
(a planted fault) gives other tokens."""

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.data import synthetic as JS
from repro_torch.configs.registry import get_config
from repro_torch.data import synthetic as TS


def _bits(x) -> np.ndarray:
    """bf16 (torch or jax) -> its uint16 bits; other dtypes as they are."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kw", [
    dict(batch=8, seq=64, vocab=512, step=0, seed=0),
    dict(batch=4, seq=17, vocab=500, step=3, seed=5),
    dict(batch=6, seq=9, vocab=128256, step=100_000, seed=0),
    dict(batch=8, seq=16, vocab=32000, step=7, seed=1, shard=1,
         num_shards=4),
])
def test_tokens_equal_reference_bits(kw):
    got = TS.synthetic_tokens(**kw)
    want = JS.synthetic_tokens(**kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-medium"])
def test_batch_equals_reference_bits(arch):
    """tokens, labels and (enc-dec) frames of one batch, bit for bit."""
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    got = TS.synthetic_batch(cfg, batch=4, seq=16, step=2, seed=3,
                             device="cpu")
    want = JS.synthetic_batch(jcfg, batch=4, seq=16, step=2, seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)
    assert got["tokens"].dtype == torch.int32
    if cfg.family == "encdec":
        assert got["frames"].dtype == torch.bfloat16
        assert tuple(got["frames"].shape) == (4, cfg.encoder_seq,
                                              cfg.d_model)


def test_loader_state_round_trips():
    """The port's loader follows the JAX loader step for step; a loader
    restored from its state() resumes the same stream, and one restored a
    step late (the planted fault) does not."""
    cfg = get_config("llama3.2-3b", smoke=True)
    jcfg = jget_config("llama3.2-3b", smoke=True)
    port = TS.DataLoader(cfg, global_batch=4, seq=8, seed=2, device="cpu")
    ref = JS.DataLoader(jcfg, global_batch=4, seq=8, seed=2)
    for _ in range(3):
        np.testing.assert_array_equal(next(port)["tokens"].numpy(),
                                      np.asarray(next(ref)["tokens"]))
    state = port.state()
    assert state == ref.state() == {"step": 3, "seed": 2}
    resumed = TS.DataLoader(cfg, global_batch=4, seq=8, device="cpu")
    resumed.restore(state)
    late = TS.DataLoader(cfg, global_batch=4, seq=8, device="cpu")
    late.restore({"step": state["step"] + 1, "seed": state["seed"]})
    want = next(port)["tokens"]
    assert torch.equal(next(resumed)["tokens"], want)
    assert not torch.equal(next(late)["tokens"], want)


def test_device_defaults_to_the_gpu():
    """No device: the GPU, which raises here rather than falling back."""
    cfg = get_config("llama3.2-3b", smoke=True)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.synthetic_batch(cfg, batch=2, seq=4, step=0)
