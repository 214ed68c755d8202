"""The PyTorch port stands alone: no JAX, no ``ml_dtypes`` (the card's
machine has none; bf16 goes to and from disk through a uint16 view), no
import of the JAX package, and no quiet fallback from the GPU to the CPU."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, importlib\n"
            f"for m in {_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
            "or m == 'ml_dtypes')\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "", out.stdout


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\."
                        r"|from\s+repro\.|import\s+repro\s*$"
                        r"|from\s+repro\s+import"
                        r"|import\s+ml_dtypes\b|from\s+ml_dtypes\b)", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]
    + [str(p.relative_to(ROOT)) for p in (ROOT / "scripts").glob("*.py")]))
def test_source_never_imports_jax_or_reference(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(src), path


def test_engine_without_gpu_raises(monkeypatch):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build
    from repro_torch.serving.engine import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(get_config("llama3.2-3b", smoke=True))
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params, max_seq=32)
    ServeEngine(model, params, max_seq=32, device="cpu")   # explicit: fine


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper never runs its kernel's plain version for a GPU call, and
    never takes a CPU tensor into the kernel."""
    from repro_torch.kernels.qmatmul import ops as QM
    from repro_torch.quant.quantize import quantize
    w = quantize(torch.randn(64, 128), "int8")
    with pytest.raises(ValueError, match="CUDA"):
        QM.qmatmul_cuda(torch.randn(2, 128), w)


def test_other_families_name_their_roadmap_item():
    """Every family of the JAX package builds in the port, MoE included
    (the ROADMAP item "the other families" is closed): grok-1 and arctic
    at full width on the meta device (no memory), and each family's SMOKE
    config on the CPU, whose forward gives finite logits. The families
    are held to the reference in tests/test_torch_moe.py,
    test_torch_encdec.py, test_torch_ssm.py and test_torch_hybrid.py."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build
    archs = ("llama3.2-3b", "grok-1-314b", "arctic-480b", "mamba2-780m",
             "zamba2-2.7b", "whisper-medium")
    assert {get_config(a).family for a in archs} == {
        "dense", "moe", "ssm", "hybrid", "encdec"}
    for arch in ("grok-1-314b", "arctic-480b"):
        cfg = get_config(arch)
        params = build(cfg).init(torch.Generator().manual_seed(0), "meta")
        w = params["layers"]["moe"]["w_gate"]
        assert tuple(w.shape) == (cfg.num_layers, cfg.num_experts,
                                  cfg.expert_d_ff, cfg.d_model)
        assert ("mlp" in params["layers"]) == cfg.dense_residual
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        toks = torch.zeros((1, 3), dtype=torch.long)
        frames = (torch.zeros((1, cfg.encoder_seq, cfg.d_model),
                              dtype=torch.bfloat16)
                  if cfg.family == "encdec" else None)
        assert torch.isfinite(model.apply(params, toks, frames=frames)).all()
