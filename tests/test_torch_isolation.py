"""The PyTorch port stands alone: no JAX, no import of the JAX package, and
no quiet fallback from the GPU to the CPU."""

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
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "", out.stdout


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\."
                        r"|from\s+repro\.|import\s+repro\s*$"
                        r"|from\s+repro\s+import)", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
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
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build
    for arch in ("mamba2-780m", "zamba2-2.7b", "whisper-medium",
                 "grok-1-314b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build(get_config(arch, smoke=True))
