"""The PyTorch port stands alone: no JAX, no ``ml_dtypes`` (the card's
machine has none; bf16 goes to and from disk through a uint16 view), no
import of the JAX package (the observability layer, ``repro_torch.obs``,
included), and no quiet fallback from the GPU to the CPU. Its launcher
traces, meters and profiles a serve in a process that never loads JAX."""

import json
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


def test_scans_cover_the_obs_package():
    """The import and source scans above reach the observability layer:
    each of its modules, the facade included."""
    obs = {"repro_torch.obs.metrics", "repro_torch.obs.trace",
           "repro_torch.obs.profile", "repro_torch.obs.serve_metrics",
           "repro_torch.obs.render"}
    assert obs <= set(_MODULES)
    assert (PORT / "obs" / "__init__.py").is_file()


def test_scans_cover_the_sharding_package():
    """The import and source scans above reach mesh serving: the meshes,
    the sharding rules, the activation context and the collectives."""
    sharding = {"repro_torch.launch.mesh", "repro_torch.sharding.specs",
                "repro_torch.sharding.ctx", "repro_torch.sharding.collective"}
    assert sharding <= set(_MODULES)
    assert (PORT / "sharding" / "__init__.py").is_file()


def test_scans_cover_the_compress_module():
    """The import and source scans above reach the int8 error-feedback
    gradient mean, and mesh training's modules."""
    assert {"repro_torch.optim.compress", "repro_torch.optim.adamw",
            "repro_torch.train.step", "repro_torch.train.loop"} \
        <= set(_MODULES)
    assert (PORT / "optim" / "compress.py").is_file()


def test_scans_cover_the_fastewq_modules():
    """The import and source scans above reach FastEWQ, its classifiers
    and Algorithms 1 and 2 (each a numpy copy of the JAX package's)."""
    core = {"repro_torch.core.fastewq", "repro_torch.core.cluster",
            "repro_torch.core.dataset"} | {
        f"repro_torch.core.classifiers.{m}" for m in (
            "scaler", "tree", "rf", "boosted", "linear", "knn", "gnb",
            "metrics")}
    assert core <= set(_MODULES)
    assert (PORT / "core" / "classifiers" / "__init__.py").is_file()


def test_scans_cover_the_training_modules():
    """The import and source scans above reach the training path: the
    optimizer, the train step and loop, the synthetic data, the fault
    runtime and the training launcher (each a copy of the JAX package's
    on torch and numpy)."""
    training = {"repro_torch.optim.adamw", "repro_torch.optim.schedule",
                "repro_torch.train.step", "repro_torch.train.loop",
                "repro_torch.data.synthetic", "repro_torch.runtime.fault",
                "repro_torch.launch.train", "repro_torch.launch.steps"}
    assert training <= set(_MODULES)
    for pkg in ("optim", "train", "data", "runtime"):
        assert (PORT / pkg / "__init__.py").is_file()


def _open_spans(events: list) -> list:
    """Replays a Chrome trace's B/E events per (pid, tid) track and returns
    what is left open."""
    stacks: dict = {}
    for ev in events:
        key = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ev["ph"] == "E":
            assert stacks.get(key) and stacks[key][-1] == ev["name"], ev
            stacks[key].pop()
    return [(k, n) for k, names in stacks.items() for n in names]


def test_launcher_writes_trace_metrics_and_profile(tmp_path):
    """The port's launcher on the smoke config with --trace-out,
    --metrics-out and --profile-steps, in a process that never loads JAX:
    the trace reads back with every span closed and a decode/chunk span a
    chunk carrying its device / host split, the Prometheus text and its
    JSON snapshot agree, and the profiler window wrote its trace."""
    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.prom"
    prof_dir = tmp_path / "profile"
    code = ("import sys\n"
            "from repro_torch.launch.serve import main\n"
            f"main(['--arch', 'llama3.2-3b', '--smoke', '--device', 'cpu', "
            f"'--trace-out', {str(trace)!r}, '--metrics-out', "
            f"{str(prom)!r}, '--profile-steps', '8:24', '--profile-dir', "
            f"{str(prof_dir)!r}])\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print('LOADED', ','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED \n" in out.stdout, out.stdout[-2000:]
    assert "served 8 requests" in out.stdout
    events = json.loads(trace.read_text())["traceEvents"]
    assert _open_spans(events) == []
    chunks = [e for e in events if e["name"] == "decode/chunk"]
    finishes = [e for e in events if e["name"] == "request/finish"]
    assert len(finishes) == 8 and chunks
    for e in chunks:
        assert 0 < e["args"]["device_ms"] and e["args"]["host_gap_ms"] >= 0
    text = prom.read_text()
    snap = json.loads((tmp_path / "metrics.prom.json").read_text())
    assert "# TYPE serve_generated_tokens_total counter" in text
    assert set(snap) == {line.split()[2] for line in text.splitlines()
                         if line.startswith("# TYPE ")}
    gen = snap["serve_generated_tokens_total"]["samples"][0]["value"]
    assert f'serve_generated_tokens_total{{replica="0"}} {int(gen)}' in text
    assert snap["serve_decode_chunks_total"]["samples"][0]["value"] == \
        len(chunks)
    assert snap["serve_device_time_seconds"]["samples"][0]["count"] == \
        len(chunks)
    (window,) = list(prof_dir.glob("*.json"))
    assert json.loads(window.read_text())["traceEvents"]


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
