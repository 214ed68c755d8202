"""Architecture registry: ``--arch <id>`` resolution + per-arch shape sets."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "llama3.2-3b": "repro_torch.configs.llama32_3b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_27b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE if smoke else mod.FULL


def shape_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch, shape) a runnable dry-run cell? Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: quadratic attention at "
                       "524288 tokens; skipped per docs/DESIGN.md §2.3")
    return True, ""


def cells(archs=ARCHS, shapes=tuple(SHAPES)):
    """All 40 (arch, shape) cells with runnability annotations."""
    out = []
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            ok, reason = shape_runnable(cfg, SHAPES[s])
            out.append((a, s, ok, reason))
    return out
