"""Feed-forward block: SwiGLU (the llama family)."""

from __future__ import annotations

from repro_torch.kernels.qmatmul.ops import fused_mlp
from repro_torch.models.common import dense_init


def swiglu(p, x, plain: bool = False):
    # one fused kernel launch on the GPU when the three weights share a
    # (precision, group); the qdot sequence otherwise
    return fused_mlp(x, p["w_gate"], p["w_up"], p["w_down"], act="swiglu",
                     plain=plain)


def mlp(p, x, act: str, plain: bool = False):
    if act != "swiglu":
        raise NotImplementedError(
            f"mlp_act={act!r} (gelu, whisper) is still to be ported")
    return swiglu(p, x, plain)


def init_mlp_params(gen, layers: int, d_model: int, d_ff: int, dtype,
                    device) -> dict:
    """Stacked (layers, out, in) SwiGLU weights at the reference's scales."""
    down_scale = 1.0 / (2 * max(layers, 1)) ** 0.5
    return {
        "w_gate": dense_init(gen, (layers, d_ff, d_model), dtype, device),
        "w_up": dense_init(gen, (layers, d_ff, d_model), dtype, device),
        "w_down": dense_init(gen, (layers, d_model, d_ff), dtype, device,
                             scale=down_scale),
    }
