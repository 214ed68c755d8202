"""Feed-forward blocks: SwiGLU (the llama family) and GeLU (whisper)."""

from __future__ import annotations

from repro_torch.kernels.qmatmul.ops import fused_mlp
from repro_torch.models.common import dense_init


def swiglu(p, x, plain: bool = False):
    # one fused kernel launch on the GPU when the three weights share a
    # (precision, group); the qdot sequence otherwise
    return fused_mlp(x, p["w_gate"], p["w_up"], p["w_down"], act="swiglu",
                     plain=plain)


def gelu_mlp(p, x, plain: bool = False):
    # the gelu form of the same fused kernel: up and down weights only
    return fused_mlp(x, None, p["w_up"], p["w_down"], act="gelu",
                     plain=plain)


def mlp(p, x, act: str, plain: bool = False):
    return swiglu(p, x, plain) if act == "swiglu" else gelu_mlp(p, x, plain)


def init_mlp_params(gen, layers: int, d_model: int, d_ff: int, dtype,
                    device, act: str = "swiglu") -> dict:
    """Stacked (layers, out, in) MLP weights at the reference's scales (no
    gate weight for gelu)."""
    down_scale = 1.0 / (2 * max(layers, 1)) ** 0.5
    p = {}
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, (layers, d_ff, d_model), dtype, device)
    p["w_up"] = dense_init(gen, (layers, d_ff, d_model), dtype, device)
    p["w_down"] = dense_init(gen, (layers, d_model, d_ff), dtype, device,
                             scale=down_scale)
    return p
