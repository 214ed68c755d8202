"""Mixture-of-Experts layer: top-k router, gather dispatch, capacity drop.

The JAX reference's semantics, kept exactly, because an MoE layer's output
depends on which tokens share a call (capacity drops):

* one group of tokens: the reference groups tokens by data shard, and on
  one device that is one group;
* the router is ``qdot(x, router)`` in f32 (a quantized router goes
  through the qmatmul kernel at N = num_experts), softmax, top-k (the
  lower expert index first on a tie, as ``jax.lax.top_k``), the gates
  renormalized;
* a token's position in its expert comes from a stable argsort of the
  assignments and ``searchsorted``; assignments at or past the capacity
  (``capacity_of``) are dropped;
* the dispatch table is a scatter whose dropped assignments land in a dump
  row past the end (the reference's ``mode="drop"``), and the ``filled``
  mask zeroes every slot no token took (token 0 would leak in otherwise);
* each expert is a SwiGLU over its slots: the weight dequantized to x's
  dtype, then a matmul (the reference runs no kernel here). Experts are
  dequantized a few at a time under ``EXPERT_BYTES``, so no step holds a
  layer's whole dequantized stack (a captured decode graph's pool would
  keep it);
* the combine gathers each assignment's expert output back, masks the
  dropped ones and sums them with the gate weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.qmatmul.ops import qdot
from repro_torch.models.common import dense_init
from repro_torch.quant.qtypes import QTensor
from repro_torch.quant.quantize import dequantize

# transient bytes of the dequantized expert weights one matmul holds
EXPERT_BYTES = 1 << 30


def capacity_of(num_tokens: int, num_experts: int, top_k: int,
                capacity_factor: float) -> int:
    c = int(math.ceil(num_tokens * top_k * capacity_factor / num_experts))
    return max(8, int(math.ceil(c / 8)) * 8)


def top_k_lower_first(probs: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, and on a tie
    the lower index first. ``torch.topk`` promises no order among equal
    values, so this takes the first k of a stable descending sort (equal
    values keep their index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_rows(w, lo: int, hi: int, dtype) -> torch.Tensor:
    """Experts [lo, hi) of an (E, F, K) stack in ``dtype``: a view of a raw
    stack, or those experts dequantized."""
    if isinstance(w, QTensor):
        part = QTensor(data=w.data[lo:hi], scale=w.scale[lo:hi],
                       precision=w.precision,
                       shape=(hi - lo,) + tuple(w.shape[1:]), group=w.group)
        return dequantize(part, dtype)
    return w[lo:hi]


def _experts_per_chunk(w, dtype) -> int:
    """Experts one matmul takes: all of a raw stack (views, nothing
    transient), else as many as fit ``EXPERT_BYTES`` dequantized."""
    if not isinstance(w, QTensor):
        return w.shape[0]
    e, f, k = w.shape
    return max(1, min(e, EXPERT_BYTES // (f * k * dtype.itemsize)))


def _experts(p, xe: torch.Tensor) -> torch.Tensor:
    """(E, C, D) slots -> (E, C, D): every expert's SwiGLU on its slots,
    the hidden ``silu(g) * u`` rounded to x's dtype as the reference
    rounds it."""
    e = xe.shape[0]
    step = _experts_per_chunk(p["w_gate"], xe.dtype)
    if step >= e:
        return _swiglu(p, xe, 0, e)
    return torch.cat([_swiglu(p, xe[lo:lo + step], lo, min(lo + step, e))
                      for lo in range(0, e, step)])


def _swiglu(p, xe: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    dtype = xe.dtype
    g = torch.matmul(xe, _expert_rows(p["w_gate"], lo, hi, dtype).mT)
    u = torch.matmul(xe, _expert_rows(p["w_up"], lo, hi, dtype).mT)
    h = F.silu(g.float()).to(dtype) * u
    return torch.matmul(h, _expert_rows(p["w_down"], lo, hi, dtype).mT)


def moe_block(p, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, plain: bool = False):
    """x (B, S, D) -> (y (B, S, D), {"moe_aux_loss": 0-d f32}). Reads
    nothing back to the host, so a decode step holding it can be captured
    in a CUDA graph."""
    b, s, d = x.shape
    t = b * s
    e, k = num_experts, top_k
    xt = x.reshape(t, d)
    dev = x.device

    # -- routing (f32) --------------------------------------------------
    logits = qdot(xt, p["router"], out_dtype=torch.float32, plain=plain)
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gate, idx = top_k_lower_first(probs, k)                    # (T, K)
    gate = gate / gate.sum(dim=-1, keepdim=True)

    # Switch-style load-balancing loss
    # (the one-hot by comparison: F.one_hot checks its indices on the
    # host, which a captured decode step cannot do)
    me = probs.mean(dim=0)
    experts = torch.arange(e, device=dev)
    ce = (idx[..., None] == experts).to(torch.float32).sum(1).mean(0)
    aux = e * torch.sum(me * ce)

    # -- position in expert: stable argsort + searchsorted ------------------
    flat_e = idx.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, experts)
    pos_sorted = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted

    cap = capacity_of(t, e, k, capacity_factor)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, e * cap))          # (T*K,)

    # -- dispatch: a gather into (E, C, D); row e*cap is the dump row -------
    tok_id = torch.arange(t * k, device=dev) // k              # (T*K,)
    table = torch.zeros(e * cap + 1, dtype=torch.long, device=dev)
    table[slot] = tok_id
    filled = torch.zeros(e * cap + 1, dtype=torch.bool, device=dev)
    filled.index_fill_(0, slot, True)
    xe = xt[table[:e * cap]].reshape(e, cap, d)
    xe = xe * filled[:e * cap].reshape(e, cap, 1).to(xe.dtype)

    ye = _experts(p, xe)                                       # (E, C, D)

    # -- combine: gather back through the slot, weight by the gates ---------
    y_asgn = ye.reshape(e * cap, d)[slot.clamp(max=e * cap - 1)]
    y_asgn = torch.where(keep[:, None], y_asgn, torch.zeros_like(y_asgn))
    y = (y_asgn.reshape(t, k, d) * gate.to(y_asgn.dtype)[..., None]).sum(1)
    return y.reshape(b, s, d), {"moe_aux_loss": aux}


def init_moe_params(gen: torch.Generator, layers: int, d_model: int,
                    expert_d_ff: int, num_experts: int, num_layers: int,
                    dtype, device) -> dict:
    """Stacked (layers, E, out, in) expert weights and the (layers, E, D)
    f32 router at the reference's scales. Each expert matrix is drawn on
    its own, so the f32 draw never spans more than one of them."""
    e, d, f = num_experts, d_model, expert_d_ff
    down_scale = 1.0 / (2 * max(num_layers, 1)) ** 0.5

    def stack(out, inp, scale=1.0):
        w = torch.empty((layers, e, out, inp), dtype=dtype, device=device)
        for i in range(layers):
            for j in range(e):
                w[i, j] = dense_init(gen, (out, inp), dtype, device, scale)
        return w

    return {"router": dense_init(gen, (layers, e, d), torch.float32, device),
            "w_gate": stack(f, d), "w_up": stack(f, d),
            "w_down": stack(d, f, down_scale)}
