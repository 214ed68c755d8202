"""Quantized matmul entry points: ``qdot``, ``fused_qkv``, ``fused_mlp``.

``qdot(x, w)`` is the single entry point the model uses for every weight
matmul. ``w`` is either

* a plain tensor (raw weights) -> ``torch.matmul``, accumulating in f32, or
* a ``QTensor`` (int8 / int4 / ternary) -> the fused dequant matmul.

Every quantized path has two implementations side by side:

* the CUDA kernel (``csrc/qmatmul.cu``, ``csrc/qmlp.cu``), launched for a
  tensor on the GPU; it raises on what it does not take, never falls back;
* the plain PyTorch version, which mirrors the JAX package's CPU path
  exactly: ``qmatmul_plain`` dequantizes to bf16 and multiplies in f32
  (``_dequant_simple``), ``fused_qkv_plain`` is three ``qdot`` calls and
  ``fused_mlp_plain`` the ``qdot`` sequence of the MLP, with silu (or
  gelu) rounded to x's dtype before it multiplies u (or the down weight).

A tensor on the CPU takes the plain version. ``plain=True`` asks for the
plain version on the GPU too, which is how a run compares the two.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.quant.qtypes import QTensor
from repro_torch.quant.quantize import dequantize

_PACKED = {"int8": 0, "ternary": 0, "int4": 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def qmatmul_plain(x2d: torch.Tensor, w: QTensor) -> torch.Tensor:
    """(M, K) x QTensor (N, K) -> (M, N) f32: dequantize the weight to bf16,
    then one f32 product."""
    wd = dequantize(w, torch.bfloat16)
    return x2d.float() @ wd.float().t()


def _raw_dot(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Raw (unquantized) weight: (M, K) x (N, K) -> (M, N) f32. Same-dtype
    operands multiply in their dtype (f32 accumulation); mixed dtypes are
    promoted to f32."""
    if x2d.dtype == w.dtype:
        return (x2d @ w.t()).float()
    return x2d.float() @ w.float().t()


def fused_qkv_plain(x: torch.Tensor, wq, wk, wv):
    return fused_qkv(x, wq, wk, wv, plain=True)


def fused_mlp_plain(x: torch.Tensor, w_gate, w_up, w_down,
                    act: str = "swiglu") -> torch.Tensor:
    return fused_mlp(x, w_gate, w_up, w_down, act, plain=True)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

# the weight group csrc/qmatmul.cu takes (every plan's default)
KERNEL_GROUP = 128


def _check_x(x2d: torch.Tensor, what: str) -> torch.Tensor:
    """Validate x for the kernels; returns it 16-byte aligned (the kernel
    stages x with 16-byte copies; a view that starts mid-row is copied)."""
    if not x2d.is_cuda:
        raise ValueError(f"{what}: x must be a CUDA tensor")
    if x2d.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: x must be bf16 or f32, got {x2d.dtype}")
    if not x2d.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    return x2d if x2d.data_ptr() % 16 == 0 else x2d.clone()


def _check_w(w: QTensor, k: int, device, what: str,
             group: Optional[int] = None) -> int:
    """Validate one quantized weight for the kernels; returns its N.
    ``group``: the one group the kernel takes (qmatmul.cu: 128), if any."""
    if w.precision not in _PACKED:
        raise ValueError(f"{what}: unsupported precision {w.precision!r}")
    n = w.data.shape[0]
    k_store = k // 2 if w.precision == "int4" else k
    if w.data.dtype != torch.int8 or tuple(w.data.shape) != (n, k_store):
        raise ValueError(f"{what}: data must be int8 ({n}, {k_store}), got "
                         f"{w.data.dtype} {tuple(w.data.shape)}")
    if (w.scale.dtype != torch.bfloat16
            or tuple(w.scale.shape) != (n, k // w.group)):
        raise ValueError(f"{what}: scale must be bf16 ({n}, {k // w.group}), "
                         f"got {w.scale.dtype} {tuple(w.scale.shape)}")
    if w.group % 8 or k % w.group:
        raise ValueError(f"{what}: needs group % 8 == 0 and K % group == 0 "
                         f"(K={k}, group={w.group})")
    if group is not None and w.group != group:
        raise ValueError(f"{what}: the kernel takes weight group {group} "
                         f"only, got {w.group}")
    for t in (w.data, w.scale):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: weights must be contiguous on {device}")
    align = 8 if group is None else 16
    if w.data.data_ptr() % align:
        raise ValueError(f"{what}: weight payload must be {align}-byte "
                         "aligned")
    return n


def qmatmul_cuda(x2d: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Fused dequant matmul kernel: (M, K) x QTensor (N, K) -> (M, N) f32."""
    x2d = _check_x(x2d, "qmatmul")
    m, k = x2d.shape
    n = _check_w(w, k, x2d.device, "qmatmul", KERNEL_GROUP)
    y = torch.empty((m, n), dtype=torch.float32, device=x2d.device)
    if m == 0 or n == 0:
        return y
    lib = build.library("qmatmul")
    build.LAUNCHES["qmatmul"] += 1
    build.check(lib.repro_qmatmul(
        x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), m, k, w.group,
        _PACKED[w.precision], w.data.data_ptr(), w.scale.data_ptr(),
        y.data_ptr(), n, build.stream_ptr(x2d.device)), "qmatmul")
    return y


def qkv_cuda(x2d: torch.Tensor, wq: QTensor, wk: QTensor, wv: QTensor):
    """The three projections in one launch -> three (M, N_*) f32 outputs."""
    x2d = _check_x(x2d, "qkv")
    m, k = x2d.shape
    ns = [_check_w(w, k, x2d.device, "qkv", KERNEL_GROUP)
          for w in (wq, wk, wv)]
    if len({(w.precision, w.group) for w in (wq, wk, wv)}) != 1:
        raise ValueError("qkv: the three weights must share precision/group")
    ys = [torch.empty((m, n), dtype=torch.float32, device=x2d.device)
          for n in ns]
    if m == 0:
        return tuple(ys)
    lib = build.library("qmatmul")
    build.LAUNCHES["qkv"] += 1
    args = []
    for w, y, n in zip((wq, wk, wv), ys, ns):
        args += [w.data.data_ptr(), w.scale.data_ptr(), y.data_ptr(), n]
    build.check(lib.repro_qkv(
        x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), m, k, wq.group,
        _PACKED[wq.precision], *args, build.stream_ptr(x2d.device)), "qkv")
    return tuple(ys)


def qmlp_cuda(x2d: torch.Tensor, w_gate: Optional[QTensor], w_up: QTensor,
              w_down: QTensor) -> torch.Tensor:
    """Fused MLP kernel: (M, K) -> (M, D) f32, SwiGLU with a gate weight,
    GeLU (tanh form) with ``w_gate=None``; the (M, FF) hidden never reaches
    device memory (only (FF / 64, M, D) f32 partials)."""
    _check_x(x2d, "qmlp")
    m, k = x2d.shape
    gelu = w_gate is None
    ws = (w_up, w_down) if gelu else (w_gate, w_up, w_down)
    ff = _check_w(w_up, k, x2d.device, "qmlp up")
    if not gelu and _check_w(w_gate, k, x2d.device, "qmlp gate") != ff:
        raise ValueError("qmlp: gate and up must have the same rows")
    d = _check_w(w_down, ff, x2d.device, "qmlp down")
    if len({(w.precision, w.group) for w in ws}) != 1:
        raise ValueError("qmlp: the weights must share precision/group")
    out = torch.empty((m, d), dtype=torch.float32, device=x2d.device)
    if m == 0:
        return out
    lib = build.library("qmlp")
    tiles = lib.repro_qmlp_tiles(ff)
    partial = torch.empty((tiles, m, d), dtype=torch.float32,
                          device=x2d.device)
    name = "qmlp_gelu" if gelu else "qmlp"
    build.LAUNCHES[name] += 1
    build.check(lib.repro_qmlp(
        x2d.data_ptr(), int(x2d.dtype == torch.bfloat16), m, k, ff, d,
        w_up.group, _PACKED[w_up.precision], int(gelu),
        0 if gelu else w_gate.data.data_ptr(),
        0 if gelu else w_gate.scale.data_ptr(),
        w_up.data.data_ptr(), w_up.scale.data_ptr(),
        w_down.data.data_ptr(), w_down.scale.data_ptr(),
        partial.data_ptr(), out.data_ptr(), build.stream_ptr(x2d.device)),
        name)
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def qdot(x: torch.Tensor, w, out_dtype=None, plain: bool = False
         ) -> torch.Tensor:
    """y[..., n] = sum_k x[..., k] * W[n, k] with W possibly quantized."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    lead, k = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, k)
    if isinstance(w, QTensor):
        if x.is_cuda and not plain:
            y = qmatmul_cuda(x2d.contiguous(), w)
        else:
            y = qmatmul_plain(x2d, w)
        n = w.data.shape[0]
    else:
        y = _raw_dot(x2d, w)
        n = w.shape[0]
    return y.reshape(*lead, n).to(out_dtype)


def _mega_eligible(ws) -> bool:
    """All operands QTensors of one (precision, group): the fused kernels
    dequantize every tile with a single rule per launch."""
    return (all(isinstance(w, QTensor) for w in ws)
            and len({(w.precision, w.group) for w in ws}) == 1)


def _out_dim(w) -> int:
    return w.data.shape[0] if isinstance(w, QTensor) else w.shape[0]


def fused_qkv(x: torch.Tensor, wq, wk, wv, plain: bool = False):
    """The three attention projections; one kernel launch on the GPU when
    all three share (precision, group). Returns (q, k, v) in x's dtype."""
    if plain or not x.is_cuda or not _mega_eligible((wq, wk, wv)):
        return (qdot(x, wq, plain=plain), qdot(x, wk, plain=plain),
                qdot(x, wv, plain=plain))
    lead, k = x.shape[:-1], x.shape[-1]
    ys = qkv_cuda(x.reshape(-1, k).contiguous(), wq, wk, wv)
    return tuple(y.reshape(*lead, y.shape[1]).to(x.dtype) for y in ys)


def fused_mlp(x: torch.Tensor, w_gate, w_up, w_down, act: str = "swiglu",
              plain: bool = False) -> torch.Tensor:
    """Whole quantized MLP block: one fused launch (plus its fixed-order
    reduction) on the GPU when its weights share (precision, group);
    otherwise the qdot sequence. ``w_gate`` is None for act="gelu"."""
    if act not in ("swiglu", "gelu") or (w_gate is None) != (act == "gelu"):
        raise ValueError(f"fused_mlp: act is 'swiglu' (with a gate weight) "
                         f"or 'gelu' (without), got {act!r}")
    ws = [w for w in (w_gate, w_up, w_down) if w is not None]
    if x.is_cuda and not plain and _mega_eligible(ws):
        lead, k = x.shape[:-1], x.shape[-1]
        y = qmlp_cuda(x.reshape(-1, k).contiguous(), w_gate, w_up, w_down)
        return y.reshape(*lead, _out_dim(w_down)).to(x.dtype)
    if act == "swiglu":
        g = qdot(x, w_gate, plain=plain)
        u = qdot(x, w_up, plain=plain)
        h = F.silu(g.float()).to(x.dtype) * u
        return qdot(h, w_down, plain=plain)
    h = qdot(x, w_up, plain=plain)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return qdot(h, w_down, plain=plain)
