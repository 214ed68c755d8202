"""Mamba2 (SSD, state-space duality) block: chunked prefill and O(1) decode.

Prefill runs the SSD chunked algorithm: masked decay inside fixed-size
chunks, and a sequential scan over the chunk states for the inter-chunk
recurrence (linear in the number of chunks, not the quadratic chunk
matrix). Decode keeps a (conv, state) summary per layer and costs O(1) per
token.

The two products of a block, ``w_in`` and ``w_out``, go through ``qdot``
and so through the qmatmul kernel; everything else is plain tensor ops, as
the JAX reference computes it outside any Pallas kernel. The state stays
f32.

Per-layer parameters (stored (out, in)):
  w_in     : (2*d_inner + 2*G*N + H, D)
  conv_w   : (conv_dim, W)      depthwise causal conv, conv_dim = d_inner+2GN
  conv_b   : (conv_dim,)
  A_log    : (H,)               A = -exp(A_log)
  D        : (H,)               skip gain
  dt_bias  : (H,)
  norm_w   : (d_inner,)         gated RMSNorm
  w_out    : (D, d_inner)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.qmatmul.ops import qdot
from repro_torch.models.common import dense_init


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_dim)
    state: torch.Tensor  # (B, H, P, N) f32


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_ssm_cache(batch: int, cfg, dtype, device) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                           cfg.ssm_state), dtype=torch.float32, device=device))


def init_ssm_params(gen: torch.Generator, cfg, layers: int, dtype,
                    device) -> dict:
    """Stacked (layers, ...) Mamba2 parameters at the reference's scales."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    cd = conv_dim(cfg)

    def per_layer(v: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(v.astype(np.float32)).to(device)
        return t[None].expand(layers, *t.shape).contiguous()

    return {
        "w_in": dense_init(gen, (layers, 2 * di + 2 * g * n + h, d), dtype,
                           device),
        "conv_w": (torch.randn((layers, cd, cfg.ssm_conv), generator=gen,
                               device=device, dtype=torch.float32)
                   / np.sqrt(cfg.ssm_conv)).to(dtype),
        "conv_b": torch.zeros((layers, cd), dtype=dtype, device=device),
        "A_log": per_layer(np.log(np.linspace(1.0, 16.0, h,
                                              dtype=np.float32))),
        "D": per_layer(np.ones(h)),
        "dt_bias": per_layer(np.log(np.expm1(np.linspace(1e-3, 1e-1, h)))),
        "norm_w": torch.ones((layers, di), dtype=dtype, device=device),
        "w_out": dense_init(gen, (layers, d, di), dtype, device,
                            scale=1.0 / np.sqrt(2 * max(cfg.num_layers, 1))),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, L, C), w (C, W) -> (B, L, C), summed in
    f32 in the reference's order."""
    l = x.shape[1]
    width = w.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + l, :].float() * w[:, i].float()
    return (out + b.float()).to(x.dtype)


def _gated_rms_norm(y, z, w, eps: float = 1e-5):
    yz = y.float() * F.silu(z.float())
    var = torch.mean(yz * yz, dim=-1, keepdim=True)
    return (yz * torch.rsqrt(var + eps) * w.float()).to(y.dtype)


def _ssd_chunked(x, a, bm, cm, chunk: int):
    """SSD scan. x: (B, L, H, P) premultiplied by dt; a: (B, L, H) = dt*A;
    bm, cm: (B, L, H, N). Returns (y (B, L, H, P) f32, final state
    (B, H, P, N) f32)."""
    bsz, l, h, p = x.shape
    n = bm.shape[-1]
    chunk = min(chunk, l)
    assert l % chunk == 0, (l, chunk)
    nc = l // chunk

    xs = x.reshape(bsz, nc, chunk, h, p).float()
    asr = a.reshape(bsz, nc, chunk, h).float()
    bs = bm.reshape(bsz, nc, chunk, h, n).float()
    cs = cm.reshape(bsz, nc, chunk, h, n).float()
    a_cum = torch.cumsum(asr, dim=2)                      # (B, nc, cs, H)

    # intra-chunk (diagonal blocks); the mask goes on BEFORE the exp: the
    # upper triangle of seg is positive (a_cum decreases), and exp of it
    # would overflow
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]   # (B,nc,s,t,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    seg = torch.where(causal[None, None, :, :, None], seg,
                      torch.full_like(seg, -torch.inf))
    lmat = torch.exp(seg)
    y_diag = torch.einsum("bcshn,bcthn,bcsth,bcthp->bcshp", cs, bs, lmat, xs)

    # per-chunk end states
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)     # (B,nc,cs,H)
    states = torch.einsum("bcthn,bcth,bcthp->bchpn", bs, decay_states, xs)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])               # (B,nc,H)

    # inter-chunk recurrence: a sequential scan, linear in nc; each chunk
    # reads the state ENTERING it
    s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    entering = torch.stack(entering, dim=1)                   # (B,nc,H,P,N)

    # off-diagonal contribution
    state_decay = torch.exp(a_cum)                            # (B,nc,cs,H)
    y_off = torch.einsum("bcshn,bcsh,bchpn->bcshp", cs, state_decay, entering)
    return (y_diag + y_off).reshape(bsz, l, h, p), s


def _split_zxbcdt(zxbcdt, cfg):
    di = cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn],
            zxbcdt[..., 2 * di + 2 * gn:])


def _heads_from_groups(m, cfg):
    """(B, ..., G, N) -> (B, ..., H, N) by repeating groups."""
    return torch.repeat_interleave(m, cfg.ssm_nheads // cfg.ssm_ngroups,
                                   dim=-2)


def ssm_block(p, u: torch.Tensor, cfg, plain: bool = False) -> torch.Tensor:
    """Prefill path. u: (B, L, D) -> (B, L, D)."""
    bsz, l, _ = u.shape
    di, h, pd = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state

    z, xbc, dt = _split_zxbcdt(qdot(u, p["w_in"], plain=plain), cfg)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]).float()
                 ).to(u.dtype)
    x = xbc[..., :di].reshape(bsz, l, h, pd)
    bm = _heads_from_groups(xbc[..., di:di + g * n].reshape(bsz, l, g, n), cfg)
    cm = _heads_from_groups(xbc[..., di + g * n:].reshape(bsz, l, g, n), cfg)

    dt = F.softplus(dt.float() + p["dt_bias"])                # (B, L, H)
    a = -torch.exp(p["A_log"])                                # (H,)
    y, _ = _ssd_chunked(x * dt[..., None].to(x.dtype), dt * a, bm, cm,
                        cfg.ssm_chunk)
    y = y + p["D"][None, None, :, None] * x.float()
    y = _gated_rms_norm(y.reshape(bsz, l, di).to(u.dtype), z, p["norm_w"],
                        cfg.norm_eps)
    return qdot(y, p["w_out"], plain=plain)


def ssm_decode_step(p, u: torch.Tensor, cache: SSMCache, cfg,
                    plain: bool = False) -> torch.Tensor:
    """Single-token decode. u: (B, D) -> (B, D). The layer's conv and state
    are written IN PLACE into ``cache`` (views of the stacked cache), so a
    decode step captured in a CUDA graph keeps its addresses."""
    bsz, _ = u.shape
    di, h, pd = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state

    z, xbc, dt = _split_zxbcdt(qdot(u, p["w_in"], plain=plain), cfg)
    window = torch.cat([cache.conv, xbc[:, None, :].to(cache.conv.dtype)],
                       dim=1)
    conv_out = (torch.einsum("bwc,cw->bc", window.float(),
                             p["conv_w"].float()) + p["conv_b"].float())
    cache.conv.copy_(window[:, 1:, :])
    xbc = F.silu(conv_out).to(u.dtype)

    x = xbc[..., :di].reshape(bsz, h, pd)
    bm = _heads_from_groups(xbc[..., di:di + g * n].reshape(bsz, g, n), cfg)
    cm = _heads_from_groups(xbc[..., di + g * n:].reshape(bsz, g, n), cfg)

    dt = F.softplus(dt.float() + p["dt_bias"])                # (B, H)
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt * a)                                    # (B, H)
    xdt = x.float() * dt[..., None]
    state = (cache.state * da[:, :, None, None]
             + torch.einsum("bhp,bhn->bhpn", xdt, bm.float()))
    cache.state.copy_(state)
    y = (torch.einsum("bhpn,bhn->bhp", state, cm.float())
         + p["D"][None, :, None] * x.float())
    y = _gated_rms_norm(y.reshape(bsz, di).to(u.dtype), z, p["norm_w"],
                        cfg.norm_eps)
    return qdot(y, p["w_out"], plain=plain)
