"""Masked sampling for the decode loop.

Per-slot controls, as tensors of shape (B,):

* ``temperature`` - 0 means greedy (argmax);
* ``top_k``       - keep the k highest-probability tokens (0 disables);
* ``top_p``       - nucleus: keep the smallest prefix of the sorted vocab
  whose cumulative mass reaches p (>= 1 disables; the top token is kept).

``masked_dist`` gives the log-distribution a request actually samples
from. ``sample`` draws with an explicit ``torch.Generator``; it cannot
reproduce the JAX package's random bits, so sampled paths are compared
through ``masked_dist``, and only greedy decoding matches token for token.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_MIN_TEMP = 1e-6


def masked_dist(lp: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor,
                need_mask: bool = True) -> torch.Tensor:
    """lp (..., V) normalized log-probs -> masked, temperature-scaled,
    renormalized log-probs. Each control broadcasts against ``lp[..., 0]``:
    (B,) vectors for a (B, V) step, ``temperature[:, None]`` etc. for a
    (B, K+1, V) verify window. ``need_mask=False`` skips the O(V log V)
    sort when the caller knows no slot uses top-k / top-p."""
    v = lp.shape[-1]
    shape = torch.broadcast_shapes(lp.shape[:-1], temperature.shape,
                                   top_k.shape, top_p.shape)
    temp, tk, tp = (x.expand(shape)[..., None]
                    for x in (temperature, top_k, top_p))
    lp = lp.expand(*shape, v)
    masked = lp
    if need_mask:
        sorted_lp = torch.sort(lp, dim=-1, descending=True).values
        kth = torch.gather(sorted_lp, -1, (tk.long() - 1).clamp(0, v - 1))
        keep = (tk <= 0) | (lp >= kth)
        sp = torch.exp(sorted_lp)
        cum = torch.cumsum(sp, dim=-1) - sp
        n_keep = (cum < tp).sum(dim=-1, keepdim=True)
        pth = torch.gather(sorted_lp, -1, (n_keep - 1).clamp(0, v - 1))
        keep &= (tp >= 1.0) | (lp >= pth)
        masked = torch.where(keep, lp, torch.full_like(lp, NEG_INF))
    scaled = torch.where(temp > 0, masked / torch.clamp(temp, min=_MIN_TEMP),
                         masked)
    return torch.log_softmax(scaled, dim=-1)


def sample(gen: torch.Generator, dist: torch.Tensor,
           temperature: torch.Tensor) -> torch.Tensor:
    """One token per row of a ``masked_dist`` output; greedy rows take the
    argmax. Returns (B,) int32."""
    stoch = torch.multinomial(torch.exp(dist), 1, generator=gen)[:, 0]
    greedy = torch.argmax(dist, dim=-1)
    return torch.where(temperature > 0, stoch, greedy).to(torch.int32)
