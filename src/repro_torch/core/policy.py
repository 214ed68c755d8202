"""Block selection criteria and quantization plans (paper §3.3).

Threshold: T = mu_H - X * sigma_H   (X >= 0, default 1.0)
Decision:  H <= T          -> "int4"  (or "ternary" when aggressive)
           T < H <= mu_H   -> "int8"
           H > mu_H        -> "raw"
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

from repro_torch.core.entropy import BlockEntropy, entropy_stats

# Precision identifiers, ordered from most to least aggressive.
PRECISIONS = ("ternary", "int3", "int4", "int8", "raw")
BITS = {"ternary": 1.58, "int3": 3.0, "int4": 4.0, "int8": 8.0, "raw": 16.0}
# Promotion order used by Algorithm 1 (towards raw).
_PROMOTE = {"ternary": "int4", "int3": "int4", "int4": "int8", "int8": "raw", "raw": "raw"}
_DEMOTE = {"raw": "int8", "int8": "int4", "int4": "ternary", "int3": "ternary",
           "ternary": "ternary"}


def promote(p: str) -> str:
    return _PROMOTE[p]


def demote(p: str) -> str:
    return _DEMOTE[p]


def bytes_per_param(precision: str, raw_bits: float = 16.0) -> float:
    """Bytes per parameter at a precision. ``raw`` follows the model dtype
    (bf16 = 16 bits by default). int4/ternary include per-group scale
    overhead (group=128, fp16 scale -> +0.125 bits/param)."""
    if precision == "raw":
        return raw_bits / 8.0
    overhead_bits = 16.0 / 128.0  # one fp16 scale per 128-param group
    return (BITS[precision] + overhead_bits) / 8.0


@dataclasses.dataclass(frozen=True)
class BlockDecision:
    block_index: int
    exec_index: int
    entropy: float
    num_parameters: int
    precision: str  # element of PRECISIONS

    @property
    def quantized(self) -> bool:
        return self.precision != "raw"

    def nbytes(self, raw_bits: float = 16.0) -> float:
        return self.num_parameters * bytes_per_param(self.precision, raw_bits)


@dataclasses.dataclass
class QuantPlan:
    """A full-model quantization plan: one decision per block.

    ``decisions`` is ordered by block_index (model order). ``by_priority``
    yields the paper's ascending-entropy ordering (quantize-first priority).
    """
    decisions: list[BlockDecision]
    mu: float
    sigma: float
    threshold: float
    x_factor: float

    # ---- views -----------------------------------------------------------
    def by_priority(self) -> list[BlockDecision]:
        return sorted(self.decisions, key=lambda d: d.entropy)

    def precisions(self) -> list[str]:
        return [d.precision for d in self.decisions]

    def counts(self) -> dict[str, int]:
        out = {p: 0 for p in PRECISIONS}
        for d in self.decisions:
            out[d.precision] += 1
        return out

    def total_bytes(self, raw_bits: float = 16.0) -> float:
        return sum(d.nbytes(raw_bits) for d in self.decisions)

    def raw_bytes(self, raw_bits: float = 16.0) -> float:
        return sum(d.num_parameters * raw_bits / 8.0 for d in self.decisions)

    def reduction(self, raw_bits: float = 16.0) -> float:
        raw = self.raw_bytes(raw_bits)
        return 0.0 if raw == 0 else 1.0 - self.total_bytes(raw_bits) / raw

    def with_precisions(self, precisions: Sequence[str]) -> "QuantPlan":
        assert len(precisions) == len(self.decisions)
        ds = [dataclasses.replace(d, precision=p)
              for d, p in zip(self.decisions, precisions)]
        return dataclasses.replace(self, decisions=ds)

    # ---- (de)serialization ------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "mu": self.mu, "sigma": self.sigma, "threshold": self.threshold,
            "x_factor": self.x_factor,
            "decisions": [dataclasses.asdict(d) for d in self.decisions],
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "QuantPlan":
        obj = json.loads(s)
        ds = [BlockDecision(**d) for d in obj["decisions"]]
        return QuantPlan(decisions=ds, mu=obj["mu"], sigma=obj["sigma"],
                         threshold=obj["threshold"], x_factor=obj["x_factor"])


def decide(entropies: Sequence[BlockEntropy], *, x_factor: float = 1.0,
           aggressive: str = "int4") -> QuantPlan:
    """Paper §3.3 quantization decision.

    aggressive: precision for blocks with H <= T ("int4", "int3" or "ternary").
    """
    assert aggressive in ("int4", "int3", "ternary")
    mu, sigma = entropy_stats([b.entropy for b in entropies])
    t = mu - x_factor * sigma
    ds = []
    for b in entropies:
        if b.entropy <= t:
            p = aggressive
        elif b.entropy <= mu:
            p = "int8"
        else:
            p = "raw"
        ds.append(BlockDecision(block_index=b.block_index,
                                exec_index=b.exec_index, entropy=b.entropy,
                                num_parameters=b.num_parameters, precision=p))
    return QuantPlan(decisions=ds, mu=mu, sigma=sigma, threshold=t,
                     x_factor=x_factor)


def decide_8bit_mixed(entropies: Sequence[BlockEntropy]) -> QuantPlan:
    """Paper §6.2 '8bit mixed' variant: H <= mu -> int8, else raw."""
    mu, sigma = entropy_stats([b.entropy for b in entropies])
    ds = [BlockDecision(block_index=b.block_index, exec_index=b.exec_index,
                        entropy=b.entropy, num_parameters=b.num_parameters,
                        precision="int8" if b.entropy <= mu else "raw")
          for b in entropies]
    return QuantPlan(decisions=ds, mu=mu, sigma=sigma, threshold=mu, x_factor=0.0)


def decide_uniform(entropies: Sequence[BlockEntropy], precision: str) -> QuantPlan:
    """Global (uniform) quantization baseline — a special case of the plan."""
    assert precision in PRECISIONS
    mu, sigma = entropy_stats([b.entropy for b in entropies] or [0.0])
    ds = [BlockDecision(block_index=b.block_index, exec_index=b.exec_index,
                        entropy=b.entropy, num_parameters=b.num_parameters,
                        precision=precision)
          for b in entropies]
    return QuantPlan(decisions=ds, mu=mu, sigma=sigma, threshold=float("inf"),
                     x_factor=0.0)
