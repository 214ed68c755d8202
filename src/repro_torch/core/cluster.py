"""Resource-constrained block distribution — paper Algorithms 1 and 2.

Machines have memory X_i and disk Y_i; Z_i = min(X_i, Y_i); the cluster
budget is R = sum(Z_i). Algorithm 1 starts from the EWQ quantization
decision, then promotes blocks (toward raw, highest-entropy first) while the
model fits, or demotes (toward 1.58-bit, lowest-entropy first) until it
fits, and finally places blocks on machines first-fit by descending size.

Algorithm 2 (FastEWQ) does the same keyed on exec_index instead of entropy.

``fit_plan_to_hbm`` runs the same promote/demote loop against the weight
budget of a deployment's devices (one H100 holds 80 GB of HBM3; the
activations and caches keep ``reserved_fraction`` of it): blocks are not
moved between machines there, precision is the degree of freedom.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.policy import QuantPlan, demote, promote


@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    memory_bytes: float  # X_i
    disk_bytes: float    # Y_i

    @property
    def budget(self) -> float:  # Z_i
        return min(self.memory_bytes, self.disk_bytes)


def cluster_budget(machines: Sequence[Machine]) -> float:
    return sum(m.budget for m in machines)


def _plan_bytes(plan: QuantPlan, raw_bits: float) -> float:
    return plan.total_bytes(raw_bits)


def optimize_distribution(plan: QuantPlan, machines: Sequence[Machine], *,
                          raw_bits: float = 16.0) -> dict:
    """Algorithm 1. Returns {plan, placement, fits, total_bytes, budget}."""
    budget = cluster_budget(machines)
    decisions = list(plan.decisions)
    unquant_bytes = sum(d.num_parameters for d in decisions) * raw_bits / 8.0

    # Step 0: deploy unquantized when it fits.
    if unquant_bytes <= budget:
        final = plan.with_precisions(["raw"] * len(decisions))
        return _place(final, machines, raw_bits, budget)

    # Step 1: start from the EWQ decision (given in `plan`), then promote
    # highest-entropy blocks while resources allow.
    work = list(plan.decisions)
    size = sum(d.nbytes(raw_bits) for d in work)
    if size <= budget:
        for d in sorted(work, key=lambda d: -d.entropy):
            while d.precision != "raw":
                cand = dataclasses.replace(d, precision=promote(d.precision))
                delta = cand.nbytes(raw_bits) - d.nbytes(raw_bits)
                if size + delta > budget:
                    break
                size += delta
                work[d.block_index] = cand
                d = cand
    else:
        # Step 2: demote lowest-entropy blocks down to ternary until fit.
        for d in sorted(work, key=lambda d: d.entropy):
            while size > budget and d.precision != "ternary":
                cand = dataclasses.replace(d, precision=demote(d.precision))
                size += cand.nbytes(raw_bits) - d.nbytes(raw_bits)
                work[d.block_index] = cand
                d = cand
            if size <= budget:
                break

    final = dataclasses.replace(plan, decisions=work)
    return _place(final, machines, raw_bits, budget)


def fastewq_resource_adjust(plan: QuantPlan, machines: Sequence[Machine], *,
                            raw_bits: float = 16.0) -> dict:
    """Algorithm 2 steps 3-4: adjust the classifier's 8-bit preselection by
    exec_index under the resource budget, then place."""
    budget = cluster_budget(machines)
    work = list(plan.decisions)
    size = sum(d.nbytes(raw_bits) for d in work)
    if size < budget:
        # Promote lowest exec_index quantized blocks to raw while it fits.
        for d in sorted((d for d in work if d.quantized),
                        key=lambda d: d.exec_index):
            cand = dataclasses.replace(d, precision="raw")
            delta = cand.nbytes(raw_bits) - d.nbytes(raw_bits)
            if size + delta > budget:
                break
            size += delta
            work[d.block_index] = cand
    else:
        # Downgrade highest exec_index blocks 8->4->1.58 until fit.
        for d in sorted((d for d in work if d.quantized),
                        key=lambda d: -d.exec_index):
            while size > budget and d.precision != "ternary":
                cand = dataclasses.replace(d, precision=demote(d.precision))
                size += cand.nbytes(raw_bits) - d.nbytes(raw_bits)
                work[d.block_index] = cand
                d = cand
            if size <= budget:
                break
    final = dataclasses.replace(plan, decisions=work)
    return _place(final, machines, raw_bits, budget)


def _place(plan: QuantPlan, machines: Sequence[Machine], raw_bits: float,
           budget: float) -> dict:
    """First-fit-decreasing placement of blocks onto machines by Z_i."""
    remaining = {m.name: m.budget for m in machines}
    placement: dict[str, list[int]] = {m.name: [] for m in machines}
    ok = True
    for d in sorted(plan.decisions, key=lambda d: -d.nbytes(raw_bits)):
        b = d.nbytes(raw_bits)
        target = None
        for name in sorted(remaining, key=lambda n: -remaining[n]):
            if remaining[name] >= b:
                target = name
                break
        if target is None:
            ok = False
            continue
        remaining[target] -= b
        placement[target].append(d.block_index)
    total = plan.total_bytes(raw_bits)
    return {"plan": plan, "placement": placement, "fits": ok and
            total <= budget, "total_bytes": total, "budget": budget}


def fit_plan_to_hbm(plan: QuantPlan, *, hbm_bytes_per_device: float,
                    devices: int, reserved_fraction: float = 0.25,
                    raw_bits: float = 16.0) -> QuantPlan:
    """Algorithm 1 against a device-memory weight budget: ``devices``
    devices of ``hbm_bytes_per_device`` each (an H100: 80 GB), of which the
    activations and caches keep ``reserved_fraction``."""
    budget = hbm_bytes_per_device * (1 - reserved_fraction) * devices
    machines = [Machine("device", budget, budget)]
    return optimize_distribution(plan, machines,
                                 raw_bits=raw_bits)["plan"]
