"""Algorithms 1 and 2 in the port (``repro_torch.core.cluster``) against
the JAX package's, to the bit.

The same seeded plans go through ``optimize_distribution`` (Algorithm 1),
``fastewq_resource_adjust`` (Algorithm 2) and ``fit_plan_to_hbm`` in both
packages, at budgets where the raw model fits, where the plan is promoted,
where it is demoted (down to ternary, one block at a time), where it cannot
fit, and over several machines; the plans, placements, fits, byte totals
and budgets must be equal, not close."""

import dataclasses
import math

import numpy as np
import pytest

from repro.core import cluster as JC
from repro.core.entropy import BlockEntropy as JBlockEntropy
from repro.core.policy import decide as jdecide
from repro_torch.core import cluster as TC
from repro_torch.core.entropy import BlockEntropy
from repro_torch.core.policy import decide


def _plans(seed: int, n: int = 9, nan_entropy: bool = False):
    """The same EWQ plan in both packages: block sizes and entropies drawn
    from ``seed``; with ``nan_entropy`` the entropies are NaN, as a FastEWQ
    plan's are, and a few precisions are set as its classifier would."""
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(2, 40, n) * 1_000_000]
    ents = [float(h) for h in rng.normal(6.0, 1.0, n)]
    args = [dict(block_index=i, exec_index=i + 1, entropy=h,
                 num_parameters=s, per_matrix={})
            for i, (h, s) in enumerate(zip(ents, sizes))]
    jplan = jdecide([JBlockEntropy(**a) for a in args], x_factor=1.0)
    tplan = decide([BlockEntropy(**a) for a in args], x_factor=1.0)
    if nan_entropy:
        precs = [("raw", "int8", "int8", "int4")[i % 4] for i in range(n)]
        jplan, tplan = (_nan_entropies(p.with_precisions(precs))
                        for p in (jplan, tplan))
    return jplan, tplan


def _nan_entropies(plan):
    return dataclasses.replace(plan, decisions=[
        dataclasses.replace(d, entropy=float("nan")) for d in plan.decisions])


def _key(plan):
    return ([(d.block_index, d.exec_index,
              "nan" if math.isnan(d.entropy) else d.entropy.hex(),
              d.num_parameters, d.precision) for d in plan.decisions],
            tuple("nan" if math.isnan(v) else v
                  for v in (plan.mu, plan.sigma, plan.threshold,
                            plan.x_factor)))


def _same(got: dict, want: dict):
    assert list(got) == list(want)
    assert _key(got["plan"]) == _key(want["plan"])
    assert got["placement"] == want["placement"]
    assert list(got["placement"]) == list(want["placement"])
    for k in ("fits", "total_bytes", "budget"):
        assert type(got[k]) is type(want[k]) and got[k] == want[k], k


def _machines(budgets, mem_over: float = 1.25):
    return ([JC.Machine(f"m{i}", b * mem_over, b) for i, b in
             enumerate(budgets)],
            [TC.Machine(f"m{i}", b * mem_over, b) for i, b in
             enumerate(budgets)])


# fractions of the EWQ plan's own bytes: above the raw model (step 0),
# room to promote, a squeeze that demotes, and one no precision fits
FRACTIONS = [2.5, 1.3, 1.02, 0.8, 0.5, 0.2, 0.01]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("frac", FRACTIONS)
def test_algorithm1_matches_reference(seed, frac):
    jplan, tplan = _plans(seed)
    budget = jplan.total_bytes() * frac
    jm, tm = _machines([budget])
    want = JC.optimize_distribution(jplan, jm)
    got = TC.optimize_distribution(tplan, tm)
    _same(got, want)
    assert TC.cluster_budget(tm) == JC.cluster_budget(jm) == budget
    # each fraction takes the branch it is here for
    moved = want["plan"].total_bytes() - jplan.total_bytes()
    if frac == 2.5:
        assert set(want["plan"].precisions()) == {"raw"}
    elif frac > 1:     # at 1.02 a promotion may not fit in the room left
        assert (moved > 0 if frac > 1.1 else moved >= 0) and want["fits"]
    elif frac > 0.1:
        assert moved < 0 and want["fits"]
    else:
        assert not want["fits"]
        assert set(want["plan"].precisions()) == {"ternary"}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("frac", FRACTIONS)
def test_algorithm2_matches_reference(seed, frac):
    """Algorithm 2 on a plan with NaN entropies, as FastEWQ gives it: it
    sorts by exec index, never by entropy."""
    jplan, tplan = _plans(seed, nan_entropy=True)
    budget = jplan.total_bytes() * frac
    jm, tm = _machines([budget])
    _same(TC.fastewq_resource_adjust(tplan, tm),
          JC.fastewq_resource_adjust(jplan, jm))


@pytest.mark.parametrize("split", [(0.5, 0.5), (0.6, 0.3, 0.2),
                                   (0.05, 0.05, 0.05, 0.9)])
@pytest.mark.parametrize("frac", [1.2, 0.9, 0.6])
def test_placement_over_several_machines_matches_reference(split, frac):
    """First-fit-decreasing over machines of unequal budgets, memory or
    disk the smaller; some splits leave a block with no machine."""
    jplan, tplan = _plans(4, n=12)
    total = jplan.total_bytes() * frac
    jm, tm = _machines([total * s for s in split])
    jm[0] = JC.Machine(jm[0].name, jm[0].disk_bytes * 0.9, jm[0].disk_bytes)
    tm[0] = TC.Machine(tm[0].name, tm[0].disk_bytes * 0.9, tm[0].disk_bytes)
    for fn in ("optimize_distribution", "fastewq_resource_adjust"):
        want = getattr(JC, fn)(jplan, jm)
        _same(getattr(TC, fn)(tplan, tm), want)
    if split[0] == 0.05:
        assert not want["fits"]


@pytest.mark.parametrize("hbm,devices,reserved,raw_bits", [
    (80e9, 1, 0.25, 16.0), (4 * 2**30, 1, 0.25, 16.0),
    (0.4e9, 2, 0.1, 16.0), (0.2e9, 1, 0.5, 32.0), (1e6, 1, 0.25, 16.0)])
def test_fit_plan_to_hbm_matches_reference(hbm, devices, reserved, raw_bits):
    jplan, tplan = _plans(5, n=16)
    kw = dict(hbm_bytes_per_device=hbm, devices=devices,
              reserved_fraction=reserved, raw_bits=raw_bits)
    got, want = TC.fit_plan_to_hbm(tplan, **kw), JC.fit_plan_to_hbm(jplan, **kw)
    assert _key(got) == _key(want)
    assert got.total_bytes(raw_bits) == want.total_bytes(raw_bits)
