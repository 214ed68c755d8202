"""The port's fault injector (``serving/chaos.py``) against the JAX
package's, and the artifact chaos sites of the port's checkpoint reader.

* the same calls through both injectors give the same faults, kinds and
  occurrences and the same ``log``: every CLI shorthand at two seeds,
  schedules per (site, tag), count budgets, transient faults, stalls, and
  probabilistic rules (one seeded draw a matching call); ``parse`` and the
  rule checks refuse the same inputs;
* the module-level ``fire`` / ``deny`` are no-ops with no injector, and
  ``chaos()`` installs one for its scope; the port's and the reference's
  injectors are separate objects;
* a transient ``artifact.read`` fault is retried by the port's restore; an
  ``artifact.corrupt`` hit flips one payload byte, which the crc32 check
  names as ``ArtifactCorruptionError`` with its leaf, and the same
  checkpoint restores clean without the fault; a JAX-written checkpoint
  under the same fault fails the same way in both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import chaos as jchaos
from repro_torch.checkpoint import ckpt
from repro_torch.serving import chaos as tchaos

SITES = tchaos.SITES


def _drive(mod, config, calls):
    """Run ``calls`` (site, tag, kind) through a fresh injector of ``mod``;
    returns what each call did and the injector's log."""
    inj = mod.ChaosInjector(config)
    out = []
    for site, tag, kind in calls:
        try:
            if kind == "deny":
                out.append(("deny", inj.deny(site, tag)))
            else:
                inj.fire(site, tag)
                out.append(("ok",))
        except mod.TransientFault as e:
            out.append(("transient", e.site, e.tag, e.occurrence, str(e)))
        except mod.InjectedFault as e:
            out.append(("permanent", e.site, e.tag, e.occurrence,
                        e.transient, str(e)))
    return out, list(inj.log)


def _calls(n=6, tags=(None, 0, 1)):
    """Three rounds of ``fire`` at every site and tag, then rounds of
    ``fire`` and ``deny`` in turn (both advance the same occurrence)."""
    fires = [(site, tag, "fire") for _ in range(3) for site in SITES
             for tag in tags]
    return fires + [(site, tag, kind) for _ in range(n) for site in SITES
                    for tag in tags for kind in ("fire", "deny")]


def _configs(mod, seed):
    short = sorted(mod.FaultConfig._SHORTHAND)
    yield from (mod.FaultConfig.parse(s, seed=seed) for s in short)
    yield mod.FaultConfig.parse(",".join(short), seed=seed)
    yield mod.FaultConfig(rules=(
        mod.FaultRule(site="pool.oom", prob=0.4, count=0),
        mod.FaultRule(site="replica.harvest", prob=0.3, count=3, tag=1),
        mod.FaultRule(site="replica.dispatch", at=(2, 5), count=0,
                      transient=True),
        mod.FaultRule(site="artifact.corrupt", at=(1, 3), count=1)),
        seed=seed)


def test_shorthands_match_reference():
    assert tchaos.SITES == jchaos.SITES
    assert tchaos.FaultConfig._SHORTHAND == jchaos.FaultConfig._SHORTHAND


@pytest.mark.parametrize("seed", [0, 7])
def test_injector_schedules_match_reference(seed, monkeypatch):
    slept = []         # both modules sleep through the one time module
    monkeypatch.setattr(tchaos.time, "sleep", slept.append)
    calls = _calls()
    fired = 0
    for tcfg, jcfg in zip(_configs(tchaos, seed), _configs(jchaos, seed)):
        assert tcfg.seed == jcfg.seed
        assert ([dataclasses.asdict(r) for r in tcfg.rules]
                == [dataclasses.asdict(r) for r in jcfg.rules])
        tout, tlog = _drive(tchaos, tcfg, calls)
        jout, jlog = _drive(jchaos, jcfg, calls)
        assert tout == jout
        assert tlog == jlog
        fired += len(tlog)
    assert fired > 0 and slept and set(slept) == {0.05}


def test_schedule_counts_budgets_and_draws():
    cfg = tchaos.FaultConfig(rules=(tchaos.FaultRule(
        site="pool.oom", at=(2, 5), count=0),), seed=3)
    inj = tchaos.ChaosInjector(cfg)
    assert [inj.deny("pool.oom", tag=0) for _ in range(6)] == \
        [False, True, False, False, True, False]
    assert inj.log == [("pool.oom", 0, 2), ("pool.oom", 0, 5)]
    inj = tchaos.ChaosInjector(tchaos.FaultConfig(rules=(
        tchaos.FaultRule(site="replica.dispatch", tag=1, at=(2,)),)))
    inj.fire("replica.dispatch", tag=0)
    inj.fire("replica.dispatch", tag=0)
    inj.fire("replica.dispatch", tag=1)
    with pytest.raises(tchaos.InjectedFault) as e:
        inj.fire("replica.dispatch", tag=1)
    assert e.value.occurrence == 2 and e.value.tag == 1
    assert not e.value.transient
    inj = tchaos.ChaosInjector(tchaos.FaultConfig(rules=(
        tchaos.FaultRule(site="artifact.read", at=(1, 2, 3), count=2,
                         transient=True),)))
    for _ in range(2):
        with pytest.raises(tchaos.TransientFault):
            inj.fire("artifact.read")
    inj.fire("artifact.read")                  # budget spent
    cfg = tchaos.FaultConfig(rules=(tchaos.FaultRule(
        site="pool.oom", prob=0.5, count=0),), seed=7)

    def seq():
        inj = tchaos.ChaosInjector(cfg)
        return [inj.deny("pool.oom") for _ in range(32)]

    assert seq() == seq() and any(seq()) and not all(seq())


def test_parse_and_rules_refuse_what_the_reference_refuses():
    for mod in (tchaos, jchaos):
        cfg = mod.FaultConfig.parse("replica_fault, oom,", seed=4)
        assert cfg.seed == 4 and len(cfg.rules) == 2
        with pytest.raises(ValueError, match="unknown chaos shorthand"):
            mod.FaultConfig.parse("nope")
        with pytest.raises(ValueError, match="unknown fault site"):
            mod.FaultRule(site="replica.explode")
        with pytest.raises(ValueError, match="unknown fault mode"):
            mod.FaultRule(site="pool.oom", mode="smolder")


def test_module_level_sites_are_noops_when_inactive():
    assert tchaos.active() is None and jchaos.active() is None
    tchaos.fire("replica.dispatch", tag=0)
    assert tchaos.deny("pool.oom") is False
    rule = tchaos.FaultRule(site="pool.oom", at=(1,))
    with tchaos.chaos(tchaos.FaultConfig(rules=(rule,))) as inj:
        assert tchaos.active() is inj
        assert jchaos.active() is None          # two injectors, apart
        assert jchaos.deny("pool.oom") is False
        assert tchaos.deny("pool.oom") is True
    assert tchaos.active() is None
    prev = tchaos.install(tchaos.ChaosInjector(tchaos.FaultConfig()))
    assert prev is None and tchaos.install(None) is not None


# ---------------------------------------------------------------------------
# artifact chaos through the port's checkpoint reader
# ---------------------------------------------------------------------------

def _tree():
    from repro_torch.quant.quantize import quantize
    return {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16)},
            "q": quantize(torch.ones(4, 128) * 0.3, "int8")}


def test_transient_read_is_retried(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 1, tree)
    with tchaos.chaos(tchaos.FaultConfig.parse("artifact")) as inj:
        restored, _ = ckpt.restore(str(tmp_path), tree)
    assert inj.log == [("artifact.read", None, 1)]
    assert torch.equal(restored["w"], tree["w"])
    assert torch.equal(restored["q"].data, tree["q"].data)


def test_persistent_read_fault_gives_up(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 1, tree)
    rule = tchaos.FaultRule(site="artifact.read", at=(1, 2, 3), count=0,
                            transient=True)
    with tchaos.chaos(tchaos.FaultConfig(rules=(rule,))) as inj:
        with pytest.raises(tchaos.TransientFault):
            ckpt.restore(str(tmp_path), tree)
    assert len(inj.log) == 3                   # the retry's three attempts


def test_corrupted_payload_names_its_leaf(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 1, tree)
    rule = tchaos.FaultRule(site="artifact.corrupt", at=(1,))
    with tchaos.chaos(tchaos.FaultConfig(rules=(rule,))):
        with pytest.raises(ckpt.ArtifactCorruptionError) as e:
            ckpt.restore(str(tmp_path), tree)
    # the first stored array in key order is the one flipped
    assert e.value.leaf == "nested/b"
    restored, _ = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])


def test_reference_checkpoint_corrupts_alike(tmp_path):
    """A checkpoint the JAX package wrote, under each package's corrupt
    site: both readers name the same leaf."""
    import jax.numpy as jnp
    from repro.checkpoint import ckpt as jckpt
    jtree = {"w": jnp.arange(12.0).reshape(3, 4),
             "nested": {"b": jnp.ones((5,), jnp.bfloat16)}}
    jckpt.save(tmp_path, 1, jtree)
    rule = dict(site="artifact.corrupt", at=(1,))
    with jchaos.chaos(jchaos.FaultConfig(rules=(jchaos.FaultRule(**rule),))):
        with pytest.raises(jckpt.ArtifactCorruptionError) as je:
            jckpt.restore(tmp_path, jtree)
    ttree = {"w": torch.zeros(3, 4),
             "nested": {"b": torch.zeros(5, dtype=torch.bfloat16)}}
    with tchaos.chaos(tchaos.FaultConfig(rules=(tchaos.FaultRule(**rule),))):
        with pytest.raises(ckpt.ArtifactCorruptionError) as te:
            ckpt.restore(str(tmp_path), ttree)
    assert te.value.leaf == je.value.leaf
    restored, _ = ckpt.restore(str(tmp_path), ttree)
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  np.arange(12.0).reshape(3, 4))
