"""Metrics registry: counters, gauges and fixed-bucket histograms with
labels, exported as Prometheus text exposition and stable JSON (the JAX
package's ``obs/metrics.py``, copied: the port imports nothing of it).

The registry is the single source of truth for serving statistics:
``ServeSession.finalize`` publishes a run into a per-run registry
(``obs/serve_metrics.py``) and ``ServeStats`` is rebuilt from it as a
snapshot view (``ServeStats.from_registry``), so the CLI report, the
Prometheus and JSON expositions all read the same numbers.

Conventions: metric names are ``serve_``-prefixed snake_case; counters end
in ``_total``, metrics with a unit end in it (``_seconds``, ``_tokens``,
``_bytes``); label values are strings. Histograms keep their raw samples
beside the fixed buckets, so ``quantile`` is ``np.percentile`` over the
observed values; the Prometheus exposition carries the cumulative buckets.
The same operations give the same exposition, byte for byte, as the JAX
package's registry.

Stdlib and numpy only: every serving layer can publish into it without an
import cycle.
"""

from __future__ import annotations

import json
import math
from typing import Iterable, Optional

import numpy as np

# Prometheus-style latency buckets (seconds). Fixed so expositions from
# different runs/replicas merge bucket-for-bucket.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# raw-sample cap per label set: serving runs observe a few samples per
# request/chunk, far below this; the cap only bounds pathological loops
MAX_SAMPLES = 65536

_TYPES = ("counter", "gauge", "histogram")


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Metric:
    """One named metric family holding per-label-set series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: dict[tuple, float] = {}

    # -- write ---------------------------------------------------------------
    def _slot(self, labels: dict) -> tuple:
        return _label_key(labels)

    # -- read ----------------------------------------------------------------
    def value(self, **labels) -> Optional[float]:
        return self._series.get(_label_key(labels))

    def total(self) -> float:
        return float(sum(self._series.values()))

    def series(self) -> dict[tuple, float]:
        return dict(self._series)

    def labeled(self, key: str) -> dict[str, float]:
        """Collapse the series onto one label key: value-of-``key`` ->
        summed value (e.g. per-tier step counts)."""
        out: dict[str, float] = {}
        for ls, v in self._series.items():
            d = dict(ls)
            if key in d:
                out[d[key]] = out.get(d[key], 0.0) + v
        return out

    # -- exposition ----------------------------------------------------------
    def _sample_lines(self) -> list[str]:
        lines = []
        for ls in sorted(self._series):
            lbl = ("{" + ",".join(f'{k}="{v}"' for k, v in ls) + "}"
                   if ls else "")
            lines.append(f"{self.name}{lbl} "
                         f"{_fmt_value(self._series[ls])}")
        return lines

    def expose(self) -> list[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        lines.extend(self._sample_lines())
        return lines

    def snapshot(self) -> dict:
        return {
            "type": self.kind,
            "help": self.help,
            "samples": [{"labels": dict(ls), "value": v}
                        for ls, v in sorted(self._series.items())],
        }

    def merge_from(self, other: "Metric") -> None:
        for ls, v in other._series.items():
            self._series[ls] = self._series.get(ls, 0.0) + v


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {value})")
        k = self._slot(labels)
        self._series[k] = self._series.get(k, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._slot(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        k = self._slot(labels)
        self._series[k] = self._series.get(k, 0.0) + value

    def merge_from(self, other: "Metric") -> None:
        # gauges are level readings, not flows: last write wins
        self._series.update(other._series)


class Histogram(Metric):
    """Fixed-bucket histogram that also retains raw samples so exact
    quantiles survive the registry migration (ServeStats percentiles must
    match ``np.percentile`` over the original lists)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(set(float(b) for b in buckets)))
        self._counts: dict[tuple, list[int]] = {}   # per-bucket (+Inf last)
        self._sum: dict[tuple, float] = {}
        self._n: dict[tuple, int] = {}
        self._samples: dict[tuple, list[float]] = {}

    def observe(self, value: float, **labels) -> None:
        k = self._slot(labels)
        if k not in self._counts:
            self._counts[k] = [0] * (len(self.buckets) + 1)
            self._sum[k] = 0.0
            self._n[k] = 0
            self._samples[k] = []
        counts = self._counts[k]
        for i, b in enumerate(self.buckets):
            if value <= b:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sum[k] += float(value)
        self._n[k] += 1
        if len(self._samples[k]) < MAX_SAMPLES:
            self._samples[k].append(float(value))

    # -- read ----------------------------------------------------------------
    def _matching(self, labels: dict) -> list[tuple]:
        """Label sets whose labels are a superset of ``labels`` (so
        ``quantile(50)`` aggregates across replicas/priorities while
        ``quantile(50, priority="0")`` narrows to one class)."""
        want = set(_label_key(labels))
        return [k for k in self._n if want <= set(k)]

    def samples(self, **labels) -> list[float]:
        out: list[float] = []
        for k in self._matching(labels):
            out.extend(self._samples[k])
        return out

    def quantile(self, q: float, **labels) -> float:
        vals = self.samples(**labels)
        return float(np.percentile(vals, q)) if vals else 0.0

    def max(self, **labels) -> float:
        vals = self.samples(**labels)
        return max(vals) if vals else 0.0

    def count(self, **labels) -> int:
        return int(sum(self._n[k] for k in self._matching(labels)))

    def sum(self, **labels) -> float:
        return float(sum(self._sum[k] for k in self._matching(labels)))

    def label_values(self, key: str) -> list[str]:
        vals = {dict(k).get(key) for k in self._n}
        return sorted(v for v in vals if v is not None)

    # -- exposition ----------------------------------------------------------
    def _sample_lines(self) -> list[str]:
        lines = []
        for ls in sorted(self._n):
            base = ",".join(f'{k}="{v}"' for k, v in ls)
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[ls][i]
                le = f'le="{_fmt_value(b)}"'
                lbl = "{" + (base + "," if base else "") + le + "}"
                lines.append(f"{self.name}_bucket{lbl} {cum}")
            cum += self._counts[ls][-1]
            lbl = "{" + (base + "," if base else "") + 'le="+Inf"' + "}"
            lines.append(f"{self.name}_bucket{lbl} {cum}")
            sfx = "{" + base + "}" if base else ""
            lines.append(f"{self.name}_sum{sfx} "
                         f"{_fmt_value(self._sum[ls])}")
            lines.append(f"{self.name}_count{sfx} {self._n[ls]}")
        return lines

    def snapshot(self) -> dict:
        return {
            "type": self.kind,
            "help": self.help,
            "buckets": list(self.buckets),
            "samples": [{
                "labels": dict(ls),
                "count": self._n[ls],
                "sum": self._sum[ls],
                "bucket_counts": list(self._counts[ls]),
            } for ls in sorted(self._n)],
        }

    def merge_from(self, other: "Metric") -> None:
        assert isinstance(other, Histogram)
        if other.buckets != self.buckets:
            raise ValueError(f"histogram {self.name}: bucket mismatch")
        for ls in other._n:
            if ls not in self._counts:
                self._counts[ls] = [0] * (len(self.buckets) + 1)
                self._sum[ls] = 0.0
                self._n[ls] = 0
                self._samples[ls] = []
            self._counts[ls] = [a + b for a, b in
                                zip(self._counts[ls], other._counts[ls])]
            self._sum[ls] += other._sum[ls]
            self._n[ls] += other._n[ls]
            room = MAX_SAMPLES - len(self._samples[ls])
            if room > 0:
                self._samples[ls].extend(other._samples[ls][:room])


class MetricsRegistry:
    """Create-or-get metric families; exposition over the whole set."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        if help and not m.help:
            m.help = help   # a live emitter created it help-less first
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    # -- convenience reads (0-defaults keep ServeStats reconstruction terse)
    def total(self, name: str) -> float:
        m = self._metrics.get(name)
        return m.total() if m is not None else 0.0

    def quantile(self, name: str, q: float, **labels) -> float:
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        assert isinstance(m, Histogram), name
        return m.quantile(q, **labels)

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry in: counters/histograms add, gauges take
        the other's level. Cross-run accumulation (Prometheus semantics)
        and per-replica -> global roll-up both go through here."""
        for name, m in other._metrics.items():
            mine = self._get(type(m), name, m.help,
                             **({"buckets": m.buckets}
                                if isinstance(m, Histogram) else {}))
            mine.merge_from(m)

    # -- exposition ----------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        """Stable JSON-serializable view (sorted names, sorted labels)."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
