"""Gradient-boosted trees (logistic loss) — the paper's XGB stand-in."""

from __future__ import annotations

import numpy as np


class _RegressionStump:
    """Depth-limited regression tree on residuals (squared-error splits)."""

    def __init__(self, max_depth=3, min_samples_leaf=5):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf

    def fit(self, x, g):
        self.tree_ = self._build(np.asarray(x, np.float64),
                                 np.asarray(g, np.float64), 0)
        return self

    def _build(self, x, g, depth):
        if depth >= self.max_depth or len(g) < 2 * self.min_samples_leaf:
            return ("leaf", g.mean() if len(g) else 0.0)
        n, d = x.shape
        parent_sse = ((g - g.mean()) ** 2).sum()
        best = (None, -1, 0.0)
        for f in range(d):
            order = np.argsort(x[:, f], kind="stable")
            xs, gs = x[order, f], g[order]
            csum = np.cumsum(gs)
            csq = np.cumsum(gs * gs)
            total, total_sq = csum[-1], csq[-1]
            for i in range(self.min_samples_leaf - 1,
                           n - self.min_samples_leaf):
                if xs[i] == xs[i + 1]:
                    continue
                nl = i + 1
                nr = n - nl
                sse_l = csq[i] - csum[i] ** 2 / nl
                sse_r = (total_sq - csq[i]) - (total - csum[i]) ** 2 / nr
                gain = parent_sse - sse_l - sse_r
                if best[0] is None or gain > best[0]:
                    best = (gain, f, 0.5 * (xs[i] + xs[i + 1]))
        if best[0] is None or best[0] <= 1e-12:
            return ("leaf", g.mean() if len(g) else 0.0)
        _, f, thr = best
        mask = x[:, f] <= thr
        return ("node", f, thr, self._build(x[mask], g[mask], depth + 1),
                self._build(x[~mask], g[~mask], depth + 1))

    def predict(self, x):
        x = np.asarray(x, np.float64)
        out = np.empty(len(x))
        for i, row in enumerate(x):
            node = self.tree_
            while node[0] == "node":
                _, f, thr, l, r = node
                node = l if row[f] <= thr else r
            out[i] = node[1]
        return out


class GradientBoosting:
    def __init__(self, n_estimators: int = 100, lr: float = 0.1,
                 max_depth: int = 3):
        self.n_estimators = n_estimators
        self.lr = lr
        self.max_depth = max_depth

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GradientBoosting":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        p = np.clip(y.mean(), 1e-6, 1 - 1e-6)
        self.f0_ = np.log(p / (1 - p))
        f = np.full(len(y), self.f0_)
        self.stumps_ = []
        for _ in range(self.n_estimators):
            prob = 1.0 / (1.0 + np.exp(-f))
            residual = y - prob  # negative gradient of logloss
            stump = _RegressionStump(max_depth=self.max_depth).fit(x, residual)
            self.stumps_.append(stump)
            f = f + self.lr * stump.predict(x)
        return self

    def decision_function(self, x):
        f = np.full(len(x), self.f0_)
        for stump in self.stumps_:
            f = f + self.lr * stump.predict(x)
        return f

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        p1 = 1.0 / (1.0 + np.exp(-self.decision_function(x)))
        return np.stack([1 - p1, p1], axis=1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return (self.decision_function(x) >= 0).astype(np.int64)
