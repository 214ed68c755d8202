"""CART decision tree (gini impurity), numpy only (no sklearn)."""

from __future__ import annotations

import numpy as np


class _Node:
    __slots__ = ("feature", "threshold", "left", "right", "proba")

    def __init__(self):
        self.feature = -1
        self.threshold = 0.0
        self.left = None
        self.right = None
        self.proba = None  # leaf class distribution


def _gini(counts: np.ndarray) -> float:
    n = counts.sum()
    if n == 0:
        return 0.0
    p = counts / n
    return 1.0 - float((p * p).sum())


class DecisionTree:
    def __init__(self, max_depth: int = 8, min_samples_leaf: int = 1,
                 max_features: int | None = None, rng=None):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng or np.random.default_rng(0)

    def fit(self, x: np.ndarray, y: np.ndarray) -> "DecisionTree":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.int64)
        self.n_classes_ = int(y.max()) + 1 if len(y) else 2
        self.n_features_ = x.shape[1]
        self.feature_importances_ = np.zeros(self.n_features_)
        self.root_ = self._build(x, y, 0)
        s = self.feature_importances_.sum()
        if s > 0:
            self.feature_importances_ /= s
        return self

    def _leaf(self, y):
        node = _Node()
        counts = np.bincount(y, minlength=self.n_classes_)
        node.proba = counts / max(counts.sum(), 1)
        return node

    def _build(self, x, y, depth):
        if (depth >= self.max_depth or len(y) < 2 * self.min_samples_leaf
                or len(np.unique(y)) == 1):
            return self._leaf(y)

        n, d = x.shape
        feats = np.arange(d)
        if self.max_features and self.max_features < d:
            feats = self.rng.choice(d, self.max_features, replace=False)

        parent_counts = np.bincount(y, minlength=self.n_classes_)
        parent_gini = _gini(parent_counts)
        best = (None, -1, 0.0)  # (gain, feature, threshold)

        for f in feats:
            order = np.argsort(x[:, f], kind="stable")
            xs, ys = x[order, f], y[order]
            left = np.zeros(self.n_classes_)
            right = parent_counts.astype(np.float64).copy()
            for i in range(n - 1):
                left[ys[i]] += 1
                right[ys[i]] -= 1
                if xs[i] == xs[i + 1]:
                    continue
                nl, nr = i + 1, n - i - 1
                if nl < self.min_samples_leaf or nr < self.min_samples_leaf:
                    continue
                gain = parent_gini - (nl * _gini(left) + nr * _gini(right)) / n
                if best[0] is None or gain > best[0]:
                    best = (gain, f, 0.5 * (xs[i] + xs[i + 1]))

        if best[0] is None or best[0] <= 1e-12:
            return self._leaf(y)

        gain, f, thr = best
        self.feature_importances_[f] += gain * len(y)
        node = _Node()
        node.feature, node.threshold = int(f), float(thr)
        mask = x[:, f] <= thr
        node.left = self._build(x[mask], y[mask], depth + 1)
        node.right = self._build(x[~mask], y[~mask], depth + 1)
        return node

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        out = np.zeros((len(x), self.n_classes_))
        for i, row in enumerate(x):
            node = self.root_
            while node.proba is None:
                node = node.left if row[node.feature] <= node.threshold \
                    else node.right
            out[i] = node.proba
        return out

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_proba(x).argmax(axis=1)
