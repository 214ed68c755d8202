"""Random forest — the paper's chosen FastEWQ classifier (80% held-out acc)."""

from __future__ import annotations

import numpy as np

from repro_torch.core.classifiers.tree import DecisionTree


class RandomForest:
    def __init__(self, n_estimators: int = 100, max_depth: int = 8,
                 min_samples_leaf: int = 1, max_features: str | int = "sqrt",
                 seed: int = 0):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.seed = seed

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RandomForest":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.int64)
        rng = np.random.default_rng(self.seed)
        n, d = x.shape
        mf = (max(1, int(np.sqrt(d))) if self.max_features == "sqrt"
              else self.max_features or d)
        self.trees_ = []
        for _ in range(self.n_estimators):
            idx = rng.integers(0, n, n)  # bootstrap
            tree = DecisionTree(max_depth=self.max_depth,
                                min_samples_leaf=self.min_samples_leaf,
                                max_features=mf,
                                rng=np.random.default_rng(rng.integers(2**31)))
            self.trees_.append(tree.fit(x[idx], y[idx]))
        self.n_classes_ = self.trees_[0].n_classes_
        imp = np.mean([t.feature_importances_ for t in self.trees_], axis=0)
        s = imp.sum()
        self.feature_importances_ = imp / s if s > 0 else imp
        return self

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        return np.mean([t.predict_proba(x) for t in self.trees_], axis=0)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_proba(x).argmax(axis=1)
