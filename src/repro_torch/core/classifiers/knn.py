"""k-nearest neighbors (euclidean, majority vote)."""

from __future__ import annotations

import numpy as np


class KNN:
    def __init__(self, k: int = 7):
        self.k = k

    def fit(self, x: np.ndarray, y: np.ndarray) -> "KNN":
        self.x_ = np.asarray(x, np.float64)
        self.y_ = np.asarray(y, np.int64)
        self.n_classes_ = int(self.y_.max()) + 1
        return self

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        d2 = ((x[:, None, :] - self.x_[None, :, :]) ** 2).sum(-1)
        idx = np.argsort(d2, axis=1)[:, :self.k]
        out = np.zeros((len(x), self.n_classes_))
        for i, nbrs in enumerate(idx):
            out[i] = np.bincount(self.y_[nbrs], minlength=self.n_classes_)
        return out / self.k

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_proba(x).argmax(axis=1)
