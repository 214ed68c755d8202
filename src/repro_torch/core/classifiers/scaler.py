"""StandardScaler (paper §4.2): per-feature z-scoring fit on the train set."""

from __future__ import annotations

import numpy as np


class StandardScaler:
    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, np.float64)
        self.mean_ = x.mean(axis=0)
        self.scale_ = x.std(axis=0)
        self.scale_ = np.where(self.scale_ == 0, 1.0, self.scale_)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float64) - self.mean_) / self.scale_

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)
