"""Gaussian naive Bayes."""

from __future__ import annotations

import numpy as np


class GaussianNB:
    def fit(self, x: np.ndarray, y: np.ndarray) -> "GaussianNB":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.int64)
        self.classes_ = np.unique(y)
        self.mu_ = np.stack([x[y == c].mean(0) for c in self.classes_])
        self.var_ = np.stack([x[y == c].var(0) + 1e-9 for c in self.classes_])
        self.prior_ = np.array([(y == c).mean() for c in self.classes_])
        return self

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        ll = (-0.5 * (np.log(2 * np.pi * self.var_)[None]
                      + (x[:, None, :] - self.mu_[None]) ** 2
                      / self.var_[None]).sum(-1)
              + np.log(self.prior_)[None])
        ll -= ll.max(axis=1, keepdims=True)
        p = np.exp(ll)
        return p / p.sum(axis=1, keepdims=True)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_proba(x).argmax(axis=1)
