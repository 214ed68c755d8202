"""Linear classifiers: logistic regression and linear SVM (hinge loss).

Full-batch gradient descent with L2 regularization — ample for 700-row
tabular data (paper §4.4).
"""

from __future__ import annotations

import numpy as np


class LogisticRegression:
    def __init__(self, lr: float = 0.1, steps: int = 2000, l2: float = 1e-3):
        self.lr, self.steps, self.l2 = lr, steps, l2

    def fit(self, x: np.ndarray, y: np.ndarray) -> "LogisticRegression":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        n, d = x.shape
        self.w_ = np.zeros(d)
        self.b_ = 0.0
        for _ in range(self.steps):
            z = x @ self.w_ + self.b_
            p = 1.0 / (1.0 + np.exp(-z))
            g = p - y
            self.w_ -= self.lr * (x.T @ g / n + self.l2 * self.w_)
            self.b_ -= self.lr * g.mean()
        return self

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        p1 = 1.0 / (1.0 + np.exp(-(np.asarray(x, np.float64) @ self.w_
                                   + self.b_)))
        return np.stack([1 - p1, p1], axis=1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return (self.predict_proba(x)[:, 1] >= 0.5).astype(np.int64)


class LinearSVM:
    def __init__(self, lr: float = 0.05, steps: int = 3000, c: float = 1.0):
        self.lr, self.steps, self.c = lr, steps, c

    def fit(self, x: np.ndarray, y: np.ndarray) -> "LinearSVM":
        x = np.asarray(x, np.float64)
        ys = np.where(np.asarray(y) > 0, 1.0, -1.0)
        n, d = x.shape
        self.w_ = np.zeros(d)
        self.b_ = 0.0
        for _ in range(self.steps):
            margin = ys * (x @ self.w_ + self.b_)
            active = margin < 1.0
            gw = self.w_ - self.c * (ys[active, None] * x[active]).sum(0) / n
            gb = -self.c * ys[active].sum() / n
            self.w_ -= self.lr * gw
            self.b_ -= self.lr * gb
        return self

    def decision_function(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, np.float64) @ self.w_ + self.b_

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        # Platt-free squashing for ROC purposes.
        z = self.decision_function(x)
        p1 = 1.0 / (1.0 + np.exp(-z))
        return np.stack([1 - p1, p1], axis=1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return (self.decision_function(x) >= 0).astype(np.int64)
