"""FastEWQ (paper §4): O(1) quantization decisions from architecture
metadata — no weight download.

Features per block: (num_parameters, exec_index, num_blocks). A classifier
(random forest by default, per the paper's model selection) predicts
quantized/not; Algorithm 2 then assigns precision levels by exec_index under
resource constraints (``repro_torch.core.cluster``).
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Sequence

import numpy as np

from repro_torch.core.classifiers.boosted import GradientBoosting
from repro_torch.core.classifiers.gnb import GaussianNB
from repro_torch.core.classifiers.knn import KNN
from repro_torch.core.classifiers.linear import (LinearSVM,
                                                 LogisticRegression)
from repro_torch.core.classifiers.metrics import (auc, classification_report,
                                                  confusion)
from repro_torch.core.classifiers.rf import RandomForest
from repro_torch.core.classifiers.scaler import StandardScaler
from repro_torch.core.dataset import (FEATURES, BlockRow, to_xy,
                                      train_test_split)
from repro_torch.core.policy import BlockDecision, QuantPlan

CLASSIFIERS = {
    "logistic regression": lambda: LogisticRegression(),
    "SVM": lambda: LinearSVM(),
    "random forest": lambda: RandomForest(n_estimators=80, max_depth=8),
    "XGB": lambda: GradientBoosting(n_estimators=80),
    "kNN": lambda: KNN(k=7),
    "Gaussian naive Bayes": lambda: GaussianNB(),
}


@dataclasses.dataclass
class FastEWQ:
    """Trained FastEWQ classifier + scaler."""
    scaler: StandardScaler
    clf: object
    name: str = "random forest"

    def predict_quantized(self, num_parameters, exec_index, num_blocks):
        x = np.atleast_2d(np.array(
            [num_parameters, exec_index, num_blocks], np.float64))
        return int(self.clf.predict(self.scaler.transform(x))[0])

    def plan(self, block_sizes: Sequence[int], *, start_exec_index: int = 1,
             variant: str = "8bit-mixed") -> QuantPlan:
        """O(1)-per-block plan from metadata only (paper Algorithm 2 phase 1:
        classify; phase 2 initializes quantized blocks at 8-bit — resource
        adjustment is cluster.fastewq_resource_adjust)."""
        n = len(block_sizes)
        decisions = []
        for i, size in enumerate(block_sizes):
            exec_index = start_exec_index + i
            q = self.predict_quantized(size, exec_index, n)
            prec = "int8" if q else "raw"
            decisions.append(BlockDecision(
                block_index=i, exec_index=exec_index, entropy=float("nan"),
                num_parameters=int(size), precision=prec))
        if variant.startswith("4bit") and decisions:
            # the highest-exec-index quantized block drops to int4 (§6.3)
            for d in reversed(decisions):
                if d.quantized:
                    decisions[d.block_index] = dataclasses.replace(
                        d, precision="int4")
                    break
        return QuantPlan(decisions=decisions, mu=float("nan"),
                         sigma=float("nan"), threshold=float("nan"),
                         x_factor=1.0)

    def save(self, path: str):
        """Pickle the classifier and scaler. The pickle names the port's
        classes; one written by the JAX package names that package's and
        is not for ``load`` here."""
        with open(path, "wb") as f:
            pickle.dump(self, f)

    def kv_spill_order(self, block_sizes: Sequence[int], *,
                       start_exec_index: int = 1) -> list:
        """Layer order for graceful KV degradation
        (``quant.compiler.degrade_kv_ladder``).

        Same O(1) metadata classification as ``plan``: blocks FastEWQ
        marks quantizable spill their KV precision down a tier FIRST
        (their activations tolerate coarser representation — the layer-
        level entropy signal the classifier encodes), and within each
        class later exec indices spill before earlier ones, mirroring
        §6.3's rule that the deepest quantized block is the first to
        drop to 4-bit. Returns block indices, first-to-spill first.
        """
        n = len(block_sizes)
        ranked = []
        for i, size in enumerate(block_sizes):
            q = self.predict_quantized(size, start_exec_index + i, n)
            ranked.append((0 if q else 1, -(start_exec_index + i), i))
        return [i for _, _, i in sorted(ranked)]

    @staticmethod
    def load(path: str) -> "FastEWQ":
        with open(path, "rb") as f:
            return pickle.load(f)


def train_fastewq(rows: Sequence[BlockRow], *, classifier: str = "random forest",
                  full_dataset: bool = False, seed: int = 0) -> FastEWQ:
    """``full_dataset=True`` = the paper's overfitted 'fast' variant (99%
    train acc, centralized knowledge base); False = 70/30 'fast train'."""
    x, y = to_xy(rows)
    if full_dataset:
        xtr, ytr = x, y
    else:
        xtr, ytr, _, _ = train_test_split(x, y, 0.3, seed)
    scaler = StandardScaler()
    clf = CLASSIFIERS[classifier]()
    clf.fit(scaler.fit_transform(xtr), ytr)
    return FastEWQ(scaler=scaler, clf=clf, name=classifier)


def evaluate_all_classifiers(rows: Sequence[BlockRow], *, seed: int = 0):
    """Paper Tables 3 + 5 + ROC-AUC for all six classifiers."""
    x, y = to_xy(rows)
    xtr, ytr, xte, yte = train_test_split(x, y, 0.3, seed)
    scaler = StandardScaler()
    xtr_s = scaler.fit_transform(xtr)
    xte_s = scaler.transform(xte)
    out = {}
    for name, make in CLASSIFIERS.items():
        clf = make()
        clf.fit(xtr_s, ytr)
        pred = clf.predict(xte_s)
        scores = clf.predict_proba(xte_s)[:, 1]
        rep = classification_report(yte, pred)
        rep["confusion"] = confusion(yte, pred)
        rep["auc"] = auc(yte, scores)
        if hasattr(clf, "feature_importances_"):
            rep["feature_importances"] = dict(
                zip(FEATURES, map(float, clf.feature_importances_)))
        out[name] = rep
    return out


def feature_ablation(rows: Sequence[BlockRow], *, seed: int = 0) -> dict:
    """Paper §4.3 ablation: drop one feature, report RF accuracy."""
    x, y = to_xy(rows)
    out = {}
    for drop in [None, *range(x.shape[1])]:
        cols = [i for i in range(x.shape[1]) if i != drop]
        xtr, ytr, xte, yte = train_test_split(x[:, cols], y, 0.3, seed)
        sc = StandardScaler()
        clf = RandomForest(n_estimators=80, max_depth=8)
        clf.fit(sc.fit_transform(xtr), ytr)
        acc = float((clf.predict(sc.transform(xte)) == yte).mean())
        key = "all" if drop is None else f"without_{FEATURES[drop]}"
        out[key] = acc
    return out
