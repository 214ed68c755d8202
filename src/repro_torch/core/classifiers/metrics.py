"""Classification metrics + paired statistics (paper Tables 3/4/5/11-13)."""

from __future__ import annotations

import math

import numpy as np


def confusion(y_true, y_pred) -> dict:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    tp = int(((y_true == 1) & (y_pred == 1)).sum())
    tn = int(((y_true == 0) & (y_pred == 0)).sum())
    fp = int(((y_true == 0) & (y_pred == 1)).sum())
    fn = int(((y_true == 1) & (y_pred == 0)).sum())
    return {"tp": tp, "tn": tn, "fp": fp, "fn": fn}


def classification_report(y_true, y_pred) -> dict:
    """Per-class precision/recall/F1/support + accuracy + macro/weighted."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    out = {"classes": {}}
    supports = []
    for c in (0, 1):
        tp = ((y_true == c) & (y_pred == c)).sum()
        fp = ((y_true != c) & (y_pred == c)).sum()
        fn = ((y_true == c) & (y_pred != c)).sum()
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        support = int((y_true == c).sum())
        supports.append(support)
        out["classes"][c] = {"precision": float(prec), "recall": float(rec),
                             "f1": float(f1), "support": support}
    out["accuracy"] = float((y_true == y_pred).mean())
    cs = out["classes"]
    out["macro_avg"] = {k: float(np.mean([cs[c][k] for c in (0, 1)]))
                        for k in ("precision", "recall", "f1")}
    w = np.array(supports) / max(sum(supports), 1)
    out["weighted_avg"] = {k: float(sum(w[i] * cs[c][k]
                                        for i, c in enumerate((0, 1))))
                           for k in ("precision", "recall", "f1")}
    return out


def roc_curve(y_true, scores):
    """Returns (fpr, tpr, thresholds) sorted by descending score."""
    y_true = np.asarray(y_true)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind="stable")
    y = y_true[order]
    tps = np.cumsum(y == 1)
    fps = np.cumsum(y == 0)
    p = max((y_true == 1).sum(), 1)
    n = max((y_true == 0).sum(), 1)
    tpr = np.concatenate([[0.0], tps / p])
    fpr = np.concatenate([[0.0], fps / n])
    return fpr, tpr, np.concatenate([[np.inf], scores[order]])


def auc(y_true, scores) -> float:
    fpr, tpr, _ = roc_curve(y_true, scores)
    return float(np.trapezoid(tpr, fpr))


# ---------------------------------------------------------------------------
# Paired statistics (paper §6.3.1)
# ---------------------------------------------------------------------------

def _t_sf(t: float, df: int) -> float:
    """Two-sided p-value for Student's t via the incomplete beta function
    (continued-fraction evaluation; no scipy dependency)."""
    x = df / (df + t * t)
    p = _betainc(df / 2.0, 0.5, x)
    return float(min(max(p, 0.0), 1.0))


def _betainc(a: float, b: float, x: float) -> float:
    if x <= 0:
        return 0.0
    if x >= 1:
        return 1.0
    lbeta = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
             + a * math.log(x) + b * math.log(1 - x))
    front = math.exp(lbeta)
    if x < (a + 1) / (a + b + 2):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1 - x) / b


def _betacf(a: float, b: float, x: float) -> float:
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c, d = 1.0, 1.0 - qab * x / qap
    d = 1.0 / (d if abs(d) > 1e-30 else 1e-30)
    h = d
    for m in range(1, 200):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = 1.0 / (d if abs(d) > 1e-30 else 1e-30)
        c = 1.0 + aa / (c if abs(c) > 1e-30 else 1e-30)
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = 1.0 / (d if abs(d) > 1e-30 else 1e-30)
        c = 1.0 + aa / (c if abs(c) > 1e-30 else 1e-30)
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-12:
            break
    return h


def paired_t_test(a, b) -> dict:
    """Paired t-test: t = mean(d) / (std(d)/sqrt(n)); two-sided p."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = a - b
    n = len(d)
    sd = d.std(ddof=1)
    if sd == 0 or n < 2:
        return {"t": 0.0, "p": 1.0, "mean_diff": float(d.mean())}
    t = d.mean() / (sd / np.sqrt(n))
    return {"t": float(t), "p": _t_sf(abs(t), n - 1),
            "mean_diff": float(d.mean())}


def cohens_d(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    na, nb = len(a), len(b)
    sp = np.sqrt(((na - 1) * a.var(ddof=1) + (nb - 1) * b.var(ddof=1))
                 / max(na + nb - 2, 1))
    if sp == 0:
        return 0.0
    return float((a.mean() - b.mean()) / sp)


def significance_label(p: float) -> str:
    if p < 0.05:
        return "significant"
    if p < 0.10:
        return "marginally significant"
    return "not significant"


def effect_size_label(d: float) -> str:
    d = abs(d)
    if d < 0.2:
        return "negligible"
    if d < 0.5:
        return "small"
    if d < 0.8:
        return "medium"
    return "large"
