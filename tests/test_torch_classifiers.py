"""FastEWQ's classifiers, scaler and metrics in the port
(``repro_torch.core.classifiers``) against the JAX package's, to the bit.

Both packages keep these in numpy. The same seeded inputs go through each:
every classifier's ``predict``, ``predict_proba`` and
``feature_importances_`` (where it has them), the scaler's statistics, the
CART tree and the boosting stump alone, and every metric (the incomplete
beta behind the t test's p-value included) must be equal, not close."""

import math

import numpy as np
import pytest

from repro.core import fastewq as JF
from repro.core.classifiers import boosted as JB
from repro.core.classifiers import metrics as JM
from repro.core.classifiers import scaler as JS
from repro.core.classifiers import tree as JT
from repro_torch.core import fastewq as TF
from repro_torch.core.classifiers import boosted as TB
from repro_torch.core.classifiers import metrics as TM
from repro_torch.core.classifiers import scaler as TS
from repro_torch.core.classifiers import tree as TT


def _features(seed: int, n: int = 120):
    """Rows shaped like FastEWQ's (size, exec index, block count), with
    ties in the two integer columns, and labels that lean on the exec
    index; ``seed`` 1 also plants a constant column (scale 0)."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(6, 30, n).astype(np.float64)
    ex = np.floor(rng.random(n) * nb) + 1
    size = rng.uniform(3e7, 5e8, n).round()
    y = (rng.random(n) < 0.05 + 0.9 * ex / nb).astype(np.int64)
    x = np.stack([size, ex, nb], 1)
    if seed == 1:
        x[:, 2] = 12.0
    return x, y


def _equal(got, want):
    """Equal to the bit, through dicts, lists and arrays (NaN equal to
    NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, strict=True)
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got)
    else:
        assert type(got) is type(want) and got == want, (got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_scaler_statistics_match(seed):
    x, _ = _features(seed)
    js, ts = JS.StandardScaler().fit(x), TS.StandardScaler().fit(x)
    _equal(ts.mean_, js.mean_)
    _equal(ts.scale_, js.scale_)
    _equal(ts.transform(x[:7]), js.transform(x[:7]))
    if seed == 1:
        assert ts.scale_[2] == 1.0


@pytest.mark.parametrize("name", list(JF.CLASSIFIERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_classifier_matches_reference(name, seed):
    assert list(TF.CLASSIFIERS) == list(JF.CLASSIFIERS)
    x, y = _features(seed)
    xs = JS.StandardScaler().fit_transform(x)
    tr, te = slice(0, 84), slice(84, None)
    jc = JF.CLASSIFIERS[name]().fit(xs[tr], y[tr])
    tc = TF.CLASSIFIERS[name]().fit(xs[tr], y[tr])
    assert type(tc).__name__ == type(jc).__name__
    assert vars(TF.CLASSIFIERS[name]()).keys() == \
        vars(JF.CLASSIFIERS[name]()).keys()
    for part in (te, tr):
        _equal(tc.predict(xs[part]), jc.predict(xs[part]))
        _equal(tc.predict_proba(xs[part]), jc.predict_proba(xs[part]))
    assert hasattr(tc, "feature_importances_") == \
        hasattr(jc, "feature_importances_")
    if hasattr(jc, "feature_importances_"):
        _equal(tc.feature_importances_, jc.feature_importances_)


@pytest.mark.parametrize("kw", [dict(), dict(max_depth=3, min_samples_leaf=4),
                                dict(max_features=2)])
def test_tree_matches_reference(kw):
    """The CART tree alone, with and without a feature subset drawn from
    its generator: the same splits (predictions, leaf distributions) and
    the same importances."""
    x, y = _features(2)
    jt = JT.DecisionTree(rng=np.random.default_rng(3), **kw).fit(x, y)
    tt = TT.DecisionTree(rng=np.random.default_rng(3), **kw).fit(x, y)
    _equal(tt.predict_proba(x), jt.predict_proba(x))
    _equal(tt.feature_importances_, jt.feature_importances_)
    assert (tt.n_classes_, tt.n_features_) == (jt.n_classes_, jt.n_features_)
    assert abs(tt.feature_importances_.sum() - 1.0) < 1e-12


def test_regression_stump_matches_reference():
    x, y = _features(3)
    g = y - np.random.default_rng(4).random(len(y))
    js = JB._RegressionStump(max_depth=3).fit(x, g)
    ts = TB._RegressionStump(max_depth=3).fit(x, g)
    _equal(ts.predict(x), js.predict(x))


def _scores(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.int64)
    scores = np.round(rng.random(n) + 0.3 * y, 2)   # ties in the scores
    pred = (scores > 0.55).astype(np.int64)
    return y, pred, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_reference(seed):
    y, pred, scores = _scores(seed)
    _equal(TM.confusion(y, pred), JM.confusion(y, pred))
    _equal(TM.classification_report(y, pred),
           JM.classification_report(y, pred))
    _equal(TM.roc_curve(y, scores), JM.roc_curve(y, scores))
    _equal(TM.auc(y, scores), JM.auc(y, scores))
    rng = np.random.default_rng(10 + seed)
    a = rng.normal(0.8, 0.05, 12)
    b = a - rng.normal(0.01 * seed, 0.02, 12)
    _equal(TM.paired_t_test(a, b), JM.paired_t_test(a, b))
    _equal(TM.cohens_d(a, b), JM.cohens_d(a, b))


def test_metrics_edge_cases_match_reference():
    """One class only, a constant difference (p = 1), equal samples."""
    y0 = np.zeros(9, np.int64)
    _equal(TM.classification_report(y0, y0),
           JM.classification_report(y0, y0))
    _equal(TM.roc_curve(y0, np.arange(9.0)), JM.roc_curve(y0, np.arange(9.0)))
    a = np.arange(5.0)
    _equal(TM.paired_t_test(a, a - 1), JM.paired_t_test(a, a - 1))
    _equal(TM.cohens_d(a * 0, a * 0), JM.cohens_d(a * 0, a * 0))


@pytest.mark.parametrize("df", [1, 2, 5, 11, 40])
def test_t_distribution_matches_reference(df):
    for t in (0.0, 0.3, 1.0, 2.2, 7.5, 40.0):
        _equal(TM._t_sf(t, df), JM._t_sf(t, df))
    for a, b in ((0.5, 0.5), (2.0, 0.5), (df / 2.0, 0.5), (3.0, 7.0)):
        for x in (-0.1, 0.0, 0.05, 0.4, 0.77, 0.999, 1.0):
            _equal(TM._betainc(a, b, x), JM._betainc(a, b, x))
        _equal(TM._betacf(a, b, 0.3), JM._betacf(a, b, 0.3))


def test_labels_match_reference():
    for p in (0.0, 0.049, 0.05, 0.07, 0.1, 0.5):
        assert TM.significance_label(p) == JM.significance_label(p)
    for d in (-1.0, -0.3, 0.0, 0.19, 0.2, 0.6, 0.8, 2.0):
        assert TM.effect_size_label(d) == JM.effect_size_label(d)
