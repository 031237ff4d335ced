"""The port's scikit-learn-free ``train_test_split``, ``KFold``,
``StratifiedKFold`` and ``roc_auc_score`` (``stamp_tpu_torch.modeling.
splits``) against scikit-learn itself, over drawn label vectors of 8–200
patients: balanced, unbalanced, string labels and survival statuses.  The
index sets must be identical (they decide which patients train and which
validate); AUROC agrees within 1e-12."""

import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.metrics import roc_auc_score as sk_roc_auc_score
from sklearn.model_selection import KFold as SkKFold
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold
from sklearn.model_selection import train_test_split as sk_train_test_split

from stamp_tpu_torch.modeling import splits

# label vectors the way STAMP stratifies: class names, 0/1 survival status
_LABEL_SETS = [("high", "low"), ("a", "b", "c"), (0, 1), ("MSI", "MSS", "POLE", "x")]


@st.composite
def _labels(draw, min_per_class: int = 2):
    classes = draw(st.sampled_from(_LABEL_SETS))
    n = draw(st.integers(8, 200))
    # unbalanced as well as balanced: the first class weighs 1–20× the others
    weights = np.array([draw(st.integers(1, 20))] + [1] * (len(classes) - 1), dtype=float)
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(classes), size=n, p=weights / weights.sum())
    # every class at least min_per_class times (scikit-learn refuses fewer)
    for c in range(len(classes)):
        idx[c * min_per_class : (c + 1) * min_per_class] = c
    rng.shuffle(idx)
    return [classes[i] for i in idx]


def _patients(n: int) -> list[str]:
    return [f"patient-{i:03d}" for i in range(n)]


@settings(max_examples=40, deadline=None)
@given(_labels())
def test_stratified_train_test_split_matches_sklearn(labels):
    ids = _patients(len(labels))
    try:
        want = sk_train_test_split(ids, stratify=labels, shuffle=True, random_state=0)
    except ValueError:  # too few patients for the classes: the port refuses too
        with pytest.raises(ValueError):
            splits.train_test_split(ids, stratify=labels, shuffle=True, random_state=0)
        return
    got = splits.train_test_split(ids, stratify=labels, shuffle=True, random_state=0)
    assert [list(w) for w in want] == [list(g) for g in got]


@settings(max_examples=20, deadline=None)
@given(st.integers(8, 200))
def test_unstratified_train_test_split_matches_sklearn(n):
    ids = _patients(n)
    want = sk_train_test_split(ids, stratify=None, shuffle=True, random_state=0)
    assert [list(w) for w in want] == [list(g) for g in splits.train_test_split(ids, random_state=0)]


@settings(max_examples=40, deadline=None)
@given(_labels(min_per_class=5), st.integers(2, 5))
def test_stratified_kfold_matches_sklearn(labels, n_splits):
    ids = np.array(_patients(len(labels)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # sparse classes warn in both
        want = list(SkStratifiedKFold(n_splits=n_splits, shuffle=True, random_state=0).split(ids, labels))
    got = list(splits.StratifiedKFold(n_splits=n_splits, shuffle=True, random_state=0).split(ids, labels))
    assert len(got) == len(want) == n_splits
    for (w_tr, w_te), (g_tr, g_te) in zip(want, got, strict=True):
        np.testing.assert_array_equal(g_tr, w_tr)
        np.testing.assert_array_equal(g_te, w_te)


@settings(max_examples=20, deadline=None)
@given(st.integers(8, 200), st.integers(2, 8))
def test_kfold_matches_sklearn(n, n_splits):
    ids = np.array(_patients(n))
    want = list(SkKFold(n_splits=n_splits, shuffle=True, random_state=0).split(ids))
    got = list(splits.KFold(n_splits=n_splits, shuffle=True, random_state=0).split(ids))
    for (w_tr, w_te), (g_tr, g_te) in zip(want, got, strict=True):
        np.testing.assert_array_equal(g_tr, w_tr)
        np.testing.assert_array_equal(g_te, w_te)


@settings(max_examples=40, deadline=None)
@given(_labels(), st.integers(0, 2**32 - 1), st.booleans())
def test_roc_auc_score_matches_sklearn(labels, seed, ties):
    """Binary: the positive class's probability; multiclass: one-vs-rest
    macro over softmax probabilities, as the classifier's validation does."""
    rng = np.random.default_rng(seed)
    classes = sorted(set(labels), key=str)
    y_true = np.array([classes.index(label) for label in labels])
    logits = rng.normal(size=(len(labels), len(classes))).astype(np.float32)
    if ties:  # coarse scores: many tied thresholds
        logits = np.round(logits, 1)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    if len(classes) == 2:
        want = sk_roc_auc_score(y_true, probs[:, 1])
        got = splits.roc_auc_score(y_true, probs[:, 1])
    else:
        want = sk_roc_auc_score(y_true, probs, multi_class="ovr", average="macro")
        got = splits.roc_auc_score(y_true, probs, multi_class="ovr", average="macro")
    assert abs(got - want) <= 1e-12


def test_roc_auc_score_raises_where_sklearn_raises():
    """A validation set missing a class of a three-class head: scikit-learn
    raises, and the classifier's validation then logs no AUROC."""
    y_true = np.array([0, 1, 0, 1])
    probs = np.full((4, 3), 1 / 3)
    with pytest.raises(ValueError):
        sk_roc_auc_score(y_true, probs, multi_class="ovr", average="macro")
    with pytest.raises(ValueError, match="Number of classes"):
        splits.roc_auc_score(y_true, probs, multi_class="ovr", average="macro")
    with pytest.raises(ValueError, match="probabilities"):
        splits.roc_auc_score(np.array([0, 1, 2]), np.ones((3, 3)), multi_class="ovr")
