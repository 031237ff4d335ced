"""Patient splits and AUROC without scikit-learn.

The JAX package takes ``train_test_split`` (``stamp_tpu/modeling/train.py:
188-191``), ``KFold``/``StratifiedKFold`` (``stamp_tpu/modeling/crossval.py:
99-105``) and ``roc_auc_score`` (``stamp_tpu/modeling/tasks.py:239-256``)
from scikit-learn, which the port's GPU machine does not have.  The split is
part of a run's result (the checkpoint stores ``train_patients`` and
``valid_patients``; crossval writes ``splits.json``), so these functions give
the same indices as scikit-learn 1.9 for the arguments STAMP passes:
``np.random.RandomState(random_state)`` drawn in scikit-learn's order, the
stratified shuffle split's ``_approximate_mode`` allocation and
``StratifiedKFold``'s round-robin per-class allocation.
``tests/test_torch_splits.py`` holds them to scikit-learn.

The algorithms follow scikit-learn's ``sklearn/model_selection/_split.py``
and ``sklearn/utils/extmath.py`` (``_approximate_mode``); ``roc_auc_score``
is imported from ``statistics/metrics.py``, with the other metrics.
scikit-learn is distributed under the BSD 3-Clause License, Copyright (c)
2007-2024 The scikit-learn developers.
"""

from __future__ import annotations

import math
from collections.abc import Iterator, Sequence
from typing import Any

import numpy as np

from stamp_tpu_torch.statistics.metrics import roc_auc_score

__all__ = ["KFold", "StratifiedKFold", "roc_auc_score", "train_test_split"]


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """The approximate mode of the multivariate hypergeometric distribution
    (scikit-learn's ``_approximate_mode``): per-class draws summing to
    ``n_draws``, ties in the remainders broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _split_sizes(n_samples: int, test_size: float) -> tuple[int, int]:
    """(n_train, n_test) for a fractional ``test_size``."""
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = math.ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(
            f"With n_samples={n_samples}, test_size={test_size} the resulting train set will be empty."
        )
    return n_train, n_test


def _stratified_shuffle_split(
    y: np.ndarray, n_train: int, n_test: int, rng: np.random.RandomState
) -> tuple[np.ndarray, np.ndarray]:
    """The first split of scikit-learn's ``StratifiedShuffleSplit``."""
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is too few. The minimum "
            "number of groups for any class cannot be less than 2. Classes with too few members "
            f"are: {classes[class_counts < 2].tolist()}"
        )
    n_classes = len(classes)
    if n_train < n_classes or n_test < n_classes:
        raise ValueError(
            f"train_size = {n_train} and test_size = {n_test} should both be at least the number "
            f"of classes = {n_classes}"
        )
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: list[int] = []
    test: list[int] = []
    for i in range(n_classes):
        permuted = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(permuted[: n_i[i]])
        test.extend(permuted[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(
    items: Sequence[Any],
    *,
    test_size: float = 0.25,
    stratify: Sequence[Any] | None = None,
    shuffle: bool = True,
    random_state: int = 0,
) -> tuple[list[Any], list[Any]]:
    """scikit-learn's ``train_test_split(items, stratify=…, shuffle=True,
    random_state=…)`` for one list: (train items, test items) as lists."""
    if not shuffle:
        raise ValueError("only the shuffled split is implemented (STAMP always shuffles)")
    n_train, n_test = _split_sizes(len(items), test_size)
    rng = np.random.RandomState(random_state)
    if stratify is None:
        permutation = rng.permutation(len(items))
        train, test = permutation[n_test : n_test + n_train], permutation[:n_test]
    else:
        y = np.asarray(stratify)
        if len(y) != len(items):
            raise ValueError(f"stratify has {len(y)} labels for {len(items)} items")
        train, test = _stratified_shuffle_split(y, n_train, n_test, rng)
    return [items[i] for i in train], [items[i] for i in test]


class KFold:
    """scikit-learn's ``KFold(n_splits, shuffle=True, random_state=…)``."""

    def __init__(self, n_splits: int = 5, *, shuffle: bool = True, random_state: int = 0) -> None:
        if not shuffle:
            raise ValueError("only the shuffled split is implemented (STAMP always shuffles)")
        self.n_splits = n_splits
        self.random_state = random_state

    def _test_masks(self, n_samples: int, y: np.ndarray | None) -> Iterator[np.ndarray]:
        indices = np.arange(n_samples)
        np.random.RandomState(self.random_state).shuffle(indices)
        fold_sizes = np.full(self.n_splits, n_samples // self.n_splits, dtype=int)
        fold_sizes[: n_samples % self.n_splits] += 1
        current = 0
        for size in fold_sizes:
            mask = np.zeros(n_samples, dtype=bool)
            mask[indices[current : current + size]] = True
            yield mask
            current += size

    def split(self, X: Sequence[Any], y: Sequence[Any] | None = None) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """(train indices, test indices) per fold, each sorted ascending."""
        n_samples = len(X)
        if self.n_splits > n_samples:
            raise ValueError(
                f"Cannot have number of splits n_splits={self.n_splits} greater than the number "
                f"of samples: n_samples={n_samples}."
            )
        indices = np.arange(n_samples)
        for test in self._test_masks(n_samples, None if y is None else np.asarray(y)):
            yield indices[~test], indices[test]


class StratifiedKFold(KFold):
    """scikit-learn's ``StratifiedKFold(n_splits, shuffle=True,
    random_state=…)`` for binary or multiclass labels."""

    def split(self, X: Sequence[Any], y: Sequence[Any] | None = None) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        if y is None:
            raise ValueError("StratifiedKFold needs the labels y")
        return super().split(X, y)

    def _test_masks(self, n_samples: int, y: np.ndarray | None) -> Iterator[np.ndarray]:
        assert y is not None
        if y.ndim != 1 or len(y) != n_samples:
            raise ValueError(f"StratifiedKFold needs one label per sample, got shape {y.shape}")
        rng = np.random.RandomState(self.random_state)
        _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
        # classes numbered by first appearance, as scikit-learn does
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(
                f"n_splits={self.n_splits} cannot be greater than the number of members in each class."
            )
        y_order = np.sort(y_encoded)
        allocation = np.asarray(
            [np.bincount(y_order[i :: self.n_splits], minlength=n_classes) for i in range(self.n_splits)]
        )
        test_folds = np.empty(n_samples, dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(allocation[:, k])
            rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        for i in range(self.n_splits):
            yield test_folds == i
