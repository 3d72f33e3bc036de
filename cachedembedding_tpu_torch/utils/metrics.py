"""Evaluation metrics — a copy of ``cachedembedding_tpu/utils/metrics.py``
(AUROC / Accuracy as the reference computes them with torchmetrics).

``auroc`` is the exact rank-based computation (equivalent to torchmetrics with all
thresholds); ``StreamingMetrics`` accumulates scores/labels on host across eval
batches and computes once at the end, mirroring `.compute()` semantics.
"""

from __future__ import annotations

from typing import List

import numpy as np


def auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Exact AUROC via the Mann-Whitney U statistic (average ranks handle ties)."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()
    n_pos = int((labels == 1).sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(scores.size, dtype=np.float64)
    # average ranks over tied groups
    i = 0
    start_rank = 1.0
    while i < sorted_scores.size:
        j = i
        while j + 1 < sorted_scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        avg = (start_rank + start_rank + (j - i)) / 2.0
        ranks[order[i : j + 1]] = avg
        start_rank += j - i + 1
        i = j + 1
    sum_pos_ranks = ranks[labels == 1].sum()
    return float((sum_pos_ranks - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def accuracy(scores: np.ndarray, labels: np.ndarray, threshold: float = 0.5) -> float:
    preds = (np.asarray(scores).ravel() >= threshold).astype(np.int64)
    if preds.size == 0:  # empty eval stream: defined NaN, no RuntimeWarning
        return float("nan")
    return float((preds == np.asarray(labels).ravel()).mean())


class StreamingMetrics:
    def __init__(self):
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def update(self, scores, labels) -> None:
        self._scores.append(np.asarray(scores))
        self._labels.append(np.asarray(labels))

    def compute(self) -> dict:
        s = np.concatenate(self._scores) if self._scores else np.zeros(0)
        l = np.concatenate(self._labels) if self._labels else np.zeros(0)
        return {"auroc": auroc(s, l), "accuracy": accuracy(s, l), "count": int(s.size)}

    def reset(self) -> None:
        self._scores.clear()
        self._labels.clear()
