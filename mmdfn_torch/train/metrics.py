"""Evaluation metrics, bit-compatible with the sklearn calls in the reference
(the port's copy of ``mmdfn_tpu/train/metrics.py``; numpy only, since the
card's machine has no sklearn).

Reference usage (``code/run_train_erc.py:229-236``):
  * ``accuracy_score(labels, preds)`` (optionally ``sample_weight=umask``)
  * ``f1_score(..., average='weighted') * 100`` rounded to 2 decimals
  * ``classification_report(digits=4)`` and per-class accuracy strings.

Implemented in numpy from the confusion matrix; the tests hold them to the
JAX package's functions.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _confusion(labels: np.ndarray, preds: np.ndarray,
               n_classes: int) -> np.ndarray:
    cm = np.zeros((n_classes, n_classes), dtype=np.float64)
    np.add.at(cm, (labels.astype(int), preds.astype(int)), 1.0)
    return cm


def accuracy(labels, preds) -> float:
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    return float(np.mean(labels == preds)) if len(labels) else float("nan")


def precision_recall_f1(labels, preds, n_classes: int):
    """Per-class precision/recall/F1/support (sklearn zero_division=0
    rules)."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    cm = _confusion(labels, preds, n_classes)
    tp = np.diag(cm)
    pred_tot = cm.sum(axis=0)
    true_tot = cm.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_tot > 0, tp / pred_tot, 0.0)
        recall = np.where(true_tot > 0, tp / true_tot, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return precision, recall, f1, true_tot


def f1_score(labels, preds, n_classes: int) -> float:
    """sklearn's ``f1_score(average='weighted')``."""
    _, _, f1, support = precision_recall_f1(labels, preds, n_classes)
    tot = support.sum()
    return float(np.sum(f1 * support) / tot) if tot > 0 else 0.0


def classification_report(labels, preds, target_names: Sequence[str],
                          digits: int = 4) -> str:
    """sklearn-style classification_report text (same columns/averages)."""
    n = len(target_names)
    p, r, f, s = precision_recall_f1(labels, preds, n)
    width = max(max(len(t) for t in target_names), len("weighted avg"))
    head_fmt = "{:>{width}} " + " {:>9}" * 4
    row_fmt = "{:>{width}} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    lines = [head_fmt.format("", "precision", "recall", "f1-score",
                             "support", width=width), "\n\n"]
    tot = s.sum()
    for i, name in enumerate(target_names):
        lines.append(row_fmt.format(name, p[i], r[i], f[i], int(s[i]),
                                    width=width, digits=digits))
    lines.append("\n")
    acc = accuracy(labels, preds)
    lines.append(("{:>{width}} " + " {:>9}" * 2
                  + " {:>9.{digits}f} {:>9}\n").format(
        "accuracy", "", "", acc, int(tot), width=width, digits=digits))
    for avg_name, weights in (("macro avg", np.ones(n) / n),
                              ("weighted avg", s / max(tot, 1))):
        lines.append(row_fmt.format(
            avg_name, float(np.sum(p * weights)), float(np.sum(r * weights)),
            float(np.sum(f * weights)), int(tot), width=width, digits=digits))
    return "".join(lines)


def per_class_accuracy(labels, preds,
                       target_names: Sequence[str]) -> List[str]:
    """Reference's per-class accuracy strings (``run_train_erc.py:234-236``)."""
    labels = np.asarray(labels).ravel()
    preds = np.asarray(preds).ravel()
    out = ["ACC"]
    for i, name in enumerate(target_names):
        sel = labels == i
        acc = float(np.mean(preds[sel] == i)) if sel.any() else float("nan")
        out.append("{}: {:.4f}".format(name, acc))
    return out


def reference_rounding(x: float) -> float:
    """The reference reports ``round(metric * 100, 2)`` — keep identical."""
    return round(x * 100, 2)
