"""The comparison that decides ``correct``: what the program's timed path
produced in set-up against the reference (``reference/``), as numbers,
each held to a limit of its own where the cell's ``limits/<cell>.json``
names it (PERF.md gives the readings each limit was set from).

* ``loss1``: the first step's loss, its largest relative gap over the
  configurations; ``loss``: the same over every checked step;
* ``grad``: the first gradient as Adam takes it (the L2 term included),
  worked out from the program's first moment after one step (``m = (1 -
  beta1) g``); per leaf (one parameter of one configuration) the gap
  between its norm and the reference's, against the larger of the
  reference's norm of that leaf and of the configuration's median leaf;
  the worst leaf;
* ``change``: the same of each leaf's change over the checked steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move under Adam by rounding alone);
  ``change_med``: the median of those leaves' gaps, the largest over the
  configurations;
* ``eval0``: the largest absolute gap of an evaluation log-prob at a
  valid utterance: ``VmapSweep.evaluate`` over the test split at the
  starting weights.

A number that is not finite fails.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

NAMES = ("loss1", "loss", "grad", "change", "change_med", "eval0")
SMALL_GRAD = 1e-3       # of the median leaf's gradient norm


def leaf_gaps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each leaf's |got - ref| / max(ref, the median leaf's ref), per
    configuration (rows)."""
    med = np.median(ref, axis=1, keepdims=True)
    return np.abs(got - ref) / np.maximum(np.maximum(ref, med), 1e-30)


def _logp_gap(got, ref, umasks) -> float:
    return float(max(np.abs(p - r)[:, m > 0].max()
                     for p, r, m in zip(got, ref, umasks)))


def numbers(prog: dict, ref: dict, umasks) -> Dict[str, float]:
    """Every number the check can compare.  ``prog`` and ``ref`` hold
    ``loss`` (K, steps), ``grad`` and ``change`` (K, leaves),
    ``eval0_logp`` (a list of (K, B, L, C) per test batch); ``umasks``
    the test batches' (B, L) masks."""
    rel = np.abs(prog["loss"] - ref["loss"]) / np.abs(ref["loss"])
    med = np.median(ref["grad"], axis=1, keepdims=True)
    moved = ref["grad"] >= SMALL_GRAD * med
    change = leaf_gaps(prog["change"], ref["change"])
    return dict(
        loss1=float(np.max(rel[:, 0])), loss=float(np.max(rel)),
        grad=float(leaf_gaps(prog["grad"], ref["grad"]).max()),
        change=float(np.where(moved, change, 0.0).max()),
        change_med=float(max(np.median(g[m]) for g, m in zip(change,
                                                             moved))),
        eval0=_logp_gap(prog["eval0_logp"], ref["eval0_logp"], umasks))


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that the cell's limits name within its limit (and
    finite)."""
    return all(math.isfinite(nums[n]) and nums[n] <= lim
               for n, lim in limits.items())


def report(nums: Dict[str, float], limits: Dict[str, float]) -> dict:
    return {n: {"value": nums[n], "limit": lim} for n, lim in limits.items()}
