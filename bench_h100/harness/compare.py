"""The numbers that decide ``correct``, and their judgement against the
cell's limits (``limits/<cell>.json``, set from the readings PERF.md
gives)."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

import numpy as np


def rel_gap(port: float, ref: float) -> float:
    return abs(port - ref) / max(abs(ref), 1e-30)


def leaf_gaps(port: Dict, ref: Dict,
              names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's (not
    the norm of their difference), over the larger of the reference
    leaf's norm and the median leaf's."""
    names = list(ref if names is None else names)
    pn = {k: float(port[k].double().norm()) for k in names}
    rn = {k: float(ref[k].double().norm()) for k in names}
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def total_gap(port: Dict, ref: Dict, names: Iterable[str]) -> float:
    """The gap between the program's and the reference's norm of the named
    leaves taken together, over the reference's."""
    names = list(names)
    pn = math.sqrt(sum(float(port[k].double().norm()) ** 2 for k in names))
    rn = math.sqrt(sum(float(ref[k].double().norm()) ** 2 for k in names))
    return abs(pn - rn) / max(rn, 1e-30)


def moved(grads: Dict, share: float = 1e-3):
    """The leaves whose reference gradient is not nought to rounding: at
    least ``share`` of the median leaf's norm."""
    norms = {k: float(g.double().norm()) for k, g in grads.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= share * med]


def train_numbers(port: dict, ref: dict, first: int) -> Dict[str, float]:
    """``port`` / ``ref``: per micro-step ``stats`` (dicts with loss and
    MSE), ``grad1`` (the first update's gradient by name), ``change`` (the
    parameters' change after the compared updates), ``bn`` (the BatchNorm
    running statistics' change) and ``tracked`` (their update counts).
    ``loss_gap`` covers the ``first`` micro-steps, those of the first
    update, where both sides hold the same weights, and ``bn_gap`` the
    running statistics once those are in (``bn1``, ``tracked1``); the
    readings ``loss_gap_all`` and ``bn_gap_all`` (not compared) every
    micro-step. The gradient and the change leave out the leaves whose
    reference gradient is nought to rounding (``moved``); the gradient is
    read at its worst and at its median leaf (``grad_gap_median``), the
    change at its worst leaf and over those leaves taken together
    (``change_gap_total``): the limits compare those two forms, since
    the MAE loss's gradient flips sign at residuals within round-off of
    zero and the worst leaves swing with it (PERF.md). ``detail`` (a
    reading, never compared) names the worst leaves."""
    steps = [max(rel_gap(p[k], r[k]) for k in ("loss", "MSE"))
             for p, r in zip(port["stats"], ref["stats"])]
    if len(port["stats"]) != len(ref["stats"]) or not steps:
        steps = [math.inf]
    bn = leaf_gaps(port["bn1"], ref["bn1"])
    bn_all = leaf_gaps(port["bn"], ref["bn"])
    if port["tracked1"] != ref["tracked1"]:
        bn = {k: math.inf for k in bn}
    if port["tracked"] != ref["tracked"]:
        bn_all = {k: math.inf for k in bn_all}
    leaves = moved(ref["grad1"])
    grad = leaf_gaps(port["grad1"], ref["grad1"], leaves)
    change = leaf_gaps(port["change"], ref["change"], leaves)
    out = {"loss_gap": max(steps[:first]), "loss_gap_all": max(steps),
           "grad_gap": max(grad.values()),
           "grad_gap_median": statistics.median(grad.values()),
           "change_gap": max(change.values()),
           "change_gap_total": total_gap(port["change"], ref["change"],
                                         leaves),
           "bn_gap": max(bn.values()), "bn_gap_all": max(bn_all.values())}
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]
    out["detail"] = {"loss_steps": steps, "grad": top(grad),
                     "change": top(change), "bn": top(bn),
                     "left_out": sorted(set(ref["grad1"]) - set(leaves))}
    return out


def pred_gap(port: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap of one batch's predictions, over the largest
    reference entry."""
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """-> (correct, {name: {value, limit}}) over the limited numbers."""
    compared = {k: {"value": numbers.get(k, math.nan), "limit": v}
                for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared
