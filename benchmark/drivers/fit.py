"""A closed loop of fits: ``RBFInterpolator(points, values, settings)``, one
client, each fit started when the last returned.

Parameters (``workloads/<cell>.json``): ``pool``, the number of input sets
made in set-up (fit k takes set k mod pool); ``check_rows``, the rows of
each fit whose residual the check sums (0: every row).

The check: the relative l2 residual ``resid_l2`` of every fit of the
window, ||f(x_i) - v_i|| / ||v_i|| over its rows, where f is the field of
the fit's returned sources and coefficients summed densely in float64 by
``reference/field.py``; the worst fit counts.
"""

from __future__ import annotations

import numpy as np

from benchmark import inputs
from benchmark.reference import field


def setup(cell):
    cell.state["settings"] = inputs.settings(cell)
    cell.state["inputs"] = [inputs.points_and_values(cell, "fit", k)
                            for k in range(cell.workload["pool"])]
    cell.state["fits"] = []
    _fit(cell, *inputs.points_and_values(cell, "warm"))
    cell.sync()


def _fit(cell, points, values):
    """(sources, point coefficients, drift coefficients or None)."""
    settings, params = cell.state["settings"]
    rbfi = cell.frt.RBFInterpolator(points, values, settings, params, device=cell.device)
    coef = rbfi.coefficients
    poly = None if coef.poly_coefficients is None else coef.poly_coefficients[:, 0].copy()
    return rbfi.points, coef.point_coefficients[:, 0].copy(), poly


def step(cell, k):
    j = k % cell.workload["pool"]
    cell.state["fits"].append((j, *_fit(cell, *cell.state["inputs"][j])))
    return 1


def release(cell):
    """A fit keeps no state on the card past its return."""


def check(cell):
    kernel, degree = inputs.reference_kernel(cell), inputs.drift_degree(cell)
    if cell.config["kernel"].get("nugget", 0.0):
        raise ValueError("the fit's check sums no nugget term")
    worst, failed = 0.0, 0
    limit = cell.workload["limits"]["resid_l2"]
    for k, (j, sources, w, c) in enumerate(cell.state["fits"]):
        points, values = cell.state["inputs"][j]
        rows = np.arange(points.shape[0])
        if 0 < cell.workload["check_rows"] < rows.size:
            rows = np.sort(cell.rng("check", k).choice(rows.size, cell.workload["check_rows"],
                                                       replace=False))
        r = field.residual_l2(kernel, sources, w, c, degree, points[rows], values[rows],
                              device=cell.device)
        failed += not r <= limit
        worst = max(worst, r) if np.isfinite(r) else float("inf")
    cell.state["failed_steps"] = failed
    return {"resid_l2": worst}

