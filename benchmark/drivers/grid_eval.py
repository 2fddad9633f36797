"""A closed loop of one-shot grid evaluations: ``RBFInterpolator.evaluate``
on a regular grid, one client, each call started when the last returned.

Set-up draws the model from the seed: the configuration's points, point
coefficients from a normal law projected so that P^T w = 0 (as a fit's
are; P the drift's monomials) and drift coefficients from a uniform law,
handed to the port through ``RBFInterpolator.from_numpy_state`` and to
the reference as they are. The FMM's work depends on the points and
the grid, not on these values.

Parameters: ``grid`` (points per side), ``box`` ([lo, hi] of every side),
``pool`` (grids made in set-up; call k takes grid k mod pool, its origin
shifted by a fraction of a spacing drawn from the seed), ``check_targets``
(targets of each call the check compares).

The check: ``value_err``, the largest |evaluate - reference| over the
sampled targets of every call of the window, over the largest |reference|;
the reference is ``reference/field.py``'s dense float64 sum.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import field


def _grid(cell, d, *keys):
    """A regular grid of ``grid`` points per side in ``d`` dimensions, its
    origin shifted by a fraction of a spacing drawn from the seed."""
    n, (lo, hi) = cell.workload["grid"], cell.workload["box"]
    step = (hi - lo) / (n - 1)
    axis = lo + step * (np.arange(n) + cell.rng("grid", *keys).random())
    g = np.meshgrid(*[axis] * d, indexing="ij")
    return np.stack([x.reshape(-1) for x in g], axis=1)


def setup(cell):
    pts, vals = inputs.points_and_values(cell, "model")
    rng = cell.rng("coefficients")
    w = rng.standard_normal(pts.shape[0])
    degree = inputs.drift_degree(cell)
    c = None
    if degree >= 0:  # w projected onto P^T w = 0, P the drift's monomials
        p = field.drift_basis(torch.as_tensor(pts), degree, *field.scaling(pts)).numpy()
        w -= p @ np.linalg.lstsq(p, w, rcond=None)[0]
        c = rng.uniform(-1.0, 1.0, p.shape[1])
    cell.state["model"] = (pts, w, c)
    settings, params = inputs.settings(cell)
    cell.state["rbfi"] = cell.frt.RBFInterpolator.from_numpy_state(
        pts, vals, settings, w, None if c is None else c[:, None], *field.scaling(pts),
        params=params, device=cell.device)
    pool, d = cell.workload["pool"], pts.shape[1]
    cell.state["grids"] = [_grid(cell, d, k) for k in range(pool)]
    m = cell.state["grids"][0].shape[0]
    cell.state["samples"] = [np.sort(cell.rng("check", k).choice(
        m, cell.workload["check_targets"], replace=False)) for k in range(pool)]
    cell.state["calls"] = []
    cell.state["rbfi"].evaluate(_grid(cell, d, "warm"))
    cell.sync()


def step(cell, k):
    j = k % cell.workload["pool"]
    grid, sample = cell.state["grids"][j], cell.state["samples"][j]
    values = np.asarray(cell.state["rbfi"].evaluate(grid)).reshape(-1)[sample]
    cell.state["calls"].append((j, values.copy()))
    return grid.shape[0]


def release(cell):
    cell.state.pop("rbfi", None)


def check(cell):
    pts, w, c = cell.state["model"]
    kernel, degree = inputs.reference_kernel(cell), inputs.drift_degree(cell)
    want = {}
    for j in sorted({j for j, _ in cell.state["calls"]}):
        targets = cell.state["grids"][j][cell.state["samples"][j]]
        want[j] = field.dense_field(kernel, pts, w, targets, degree=degree, poly=c,
                                    device=cell.device)
    scale = max(float(np.max(np.abs(v))) for v in want.values())
    errs = [float(np.max(np.abs(got - want[j]))) / scale for j, got in cell.state["calls"]]
    limit = cell.workload["limits"]["value_err"]
    cell.state["failed_steps"] = sum(not e <= limit for e in errs)
    return {"value_err": max(errs) if all(np.isfinite(errs)) else float("inf")}
