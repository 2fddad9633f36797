"""The plain reference (``benchmark/reference/field.py``) against tiny dense
fits of the port (under 4,096 points the port solves directly) on the CPU:
every kernel type and spheroidal order, drifts of degree -1 to 2, and 1-3
dimensions. The port's coefficients interpolate the data under the
reference's field, and the reference's own dense solve gives the same
field off the data."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ferreus_rbf_tpu_torch as frt
from benchmark.reference import field

DEGREE = {"None": -1, "Constant": 0, "Linear": 1, "Quadratic": 2}
CASES = [("Linear", None, "Constant"), ("Linear", None, "Linear"), ("Linear", None, "Quadratic"),
         ("ThinPlateSpline", None, "Linear"), ("Cubic", None, "Linear"),
         ("Cubic", None, "Quadratic"), ("Spheroidal", 3, "None"), ("Spheroidal", 5, "None"),
         ("Spheroidal", 7, "Constant"), ("Spheroidal", 9, "Linear")]


def _kernel(kind, order):
    if kind == "Spheroidal":
        return {"type": kind, "order": order, "base_range": 0.6, "total_sill": 0.5}
    return {"type": kind}


def _settings(kind, order, drift):
    kw = {"kernel_type": frt.RBFKernelType[kind], "drift": frt.Drift(drift)}
    if kind == "Spheroidal":
        kw.update(spheroidal_order=frt.SpheroidalOrder(order), base_range=0.6, total_sill=0.5)
    return frt.InterpolantSettings(**kw)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kind,order,drift", CASES)
def test_reference_matches_a_dense_fit_of_the_port(kind, order, drift, d):
    rng = np.random.default_rng(100 * d + len(kind) + (order or 0))
    pts = rng.uniform(-1.0, 1.0, (80, d)) * np.array([1.0, 0.5, 2.0])[:d] + 3.0
    vals = np.sin(2.0 * pts).sum(1) + 0.1 * pts[:, 0] ** 2
    model = frt.RBFInterpolator(pts, vals, _settings(kind, order, drift), device="cpu")
    w, c = model.coefficients.point_coefficients[:, 0], model.coefficients.poly_coefficients
    degree, kernel = DEGREE[drift], _kernel(kind, order)
    c = None if c is None else c[:, 0]
    assert field.residual_l2(kernel, model.points, w, c, degree, pts, vals) < 1e-9
    rw, rc = field.dense_solve(kernel, pts, vals, degree)
    assert rc.shape == (field.basis_size(degree, d),)
    targets = rng.uniform(-1.0, 1.0, (50, d)) + 3.0
    want = field.dense_field(kernel, pts, rw, targets, degree=degree, poly=rc)
    got = field.dense_field(kernel, model.points, w, targets, degree=degree, poly=c)
    assert np.max(np.abs(got - want)) <= 1e-8 * np.max(np.abs(want))
    # the drift's constraint holds for the reference's own coefficients
    p = field.drift_basis(torch.as_tensor(pts), degree, *field.scaling(pts)).numpy()
    assert np.max(np.abs(p.T @ rw), initial=0.0) <= 1e-9 * np.abs(rw).sum()
