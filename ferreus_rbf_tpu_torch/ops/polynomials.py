"""Monomial / Lagrange polynomial bases for the drift term.

Host numpy port of ``ferreus_rbf_tpu/ops/polynomials.py``: monomial
evaluation to degree <= 2 in scaled [-1, 1]^d coordinates, analytic
monomial gradients, and Lagrange coefficient construction from the
special-point monomials.
"""

from __future__ import annotations

import numpy as np


def _quadratic_pairs(d: int):
    return [(i, j) for i in range(d) for j in range(i, d)]


def evaluate_monomials(points, degree: int, basis_size: int, translation_factor, scale_factor):
    """Monomial matrix (N, basis_size): [1, x_0..x_{d-1}, x_i*x_j (i<=j)]."""
    pts = (np.asarray(points, np.float64) - translation_factor) / scale_factor
    n, d = pts.shape
    cols = [np.ones(n)]
    if degree >= 1:
        cols.extend(pts[:, i] for i in range(d))
    if degree == 2:
        cols.extend(pts[:, i] * pts[:, j] for i, j in _quadratic_pairs(d))
    out = np.stack(cols, axis=1)
    assert out.shape[1] == basis_size, (out.shape, basis_size)
    return out


def evaluate_monomial_gradients(points, poly_coefficients, degree: int, translation_factor,
                                scale_factor):
    """Gradient of the polynomial drift at each point: (N, nrhs*d), laid
    out [rhs0_dx, rhs0_dy, ..., rhs1_dx, ...]. Derivatives are taken in the
    scaled coordinates and divided by ``scale_factor`` (the chain rule of
    (x - t)/s)."""
    pts = (np.asarray(points, np.float64) - translation_factor) / scale_factor
    n, d = pts.shape
    coef = np.asarray(poly_coefficients, np.float64)
    nrhs = coef.shape[1]
    scale = np.asarray(scale_factor, np.float64)
    grads = np.zeros((n, nrhs * d))
    if degree >= 1:
        for rhs in range(nrhs):
            for dim in range(d):
                grads[:, rhs * d + dim] = coef[1 + dim, rhs] / scale[dim]
    if degree == 2:
        start = 1 + d
        for k, (i, j) in enumerate(_quadratic_pairs(d)):
            for rhs in range(nrhs):
                c = coef[start + k, rhs]
                if i == j:
                    grads[:, rhs * d + i] += c * 2.0 * pts[:, i] / scale[i]
                else:
                    grads[:, rhs * d + i] += c * pts[:, j] / scale[i]
                    grads[:, rhs * d + j] += c * pts[:, i] / scale[j]
    return grads


def get_lagrange_coefficients(monomials) -> np.ndarray:
    """Solve M @ L = I for the Lagrange basis coefficients (host)."""
    m = np.asarray(monomials, np.float64)
    return np.linalg.solve(m, np.eye(m.shape[0]))


def evaluate_lagrange_polynomials(monomials, lagrange_coefficients) -> np.ndarray:
    return np.asarray(monomials) @ np.asarray(lagrange_coefficients)
