"""Dense RBF sums and solves in plain torch, written from the published
kernel definitions (upstream ferreus_rbf's kernel registry and drift
bases): the field sum_j w_j phi(|x - x_j|) + drift, a fit's residual, and
a dense solve of the interpolation system with its drift.

``kernel`` is a dict: ``{"type": "Linear"}`` (phi(r) = -r),
``{"type": "ThinPlateSpline"}`` (r^2 ln r, 0 at r = 0),
``{"type": "Cubic"}`` (r^3), or ``{"type": "Spheroidal", "order": 3, 5, 7
or 9, "base_range": a, "total_sill": s}``. A drift of ``degree`` -1 (none),
0 (constant), 1 (linear) or 2 (quadratic) takes the monomials
[1, x_i, x_i x_j (i <= j)] of (x - t) / s, t the centre and s the half
width of the sources' box per dimension (1 for a flat side), as the
library's model format states them. Points have 1, 2 or 3 columns.
"""

from __future__ import annotations

import numpy as np
import torch

# (inflexion point, linear slope, range scaling, inverse y-intercept) of the
# spheroidal kernels, as upstream ferreus_rbf publishes them
SPHEROIDAL = {3: (0.5000000000, 0.7500000000, 2.6798340586, 0.8734640537),
              5: (0.4082482905, 1.0206207262, 1.5822795750, 0.8575980168),
              7: (0.3535533906, 1.2374368671, 1.2008676644, 0.8494862533),
              9: (0.3162277660, 1.4230249471, 1.0000000000, 0.8445585690)}

# elements of one (rows, sources) distance block
BLOCK_ELEMENTS = 2**27


def phi(kernel: dict, r: torch.Tensor) -> torch.Tensor:
    """phi(r) elementwise, in r's dtype."""
    kind = kernel["type"]
    if kind == "Linear":
        return -r
    if kind == "ThinPlateSpline":
        live = r > 0
        return torch.where(live, r * r * torch.log(torch.where(live, r, torch.ones_like(r))),
                           torch.zeros_like(r))
    if kind == "Cubic":
        return r * r * r
    if kind == "Spheroidal":
        ip, slope, scaling, inv_y = SPHEROIDAL[kernel["order"]]
        sill = kernel["total_sill"]
        sr = r * (scaling / kernel["base_range"])
        near = sill - sill * slope * sr
        far = (sill * inv_y) * (1.0 + sr * sr) ** (-kernel["order"] / 2.0)
        return torch.where(sr <= ip, near, far)
    raise ValueError(f"the reference has no kernel {kind!r}")


def scaling(points) -> tuple:
    """(centre, half width) of the points' box per dimension, float64 host
    arrays; a flat side gets the half width 1."""
    pts = np.asarray(points, np.float64)
    lo, hi = pts.min(0), pts.max(0)
    half = (hi - lo) / 2.0
    half[half == 0.0] = 1.0
    return (hi + lo) / 2.0, half


def basis_size(degree: int, d: int) -> int:
    return [0, 1, 1 + d, 1 + d + d * (d + 1) // 2][degree + 1]


def drift_basis(points: torch.Tensor, degree: int, centre, half) -> torch.Tensor:
    """Monomials of the drift at ``points``, (n, basis_size)."""
    x = (points - torch.as_tensor(centre, dtype=points.dtype, device=points.device)) \
        / torch.as_tensor(half, dtype=points.dtype, device=points.device)
    d = x.shape[1]
    cols = [torch.ones_like(x[:, 0])] if degree >= 0 else []
    if degree >= 1:
        cols += [x[:, i] for i in range(d)]
    if degree >= 2:
        cols += [x[:, i] * x[:, j] for i in range(d) for j in range(i, d)]
    if degree > 2:
        raise ValueError(f"the reference has no drift of degree {degree}")
    return torch.stack(cols, 1) if cols else x.new_zeros((x.shape[0], 0))


def dense_field(kernel, sources, weights, targets, *, degree=-1, poly=None, dtype=torch.float64,
                device="cpu"):
    """sum_j w_j phi(|t - s_j|) + drift at every target, summed in ``dtype``
    on ``device`` in blocks of target rows; a float64 host array (m,)."""
    src = torch.as_tensor(np.asarray(sources, np.float64), dtype=dtype, device=device)
    w = torch.as_tensor(weights, dtype=dtype, device=device).reshape(-1, 1)
    tgt = torch.as_tensor(np.asarray(targets, np.float64), dtype=dtype, device=device)
    rows = max(1, BLOCK_ELEMENTS // max(1, src.shape[0]))
    out = []
    for i in range(0, tgt.shape[0], rows):
        r = torch.cdist(tgt[i:i + rows], src, compute_mode="donot_use_mm_for_euclid_dist")
        out.append((phi(kernel, r) @ w)[:, 0])
    vals = torch.cat(out) if out else tgt.new_zeros(0)
    if degree >= 0:
        c = torch.as_tensor(poly, dtype=dtype, device=device).reshape(-1, 1)
        vals = vals + (drift_basis(tgt, degree, *scaling(sources)) @ c)[:, 0]
    return vals.double().cpu().numpy()


def residual_l2(kernel, sources, weights, poly, degree, rows, values, *, device="cpu"):
    """||f(x_i) - v_i|| / ||v_i|| over the points ``rows`` with values
    ``values``, f summed in float64 by :func:`dense_field`."""
    f = dense_field(kernel, sources, weights, rows, degree=degree, poly=poly, device=device)
    values = np.asarray(values, np.float64)
    return float(np.linalg.norm(f - values) / max(np.linalg.norm(values), 1e-300))


def dense_solve(kernel, points, values, degree=-1, *, dtype=torch.float64, device="cpu"):
    """(w, c) with A w + P c = v and P^T w = 0, A the kernel matrix and P
    the drift's monomials, solved densely in ``dtype`` (LU with partial
    pivoting): float64 host arrays (n,) and (basis,)."""
    pts = torch.as_tensor(np.asarray(points, np.float64), dtype=dtype, device=device)
    n = pts.shape[0]
    p = drift_basis(pts, degree, *scaling(points))
    m = p.shape[1]
    a = pts.new_zeros((n + m, n + m))
    a[:n, :n] = phi(kernel, torch.cdist(pts, pts, compute_mode="donot_use_mm_for_euclid_dist"))
    a[:n, n:], a[n:, :n] = p, p.T
    rhs = pts.new_zeros((n + m, 1))
    rhs[:n, 0] = torch.as_tensor(values, dtype=dtype, device=device)
    sol = torch.linalg.solve(a, rhs)[:, 0].double().cpu().numpy()
    return sol[:n], sol[n:]
