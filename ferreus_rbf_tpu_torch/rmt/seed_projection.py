"""Seed projection onto the target level set (maps ``seed_projection.rs``).

Seeds are clamped to the lattice AABB, deduplicated by initial lattice cell,
and driven toward ``f(x) = isovalue`` with batched Newton steps
x <- x - (f - iso)/||grad f||^2 * grad f (<=30 iterations, tol 0.01). A
central-difference fallback batches 7 samples per point through the scalar
field when no analytic gradient is available.
"""

from __future__ import annotations

import numpy as np

from .keymap import pack_ijk

NITERS = 30
TOL = 0.01
G2_MIN = 1e-20


def get_unique_seed_point_ijks(seed_points, gradient_fn, lattice, isovalue):
    pts = np.atleast_2d(np.asarray(seed_points, np.float64))
    if pts.shape[1] != 3:
        raise ValueError("seed_points must be N x 3")

    clamped = np.clip(pts, lattice.min_corner, lattice.max_corner)
    # one seed per initial cell, the first in input order: a 1-D unique of
    # the packed cell keys (a bijection of the cells) picks the same rows
    # as a row unique of the cells (a stable sort either way), at a
    # fraction of its cost over millions of seeds
    _, first = np.unique(pack_ijk(lattice.world_to_ijk(clamped)), return_index=True)
    x = clamped[np.sort(first)].copy()
    if x.shape[0] == 0:
        return set()

    active = np.arange(x.shape[0])
    for _ in range(NITERS):
        if active.size == 0:
            break
        fx, g = gradient_fn(x[active])
        fx = np.asarray(fx).reshape(-1) - isovalue
        g = np.asarray(g).reshape(-1, 3)
        done = np.abs(fx) < TOL
        g2 = np.sum(g * g, axis=1)
        ok = (~done) & (g2 >= G2_MIN)
        if not np.any(ok):
            break
        scale = np.where(g2 >= G2_MIN, fx / np.maximum(g2, G2_MIN), 0.0)
        upd = active[~done]
        # note: x[upd] is a fancy-indexed COPY — clip must be assigned back,
        # an in-place out=x[upd] silently discards the clamp
        x[upd] = np.clip(
            x[upd] - (scale[:, None] * g)[~done],
            lattice.min_corner,
            lattice.max_corner,
        )
        active = upd

    return {tuple(ijk) for ijk in lattice.world_to_ijk(x)}


def central_difference_values_and_gradients(points, isosurface_fn, lattice):
    """Batched 7-point central-difference values + gradients."""
    pts = np.atleast_2d(np.asarray(points, np.float64))
    n = pts.shape[0]
    h = max(float(np.min(np.abs(lattice.spacing))), 1e-4) * 1e-4
    samples = np.empty((n, 7, 3))
    samples[:, 0] = pts
    for axis in range(3):
        plus = pts.copy()
        plus[:, axis] += h
        minus = pts.copy()
        minus[:, axis] -= h
        samples[:, 1 + axis * 2] = plus
        samples[:, 2 + axis * 2] = minus
    vals = np.asarray(isosurface_fn(samples.reshape(-1, 3))).reshape(n, 7)
    values = vals[:, 0:1]
    gradients = np.stack(
        [(vals[:, 1 + a * 2] - vals[:, 2 + a * 2]) / (2.0 * h) for a in range(3)], axis=1
    )
    return values, gradients
