"""AABB clipping of triangle meshes (maps ``aabb_clipping.rs``).

Each triangle is clipped against the six box planes with Sutherland-Hodgman,
fan re-triangulated, and new vertices are snapped onto nearby box boundaries
(scale-aware eps = 1e-10 * AABB diagonal).
"""

from __future__ import annotations

import numpy as np


def bbox_eps(extents) -> float:
    extents = np.asarray(extents, np.float64)
    diag = np.linalg.norm(extents[3:] - extents[:3])
    return 1e-10 * max(diag, 1.0)


def _snap_near_bbox(p, lo, hi, eps):
    p = list(p)
    for a in range(3):
        if abs(p[a] - lo[a]) <= eps:
            p[a] = lo[a]
        if abs(p[a] - hi[a]) <= eps:
            p[a] = hi[a]
    return tuple(p)


def _clip_polygon(poly, axis, coord, keep_ge, lo, hi, eps):
    if not poly:
        return []
    out = []
    prev = poly[-1]

    def inside(p):
        return (p[axis] >= coord - eps) if keep_ge else (p[axis] <= coord + eps)

    prev_in = inside(prev)
    for curr in poly:
        curr_in = inside(curr)
        if curr_in != prev_in:
            da = prev[axis] - coord
            db = curr[axis] - coord
            if abs(da) <= eps:
                t = 0.0
            elif abs(db) <= eps:
                t = 1.0
            elif (da < 0.0) == (db < 0.0):
                t = None
            else:
                t = (coord - prev[axis]) / (curr[axis] - prev[axis])
            if t is not None:
                pt = tuple(prev[a] + t * (curr[a] - prev[a]) for a in range(3))
                pt = list(pt)
                pt[axis] = coord
                out.append(_snap_near_bbox(tuple(pt), lo, hi, eps))
        if curr_in:
            out.append(_snap_near_bbox(curr, lo, hi, eps))
        prev = curr
        prev_in = curr_in
    return out


def clip_mesh_to_aabb(vertices, facets, extents, eps):
    """vertices (N,3) array-like, facets (M,3) int -> clipped (verts, facets)."""
    verts = np.asarray(vertices, np.float64).reshape(-1, 3)
    tris = np.asarray(facets, np.int64).reshape(-1, 3)
    extents = np.asarray(extents, np.float64)
    lo, hi = extents[:3], extents[3:]

    planes = [
        (0, lo[0], True), (0, hi[0], False),
        (1, lo[1], True), (1, hi[1], False),
        (2, lo[2], True), (2, hi[2], False),
    ]

    # Fast path: triangles strictly inside the box (beyond the snap eps of
    # every plane) are emitted unchanged — only boundary-crossing triangles
    # go through the Python Sutherland-Hodgman loop. For interior-dominated
    # meshes this removes ~all of the per-triangle Python cost.
    pts = verts[tris]  # (M, 3, 3)
    strict = np.all((pts > lo + eps) & (pts < hi - eps), axis=(1, 2))

    slow_polys = {}
    for ti in np.nonzero(~strict)[0]:
        poly = [tuple(verts[v]) for v in tris[ti]]
        for axis, coord, keep_ge in planes:
            poly = _clip_polygon(poly, axis, coord, keep_ge, lo, hi, eps)
            if len(poly) < 3:
                break
        slow_polys[int(ti)] = poly if len(poly) >= 3 else []

    nv_per = np.where(strict, 3, 0)
    for ti, poly in slow_polys.items():
        nv_per[ti] = len(poly)
    v_off = np.concatenate([[0], np.cumsum(nv_per)])
    total_v = int(v_off[-1])

    verts_out = np.zeros((total_v, 3))
    strict_idx = np.nonzero(strict)[0]
    scatter = (v_off[strict_idx][:, None] + np.arange(3)[None]).reshape(-1)
    verts_out[scatter] = pts[strict_idx].reshape(-1, 3)

    facet_parts = [np.stack([v_off[strict_idx], v_off[strict_idx] + 1,
                             v_off[strict_idx] + 2], axis=1)]
    slow_facets = []
    for ti, poly in slow_polys.items():
        if not poly:
            continue
        base = int(v_off[ti])
        verts_out[base : base + len(poly)] = np.asarray(poly)
        for i in range(1, len(poly) - 1):
            slow_facets.append([base, base + i, base + i + 1])
    if slow_facets:
        facet_parts.append(np.asarray(slow_facets, np.int64))
    facets_out = np.concatenate(facet_parts).astype(np.int64)
    # restore original triangle emission order
    facets_out = facets_out[np.argsort(facets_out[:, 0], kind="stable")]
    return verts_out, facets_out.reshape(-1, 3)


def facets_fully_inside_aabb(vertices, facets, extents, eps):
    """Boolean mask of facets whose vertices all lie inside the AABB."""
    verts = np.asarray(vertices, np.float64).reshape(-1, 3)
    tris = np.asarray(facets, np.int64).reshape(-1, 3)
    extents = np.asarray(extents, np.float64)
    lo, hi = extents[:3] - eps, extents[3:] + eps
    pts = verts[tris]  # (M, 3, 3)
    return np.all((pts >= lo) & (pts <= hi), axis=(1, 2))
