"""Mesh self-intersection detection (maps ``mesh_intersections.rs`` +
``moller.rs``).

Broad phase: a cKDTree over triangle AABB centres (radius = max AABB
half-diagonal) narrows candidate pairs; narrow phase: Moller's 1997
triangle-triangle interval test, with the reference's adjacency filters —
pairs sharing >= 2 vertex ids (or geometric vertices), contact-only
near-coplanar pairs, and degenerate triangles are not intersections; pairs
sharing exactly one vertex only count when an opposite edge pierces the
other triangle's interior.
"""

from __future__ import annotations

import numpy as np

DEFAULT_INTERSECTION_TOLERANCE = 1e-8


def _cross3(u, v):
    """Cross product over a trailing axis of 3 — avoids ``np.cross``'s
    per-call moveaxis overhead, which dominates scalar-loop profiles."""
    return np.stack(
        (
            u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
            u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
            u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
        ),
        axis=-1,
    )


def _unit(v):
    n = float(v @ v) ** 0.5
    return None if n <= 0.0 else v / n


def _tri_normal(tri):
    return _cross3(tri[1] - tri[0], tri[2] - tri[0])


def _is_degenerate(tri, tol):
    n = _tri_normal(tri)
    return float(n @ n) ** 0.5 <= tol * tol


def _plane_distances(tri, pts):
    n = _unit(_tri_normal(tri))
    if n is None:
        return None
    return (pts - tri[0]) @ n


def _point_in_interior(tri, point, tol):
    n_hat = _unit(_tri_normal(tri))
    if n_hat is None:
        return False
    if abs((point - tri[0]) @ n_hat) > tol:
        return False
    c0 = _cross3(tri[1] - tri[0], point - tri[0]) @ n_hat
    c1 = _cross3(tri[2] - tri[1], point - tri[1]) @ n_hat
    c2 = _cross3(tri[0] - tri[2], point - tri[2]) @ n_hat
    at = tol * tol
    return (c0 > at and c1 > at and c2 > at) or (c0 < -at and c1 < -at and c2 < -at)


def _segment_pierces_interior(tri, p0, p1, tol):
    n_hat = _unit(_tri_normal(tri))
    if n_hat is None:
        return False
    d0 = (p0 - tri[0]) @ n_hat
    d1 = (p1 - tri[0]) @ n_hat
    if abs(d0) <= tol or abs(d1) <= tol or d0 * d1 >= 0.0:
        return False
    t = d0 / (d0 - d1)
    if t <= tol or t >= 1.0 - tol:
        return False
    return _point_in_interior(tri, p0 + t * (p1 - p0), tol)


def tri_tri_intersect(t1, t2) -> bool:
    """Moller's interval-overlap triangle-triangle intersection test."""
    eps = 1e-12
    n1 = _tri_normal(t1)
    d1 = -n1 @ t1[0]
    dv2 = t2 @ n1 + d1
    dv2 = np.where(np.abs(dv2) < eps, 0.0, dv2)
    if np.all(dv2 > 0) or np.all(dv2 < 0):
        return False

    n2 = _tri_normal(t2)
    d2 = -n2 @ t2[0]
    dv1 = t1 @ n2 + d2
    dv1 = np.where(np.abs(dv1) < eps, 0.0, dv1)
    if np.all(dv1 > 0) or np.all(dv1 < 0):
        return False

    direction = _cross3(n1, n2)
    if float(direction @ direction) ** 0.5 < eps:
        # coplanar: project onto the dominant axis plane and run 2D tests
        return _coplanar_tri_tri(t1, t2, n1)

    axis = int(np.argmax(np.abs(direction)))
    p1 = t1[:, axis]
    p2 = t2[:, axis]

    i1 = _interval(p1, dv1)
    i2 = _interval(p2, dv2)
    if i1 is None or i2 is None:
        return False
    return max(i1[0], i2[0]) <= min(i1[1], i2[1])


def _interval(proj, dv):
    """Intersection interval of a triangle with the cross line."""
    pos = dv > 0
    neg = dv < 0
    zero = dv == 0
    if zero.all():
        return None
    # pick the vertex alone on one side
    if pos.sum() == 1 and not zero.any():
        solo = int(np.argmax(pos))
    elif neg.sum() == 1 and not zero.any():
        solo = int(np.argmax(neg))
    else:
        # handle zeros: vertices on the plane
        if zero.sum() == 1:
            solo = int(np.argmax(zero))
            others = [i for i in range(3) if i != solo]
            t = proj[solo]
            lo = hi = t
            for o in others:
                if dv[o] == 0 or (dv[others[0]] > 0) != (dv[others[1]] > 0):
                    pass
            if (dv[others[0]] > 0) != (dv[others[1]] > 0):
                o0, o1 = others
                t2 = proj[o0] + (proj[o1] - proj[o0]) * dv[o0] / (dv[o0] - dv[o1])
                lo, hi = min(t, t2), max(t, t2)
            return lo, hi
        if zero.sum() == 2:
            idx = np.nonzero(zero)[0]
            return min(proj[idx]), max(proj[idx])
        solo = int(np.argmax(pos)) if pos.sum() == 1 else int(np.argmax(neg))
    others = [i for i in range(3) if i != solo]
    ts = []
    for o in others:
        denom = dv[solo] - dv[o]
        ts.append(proj[solo] + (proj[o] - proj[solo]) * dv[solo] / denom)
    return min(ts), max(ts)


def _coplanar_tri_tri(t1, t2, n):
    axis = int(np.argmax(np.abs(n)))
    keep = [i for i in range(3) if i != axis]
    a = t1[:, keep]
    b = t2[:, keep]

    def seg_seg(p0, p1, q0, q1):
        d1 = p1 - p0
        d2 = q1 - q0
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-18:
            return False
        dq = q0 - p0
        s = (dq[0] * d2[1] - dq[1] * d2[0]) / denom
        t = (dq[0] * d1[1] - dq[1] * d1[0]) / denom
        return 0.0 <= s <= 1.0 and 0.0 <= t <= 1.0

    for i in range(3):
        for j in range(3):
            if seg_seg(a[i], a[(i + 1) % 3], b[j], b[(j + 1) % 3]):
                return True

    def point_in_tri2(p, tri):
        s1 = np.cross(tri[1] - tri[0], p - tri[0])
        s2 = np.cross(tri[2] - tri[1], p - tri[1])
        s3 = np.cross(tri[0] - tri[2], p - tri[2])
        return (s1 >= 0 and s2 >= 0 and s3 >= 0) or (s1 <= 0 and s2 <= 0 and s3 <= 0)

    return point_in_tri2(a[0], b) or point_in_tri2(b[0], a)


def _shared_vertex_extra_crossing(ta, tb, tol):
    for i in range(3):
        for j in range(3):
            dv = ta[i] - tb[j]
            if float(dv @ dv) ** 0.5 <= tol:
                a0, a1 = ta[(i + 1) % 3], ta[(i + 2) % 3]
                b0, b1 = tb[(j + 1) % 3], tb[(j + 2) % 3]
                return _segment_pierces_interior(tb, a0, a1, tol) or _segment_pierces_interior(
                    ta, b0, b1, tol
                )
    return False


def _near_coplanar(ta, tb, tol):
    da = _plane_distances(ta, tb)
    db = _plane_distances(tb, ta)
    ma = np.max(np.abs(da)) if da is not None else np.inf
    mb = np.max(np.abs(db)) if db is not None else np.inf
    return min(ma, mb) <= tol


def _is_true_self_intersection(a_ids, b_ids, ta, tb, tol):
    if _is_degenerate(ta, tol) or _is_degenerate(tb, tol):
        return False
    shared = len(set(a_ids) & set(b_ids))
    if shared >= 2:
        return False
    if not tri_tri_intersect(ta, tb):
        return False
    if shared == 1:
        return _shared_vertex_extra_crossing(ta, tb, tol)
    dmat = ta[:, None, :] - tb[None, :, :]
    geo_shared = int((np.einsum("ijk,ijk->ij", dmat, dmat) <= tol * tol).any(axis=1).sum())
    if geo_shared >= 2:
        return False
    if geo_shared == 1:
        return _shared_vertex_extra_crossing(ta, tb, tol)
    return not _near_coplanar(ta, tb, tol)


def get_intersecting_triangles(vertices, facets) -> np.ndarray:
    """Sorted indices of facets involved in true self-intersections."""
    verts = np.asarray(vertices, np.float64).reshape(-1, 3)
    tris = np.asarray(facets, np.int64).reshape(-1, 3)
    nf = tris.shape[0]
    if nf == 0:
        return np.zeros(0, np.int64)

    pts = verts[tris]  # (nf, 3, 3)
    lo = pts.min(axis=1)
    hi = pts.max(axis=1)
    centres = (lo + hi) / 2.0
    half = (hi - lo) / 2.0
    rad = np.linalg.norm(half, axis=1)
    rmax = float(rad.max()) if nf else 0.0

    import scipy.spatial

    tree = scipy.spatial.cKDTree(centres)
    pairs = tree.query_pairs(2.0 * rmax + 1e-12, output_type="ndarray")

    tol = DEFAULT_INTERSECTION_TOLERANCE
    out = set()
    if pairs.shape[0] == 0:
        return np.zeros(0, np.int64)

    # Vectorised reject pass over all candidate pairs — the same conjunctive
    # rejections as the scalar narrow phase, batched. AABB overlap,
    # non-degeneracy and the shared-vertex-id count first:
    a_i, b_i = pairs[:, 0], pairs[:, 1]
    keep = ~(np.any(lo[a_i] > hi[b_i], axis=1) | np.any(lo[b_i] > hi[a_i], axis=1))
    a_i, b_i = a_i[keep], b_i[keep]
    pa, pb = pts[a_i], pts[b_i]
    n_a = _cross3(pa[:, 1] - pa[:, 0], pa[:, 2] - pa[:, 0])
    n_b = _cross3(pb[:, 1] - pb[:, 0], pb[:, 2] - pb[:, 0])
    t2 = tol * tol
    nondegen = (np.einsum("ij,ij->i", n_a, n_a) > t2 * t2) & (
        np.einsum("ij,ij->i", n_b, n_b) > t2 * t2
    )
    id_match = tris[a_i][:, :, None] == tris[b_i][:, None, :]  # (m, 3, 3)
    shared = id_match.any(axis=2).sum(axis=1)

    # Pairs sharing exactly one vertex dominate in a manifold mesh (the
    # vertex star). Their verdict is tri_tri && extra_crossing, and
    # extra_crossing is almost always false — so evaluate it batched first
    # and run the scalar Moller test only on its rare survivors.
    sel1 = nondegen & (shared == 1)
    if np.any(sel1):
        ia, jb = _first_coincident(pa[sel1], pb[sel1], tol, id_match[sel1])
        m = int(ia.size)
        rows = np.arange(m)
        pa1, pb1 = pa[sel1], pb[sel1]
        a0 = pa1[rows, (ia + 1) % 3]
        a1 = pa1[rows, (ia + 2) % 3]
        b0 = pb1[rows, (jb + 1) % 3]
        b1 = pb1[rows, (jb + 2) % 3]
        extra = _batch_segment_pierces(pb1, a0, a1, tol) | _batch_segment_pierces(
            pa1, b0, b1, tol
        )
        for a, b in zip(a_i[sel1][extra], b_i[sel1][extra]):
            if tri_tri_intersect(pts[a], pts[b]):
                out.add(int(a))
                out.add(int(b))

    # Everything else (no shared ids): batch Moller's two plane-side
    # rejections first — they kill almost every candidate — then run the
    # scalar narrow phase only on the survivors.
    sel0 = nondegen & (shared == 0)
    if np.any(sel0):
        pa0, pb0 = pa[sel0], pb[sel0]
        na0, nb0 = n_a[sel0], n_b[sel0]
        eps = 1e-12
        dv2 = np.einsum("mjk,mk->mj", pb0 - pa0[:, 0:1, :], na0)
        dv2 = np.where(np.abs(dv2) < eps, 0.0, dv2)
        dv1 = np.einsum("mjk,mk->mj", pa0 - pb0[:, 0:1, :], nb0)
        dv1 = np.where(np.abs(dv1) < eps, 0.0, dv1)
        alive = ~(
            np.all(dv2 > 0, axis=1) | np.all(dv2 < 0, axis=1)
            | np.all(dv1 > 0, axis=1) | np.all(dv1 < 0, axis=1)
        )
        for a, b in zip(a_i[sel0][alive], b_i[sel0][alive]):
            if _is_true_self_intersection(tris[a], tris[b], pts[a], pts[b], tol):
                out.add(int(a))
                out.add(int(b))
    return np.asarray(sorted(out), np.int64)


def _first_coincident(pa, pb, tol, id_match):
    """Per pair, the first (i, j) in row-major scan order with coincident
    vertices — geometric coincidence like the scalar loop, falling back to
    the shared-id position (always present for shared == 1 pairs)."""
    d = pa[:, :, None, :] - pb[:, None, :, :]
    geo = (np.einsum("mijk,mijk->mij", d, d) <= tol * tol) | id_match
    flat = geo.reshape(geo.shape[0], 9)
    idx = np.argmax(flat, axis=1)
    return idx // 3, idx % 3


def _batch_segment_pierces(tri, p0, p1, tol):
    """Vectorised ``_segment_pierces_interior`` over (m, 3, 3) triangles."""
    n = _cross3(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = np.sqrt(np.einsum("ij,ij->i", n, n))
    ok = nn > 0.0
    n_hat = n / np.where(nn == 0.0, 1.0, nn)[:, None]
    d0 = np.einsum("ij,ij->i", p0 - tri[:, 0], n_hat)
    d1 = np.einsum("ij,ij->i", p1 - tri[:, 0], n_hat)
    ok &= (np.abs(d0) > tol) & (np.abs(d1) > tol) & (d0 * d1 < 0.0)
    denom = np.where(d0 == d1, 1.0, d0 - d1)
    t = d0 / denom
    ok &= (t > tol) & (t < 1.0 - tol)
    pt = p0 + t[:, None] * (p1 - p0)
    ok &= np.abs(np.einsum("ij,ij->i", pt - tri[:, 0], n_hat)) <= tol
    at = tol * tol
    c0 = np.einsum("ij,ij->i", _cross3(tri[:, 1] - tri[:, 0], pt - tri[:, 0]), n_hat)
    c1 = np.einsum("ij,ij->i", _cross3(tri[:, 2] - tri[:, 1], pt - tri[:, 1]), n_hat)
    c2 = np.einsum("ij,ij->i", _cross3(tri[:, 0] - tri[:, 2], pt - tri[:, 2]), n_hat)
    inside = ((c0 > at) & (c1 > at) & (c2 > at)) | ((c0 < -at) & (c1 < -at) & (c2 < -at))
    return ok & inside
