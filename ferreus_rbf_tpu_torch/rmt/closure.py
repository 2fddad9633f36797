"""Boundary closure: cap open AABB boundary loops to watertight meshes.

Semantics follow ``ferreus_rmt/src/boundary_closure.rs``: open boundary
edges lying on the clipping box are collected per face; ``ClosePositive``
closes the mesh as if the field outside the box is above the isovalue
(enclosing the negative volume, original winding), ``CloseNegative`` as if
it is below (the input surface is reversed and the complementary region is
capped). Caps are wound outward from the AABB.

Construction differs from the reference's CDT+flood: boundary chains are
completed around each face's perimeter (inserting the passed corners),
classified into outer loops and holes by orientation in the face-outward
frame, triangulated by ear clipping with hole bridging, and faces with no
chains are capped whole when an adjacent face's cap reaches the shared box
edge (iterated to a fixed point). The result is the same watertight cap
surface for meshes produced by the clipping stage.
"""

from __future__ import annotations

import numpy as np

from ..isosurfacing import BoundaryClosure

_FACES = [
    # (axis, is_max, u_axis, v_axis) with e_u x e_v = outward normal
    (0, False, 2, 1),  # x-min, outward -x: (ez, ey)
    (0, True, 1, 2),   # x-max, outward +x: (ey, ez)
    (1, False, 0, 2),  # y-min, outward -y: (ex, ez)
    (1, True, 2, 0),   # y-max, outward +y: (ez, ex)
    (2, False, 1, 0),  # z-min, outward -z: (ey, ex)
    (2, True, 0, 1),   # z-max, outward +z: (ex, ey)
]


def _boundary_edges(facets: np.ndarray):
    """Directed edges used by exactly one triangle (in triangle order)."""
    edges = {}
    for tri in facets:
        for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
            key = (min(a, b), max(a, b))
            edges.setdefault(key, []).append((int(a), int(b)))
    return [uses[0] for uses in edges.values() if len(uses) == 1]


def _stitch_chains(directed_edges):
    """Join directed edges into maximal chains / closed loops."""
    nxt = {}
    starts = set()
    ends = set()
    for a, b in directed_edges:
        nxt.setdefault(a, []).append(b)
        starts.add(a)
        ends.add(b)

    chains = []
    # open chains start at vertices that are not any edge's target
    open_starts = [a for a in starts if a not in ends]
    used = set()

    def walk(a):
        chain = [a]
        while a in nxt and nxt[a]:
            b = nxt[a].pop()
            if (a, b) in used:
                break
            used.add((a, b))
            chain.append(b)
            a = b
        return chain

    for a in open_starts:
        while a in nxt and nxt[a]:
            chains.append(walk(a))
    # remaining edges form closed loops
    for a in list(nxt.keys()):
        while nxt.get(a):
            chain = walk(a)
            if len(chain) > 1:
                chains.append(chain)
    return chains


def _perimeter_param(uv, lo_u, hi_u, lo_v, hi_v, eps):
    """CCW arc-length parameter of a perimeter point; None if interior."""
    u, v = uv
    du = hi_u - lo_u
    dv = hi_v - lo_v
    if abs(v - lo_v) <= eps:
        return u - lo_u
    if abs(u - hi_u) <= eps:
        return du + (v - lo_v)
    if abs(v - hi_v) <= eps:
        return du + dv + (hi_u - u)
    if abs(u - lo_u) <= eps:
        return 2 * du + dv + (hi_v - v)
    return None


def _perimeter_point(s, lo_u, hi_u, lo_v, hi_v):
    du = hi_u - lo_u
    dv = hi_v - lo_v
    s = s % (2 * (du + dv))
    if s <= du:
        return (lo_u + s, lo_v)
    s -= du
    if s <= dv:
        return (hi_u, lo_v + s)
    s -= dv
    if s <= du:
        return (hi_u - s, hi_v)
    s -= du
    return (lo_u, hi_v - s)


def _signed_area(loop_uv):
    arr = np.asarray(loop_uv)
    x, y = arr[:, 0], arr[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _point_in_poly(pt, loop_uv):
    x, y = pt
    inside = False
    n = len(loop_uv)
    for i in range(n):
        x1, y1 = loop_uv[i]
        x2, y2 = loop_uv[(i + 1) % n]
        if (y1 > y) != (y2 > y):
            xin = (x2 - x1) * (y - y1) / (y2 - y1) + x1
            if x < xin:
                inside = not inside
    return inside


def _ear_clip(poly, tol=1e-12):
    """O(n^2) ear clipping of a CCW polygon that may contain the duplicate
    "spike" vertices created by hole bridging; returns index triples."""
    n = len(poly)
    if n < 3:
        return []
    scale = max(
        max(p[0] for p in poly) - min(p[0] for p in poly),
        max(p[1] for p in poly) - min(p[1] for p in poly),
        1e-30,
    )
    ctol = tol * scale * scale
    ptol = tol * scale

    def close(p, q):
        return abs(p[0] - q[0]) <= ptol and abs(p[1] - q[1]) <= ptol

    idx = list(range(n))
    tris = []
    guard = 0
    while len(idx) > 3 and guard < 10 * n * n:
        guard += 1
        found = False
        m = len(idx)
        for k in range(m):
            i0, i1, i2 = idx[(k - 1) % m], idx[k], idx[(k + 1) % m]
            a, b, c = poly[i0], poly[i1], poly[i2]
            # spike: neighbours coincide -> drop the spike tip and one twin
            if close(a, c):
                hi = max(k, (k + 1) % m)
                lo = min(k, (k + 1) % m)
                idx.pop(hi)
                idx.pop(lo)
                found = True
                break
            cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
            if abs(cross) <= ctol:
                # collinear: safe to drop the middle vertex when it lies
                # between its neighbours
                dot = (b[0] - a[0]) * (c[0] - a[0]) + (b[1] - a[1]) * (c[1] - a[1])
                seg2 = (c[0] - a[0]) ** 2 + (c[1] - a[1]) ** 2
                if 0.0 <= dot <= seg2 + ptol:
                    idx.pop(k)
                    found = True
                    break
                continue
            if cross < 0.0:
                continue  # reflex corner
            ok = True
            for j in idx:
                if j in (i0, i1, i2):
                    continue
                p = poly[j]
                if close(p, a) or close(p, b) or close(p, c):
                    continue
                d1 = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
                d2 = (c[0] - b[0]) * (p[1] - b[1]) - (c[1] - b[1]) * (p[0] - b[0])
                d3 = (a[0] - c[0]) * (p[1] - c[1]) - (a[1] - c[1]) * (p[0] - c[0])
                if d1 >= -ctol and d2 >= -ctol and d3 >= -ctol:
                    ok = False
                    break
            if ok:
                tris.append((i0, i1, i2))
                idx.pop(k)
                found = True
                break
        if not found:
            break
    if len(idx) >= 3:
        for k in range(1, len(idx) - 1):
            tris.append((idx[0], idx[k], idx[k + 1]))
    return tris


def _bridge_holes(outer, holes):
    """Merge CW holes into a CCW outer loop via rightmost-vertex bridges.

    ``outer``/``holes`` elements are ``(uv, vid)`` pairs; ``vid`` is None for
    generated perimeter points.
    """
    poly = list(outer)
    for hole in sorted(holes, key=lambda h: -max(p[0][0] for p in h)):
        # rightmost hole vertex
        hi = max(range(len(hole)), key=lambda i: hole[i][0][0])
        hp = hole[hi][0]
        # nearest outer vertex to the right (fallback: nearest overall)
        best = None
        best_d = np.inf
        for j, (p, _vid) in enumerate(poly):
            d = (p[0] - hp[0]) ** 2 + (p[1] - hp[1]) ** 2
            if p[0] >= hp[0] - 1e-15 and d < best_d:
                best_d = d
                best = j
        if best is None:
            best = min(
                range(len(poly)),
                key=lambda j: (poly[j][0][0] - hp[0]) ** 2 + (poly[j][0][1] - hp[1]) ** 2,
            )
        rotated = hole[hi:] + hole[:hi]
        poly = poly[: best + 1] + rotated + [rotated[0]] + poly[best:]
    return poly


def cap_mesh_to_aabb(vertices, facets, extents, resolution, mode, eps):
    """Cap open AABB boundary loops; returns (vertices, facets) arrays."""
    verts = np.asarray(vertices, np.float64).reshape(-1, 3)
    tris = np.asarray(facets, np.int64).reshape(-1, 3)
    if mode in (None, BoundaryClosure.None_) or tris.shape[0] == 0:
        return verts, tris

    extents = np.asarray(extents, np.float64)
    lo3, hi3 = extents[:3], extents[3:]

    if mode == BoundaryClosure.CloseNegative:
        tris = tris[:, ::-1].copy()

    b_edges = _boundary_edges(tris)
    if not b_edges:
        if mode == BoundaryClosure.CloseNegative:
            tris = tris[:, ::-1].copy()
        return verts, tris

    snap_eps = max(eps * 100.0, 1e-9)

    def on_face(vid, axis, is_max):
        coord = hi3[axis] if is_max else lo3[axis]
        return abs(verts[vid, axis] - coord) <= snap_eps

    new_vertices = list(map(tuple, verts))
    new_tris = [tuple(t) for t in tris]

    cap_regions = {}  # face index -> list of filled uv loops (bridged polys)
    face_frames = {}

    for f_idx, (axis, is_max, ua, va) in enumerate(_FACES):
        face_edges = [
            (a, b)
            for a, b in b_edges
            if on_face(a, axis, is_max) and on_face(b, axis, is_max)
        ]
        face_frames[f_idx] = (axis, is_max, ua, va)
        if not face_edges:
            continue

        # reversed edges: cap interior lies left of them in the (u, v) frame
        chains = _stitch_chains([(b, a) for a, b in face_edges])
        lo_u, hi_u = lo3[ua], hi3[ua]
        lo_v, hi_v = lo3[va], hi3[va]

        def uv_of(vid):
            return (verts[vid, ua], verts[vid, va])

        closed_loops = []  # list of uv lists + parallel vid lists (None = generated)
        open_chains = []
        for chain in chains:
            if chain[0] == chain[-1] and len(chain) > 3:
                closed_loops.append((
                    [uv_of(v) for v in chain[:-1]], list(chain[:-1])
                ))
            else:
                open_chains.append(chain)

        # complete open chains around the perimeter (CCW walk)
        if open_chains:
            params = []
            for ci, chain in enumerate(open_chains):
                s_end = _perimeter_param(uv_of(chain[-1]), lo_u, hi_u, lo_v, hi_v, snap_eps)
                s_start = _perimeter_param(uv_of(chain[0]), lo_u, hi_u, lo_v, hi_v, snap_eps)
                params.append((ci, s_start, s_end))
            usable = [p for p in params if p[1] is not None and p[2] is not None]
            remaining = {p[0] for p in usable}
            peri = 2 * ((hi_u - lo_u) + (hi_v - lo_v))
            while remaining:
                ci = next(iter(remaining))
                remaining.discard(ci)
                loop_uv = [uv_of(v) for v in open_chains[ci]]
                loop_vid = list(open_chains[ci])
                cur = ci
                guard = 0
                while guard < 24:
                    guard += 1
                    s_end = next(p[2] for p in usable if p[0] == cur)
                    # nearest chain start CCW ahead of s_end
                    best = None
                    best_ds = np.inf
                    for cj, s_start, _ in usable:
                        if cj != ci and cj not in remaining and cj != cur:
                            continue
                        ds = (s_start - s_end) % peri
                        if ds < best_ds:
                            best_ds = ds
                            best = (cj, s_start)
                    if best is None:
                        break
                    cj, s_start = best
                    # insert corners passed between s_end and s_start
                    du = hi_u - lo_u
                    dv = hi_v - lo_v
                    corner_params = [0.0, du, du + dv, 2 * du + dv]
                    for cp in sorted(corner_params, key=lambda c: (c - s_end) % peri):
                        ds = (cp - s_end) % peri
                        if 1e-12 < ds < best_ds - 1e-12:
                            loop_uv.append(_perimeter_point(cp, lo_u, hi_u, lo_v, hi_v))
                            loop_vid.append(None)
                    if cj == ci:
                        break  # loop closed back to its own start
                    remaining.discard(cj)
                    loop_uv.extend(uv_of(v) for v in open_chains[cj])
                    loop_vid.extend(open_chains[cj])
                    cur = cj
                closed_loops.append((loop_uv, loop_vid))

        if not closed_loops:
            continue

        # orientation classification: CCW (positive area) = filled region
        outers = [lp for lp in closed_loops if _signed_area(lp[0]) > 0]
        holes = [lp for lp in closed_loops if _signed_area(lp[0]) <= 0]

        unassigned_holes = []
        regions = []
        for h_uv, h_vid in holes:
            placed = False
            for o_uv, _o_vid in outers:
                if _point_in_poly(h_uv[0], o_uv):
                    placed = True
                    break
            if not placed:
                unassigned_holes.append((h_uv, h_vid))
        if unassigned_holes:
            # holes cut out of the full face rectangle
            lo_u, hi_u = lo3[ua], hi3[ua]
            lo_v, hi_v = lo3[va], hi3[va]
            rect = [
                (lo_u, lo_v), (hi_u, lo_v), (hi_u, hi_v), (lo_u, hi_v)
            ]
            outers.append((rect, [None, None, None, None]))

        for o_uv, o_vid in outers:
            my_holes = [
                (h_uv, h_vid)
                for h_uv, h_vid in holes
                if _point_in_poly(h_uv[0], o_uv)
            ]
            merged_uv = list(o_uv)
            merged_vid = list(o_vid)
            if my_holes:
                poly = _bridge_holes(
                    list(zip(o_uv, o_vid)),
                    [list(zip(h_uv, h_vid)) for h_uv, h_vid in my_holes],
                )
                merged_uv = [p[0] for p in poly]
                merged_vid = [p[1] for p in poly]

            tris_idx = _ear_clip(merged_uv)
            coord = hi3[axis] if is_max else lo3[axis]

            def mat(vid, uv):
                if vid is not None:
                    return int(vid)
                p = [0.0, 0.0, 0.0]
                p[axis] = coord
                p[ua] = uv[0]
                p[va] = uv[1]
                new_vertices.append(tuple(p))
                return len(new_vertices) - 1

            mat_ids = [mat(v, uv) for v, uv in zip(merged_vid, merged_uv)]
            for i0, i1, i2 in tris_idx:
                new_tris.append((mat_ids[i0], mat_ids[i1], mat_ids[i2]))
            regions.append(merged_uv)
        cap_regions[f_idx] = regions

    # --- full-face propagation across shared box edges ---------------------
    def region_touches_edge(f_idx, other_axis, other_is_max):
        """Does face f's cap region reach the box edge shared with the other face?"""
        regions = cap_regions.get(f_idx)
        if not regions:
            return False
        axis, is_max, ua, va = face_frames[f_idx]
        if other_axis == ua:
            coord = hi3[ua] if other_is_max else lo3[ua]
            return any(abs(p[0] - coord) <= snap_eps for reg in regions for p in reg)
        if other_axis == va:
            coord = hi3[va] if other_is_max else lo3[va]
            return any(abs(p[1] - coord) <= snap_eps for reg in regions for p in reg)
        return False

    changed = True
    while changed:
        changed = False
        for f_idx, (axis, is_max, ua, va) in enumerate(_FACES):
            if f_idx in cap_regions:
                continue
            # adjacent faces: the four faces sharing an edge with this one
            reached = False
            for g_idx, (g_axis, g_is_max, _gu, _gv) in enumerate(_FACES):
                if g_axis == axis:
                    continue
                if region_touches_edge(g_idx, axis, is_max):
                    reached = True
                    break
            if not reached:
                continue
            # cap the whole face
            lo_u, hi_u = lo3[ua], hi3[ua]
            lo_v, hi_v = lo3[va], hi3[va]
            coord = hi3[axis] if is_max else lo3[axis]
            rect_uv = [(lo_u, lo_v), (hi_u, lo_v), (hi_u, hi_v), (lo_u, hi_v)]
            base = len(new_vertices)
            for u, v in rect_uv:
                p = [0.0, 0.0, 0.0]
                p[axis] = coord
                p[ua] = u
                p[va] = v
                new_vertices.append(tuple(p))
            new_tris.append((base, base + 1, base + 2))
            new_tris.append((base, base + 2, base + 3))
            cap_regions[f_idx] = [rect_uv]
            changed = True

    # For CloseNegative the output keeps the reversed orientation: the mesh
    # bounds the positive volume and its normals (surface + caps) point out
    # of it consistently.
    out_verts = np.asarray(new_vertices, np.float64)
    out_tris = np.asarray(new_tris, np.int64)

    # Weld: generated perimeter/corner points on adjacent faces coincide but
    # are distinct ids (the reference shares cap candidates across faces; we
    # dedup instead).
    from .cleanup import clean_mesh

    return clean_mesh(out_verts, out_tris, max(eps, 1e-12))
