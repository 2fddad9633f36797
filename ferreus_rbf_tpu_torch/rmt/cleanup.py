"""Mesh cleanup (maps ``mesh_cleanup.rs``): vertex dedup on an eps hash
grid, degenerate/duplicate facet removal, and dropping connected components
with fewer than two facets. Vectorised numpy throughout."""

from __future__ import annotations

import numpy as np

MIN_CONNECTED_COMPONENT_FACETS = 2


def _dedup_vertices(verts: np.ndarray, eps: float):
    """old->new map + compact vertices, grouping points within eps."""
    n = verts.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), verts
    q = np.round(verts / max(eps, 1e-12)).astype(np.int64)
    # exact-cell grouping first; points within eps across cell borders are
    # caught by a second pass over the 27-cell neighbourhood of survivors
    _, first_idx, inverse = np.unique(q, axis=0, return_index=True, return_inverse=True)
    old_to_new = first_idx[inverse]

    # merge near-duplicates across cell boundaries using a KD-tree
    import scipy.spatial

    reps = np.unique(old_to_new)
    rep_pts = verts[reps]
    tree = scipy.spatial.cKDTree(rep_pts)
    pairs = tree.query_pairs(eps, output_type="ndarray")
    if pairs.size:
        # union-find over representative points
        parent = np.arange(reps.size)

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for a, b in pairs:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        canon = np.array([find(i) for i in range(reps.size)])
        rep_map = reps[canon]
        lookup = {int(r): int(rep_map[i]) for i, r in enumerate(reps)}
        old_to_new = np.array([lookup[int(v)] for v in old_to_new], np.int64)

    kept, compact = np.unique(old_to_new, return_inverse=True)
    return compact, verts[kept]


def clean_mesh(vertices, facets, eps: float):
    verts = np.asarray(vertices, np.float64).reshape(-1, 3)
    tris = np.asarray(facets, np.int64).reshape(-1, 3)
    if tris.shape[0] == 0:
        return verts[:0], tris

    old_to_new, verts = _dedup_vertices(verts, eps)
    tris = old_to_new[tris]

    # drop collapsed triangles
    ok = (tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])
    tris = tris[ok]

    # drop near-zero-area triangles
    if tris.shape[0]:
        p = verts[tris]
        cross = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        area2 = np.sum(cross * cross, axis=1)
        tris = tris[area2 > eps**4]

    # drop duplicate facets regardless of winding
    if tris.shape[0]:
        key = np.sort(tris, axis=1)
        _, keep = np.unique(key, axis=0, return_index=True)
        tris = tris[np.sort(keep)]

    # remove components smaller than the threshold (vertex connectivity)
    if tris.shape[0]:
        import scipy.sparse
        import scipy.sparse.csgraph

        nf = tris.shape[0]
        nv = verts.shape[0]
        rows = np.repeat(np.arange(nf), 3)
        cols = tris.reshape(-1)
        inc = scipy.sparse.coo_matrix(
            (np.ones(rows.size), (rows, cols)), shape=(nf, nv)
        ).tocsr()
        adj = inc @ inc.T
        ncomp, labels = scipy.sparse.csgraph.connected_components(adj, directed=False)
        counts = np.bincount(labels, minlength=ncomp)
        tris = tris[counts[labels] >= MIN_CONNECTED_COMPONENT_FACETS]

    # compact unused vertices
    used = np.unique(tris.reshape(-1)) if tris.size else np.zeros(0, np.int64)
    remap = np.full(verts.shape[0], -1, np.int64)
    remap[used] = np.arange(used.size)
    return verts[used], (remap[tris] if tris.size else tris)
