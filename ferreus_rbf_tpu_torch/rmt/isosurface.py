"""Surface-following regularised marching tetrahedra extraction.

Maps ``ferreus_rmt/src/isosurface.rs``: seed projection -> batched
wavefront expansion (one field evaluation per front generation) -> per
-sample topology tests + clustering into vertex candidates -> predicted
-edge-count prefilter -> marching tetrahedra -> up to four rounds of
non-manifold rollback -> self-intersection rollback -> AABB clip -> mesh
cleanup -> boundary closure.

The reference's driver is compiled Rust over hashmaps
(``isosurface.rs:489-1047``); this driver is *vectorised numpy over packed
int64 lattice keys* (sort/unique/searchsorted — the ``keymap`` module):
every wavefront generation, the topology pass (grouped by unique 14-bit
mask), the curvature weighting (grouped by edge label) and each marching
sweep are batched array ops, so the host driver keeps pace with the
device-side field evaluations instead of dominating them.
"""

from __future__ import annotations

import numpy as np

from ..isosurfacing import BoundaryClosure, ClusterMethod, Mesh
from ..progress import IsosurfaceStage, Message, SurfacingProgress
from ..utils.timing import traced_stage
from . import seed_projection
from .cleanup import clean_mesh
from .clipping import bbox_eps, clip_mesh_to_aabb, facets_fully_inside_aabb
from .closure import cap_mesh_to_aabb
from .constants import (
    ALL14_MASK,
    EDGE_DELTAS,
    FACE_DIRS,
    FACES,
    FLAT_HOLE_MASKS,
    MT_TABLE,
    OWNED_TET_EDGES,
    REVERSE_EDGE,
    TET_EDGE_PAIRS,
    delta_to_edge,
)
from .curvature import curvature_weights_batch
from .intersections import get_intersecting_triangles
from .isosurface_util import is_inside
from .keymap import KeyedValues, edge_key, in_sorted, merge_sorted, pack_ijk, unpack_ijk
from .lattice import SampleLattice
from .topology import connected_components_masks

_INSIDE_EPS = 1e-9
_EPS_DIV = 1e-30

# Corner set of a sample's owned parallelepiped: itself + its 7 owned-edge
# endpoints (indices match ``edge_points_8``).
_CORNER_OFFSETS = np.concatenate([np.zeros((1, 3), np.int64), EDGE_DELTAS[:7]])

# Per (tet, corner) ijk deltas: corner 0 is the sample itself.
_TET_CORNER_DELTAS = np.stack(
    [
        np.concatenate([np.zeros((1, 3), np.int64), EDGE_DELTAS[tet]])
        for tet in OWNED_TET_EDGES
    ]
)  # (6, 4, 3)

# Per (tet, tet-edge): which corner owns the lattice edge and its label.
_TET_EDGE_OWNER_CORNER = np.zeros((6, 6), np.int64)
_TET_EDGE_LABEL = np.zeros((6, 6), np.int64)
for _t in range(6):
    for _te in range(6):
        _a, _b = TET_EDGE_PAIRS[_te]
        _delta = tuple(
            int(x) for x in (_TET_CORNER_DELTAS[_t, _b] - _TET_CORNER_DELTAS[_t, _a])
        )
        _eid = delta_to_edge(_delta)
        assert _eid is not None
        if _eid < 7:
            _TET_EDGE_OWNER_CORNER[_t, _te] = _a
            _TET_EDGE_LABEL[_t, _te] = _eid
        else:
            _TET_EDGE_OWNER_CORNER[_t, _te] = _b
            _TET_EDGE_LABEL[_t, _te] = int(REVERSE_EDGE[_eid])

# MT table padded to (16, 2, 3) with -1.
_TRI_TABLE = np.full((16, 2, 3), -1, np.int64)
for _c, _tris in enumerate(MT_TABLE):
    for _i, _tri in enumerate(_tris):
        _TRI_TABLE[_c, _i] = _tri
_TRI_VALID = (_TRI_TABLE >= 0).all(axis=2)  # (16, 2)


def _emit(progress, isovalue, stage: IsosurfaceStage, fraction: float):
    if progress is not None:
        progress.emit(
            SurfacingProgress(isovalue=isovalue, stage=str(stage), progress=fraction)
        )


def _emit_msg(progress, message: str):
    if progress is not None:
        progress.emit(Message(message=message))


def _march_tets_vec(sample_ijk: np.ndarray, evalmap: KeyedValues, edge_vids: KeyedValues):
    """Vectorised marching of the six owned tetrahedra of every sample.

    Returns an (ntri, 3) int64 array of vertex ids, in (sample, tet,
    table-row) order — the same emission order as a per-sample loop.
    """
    s = sample_ijk.shape[0]
    if s == 0:
        return np.zeros((0, 3), np.int64)

    tris_out = np.full((s, 6, 2, 3), -1, np.int64)
    keep = np.zeros((s, 6, 2), bool)

    for t in range(6):
        corners = sample_ijk[:, None, :] + _TET_CORNER_DELTAS[t][None]  # (S, 4, 3)
        ckeys = pack_ijk(corners)  # (S, 4)
        vals, found = evalmap.lookup(ckeys)
        ok = (found & np.isfinite(vals)).all(axis=1)  # (S,)
        inside = (vals < -_INSIDE_EPS).astype(np.int64)
        case = (inside << np.arange(4)[None, :]).sum(axis=1)  # (S,)

        # resolve all six tet edges to vertex ids
        owner_keys = np.take_along_axis(
            ckeys, _TET_EDGE_OWNER_CORNER[t][None, :], axis=1
        )  # (S, 6)
        ekeys = edge_key(owner_keys, _TET_EDGE_LABEL[t][None, :])
        vids, vfound = edge_vids.lookup(ekeys)
        vids = np.where(vfound, vids, -1)  # (S, 6)

        tri_edges = _TRI_TABLE[case]  # (S, 2, 3) of tet-edge ids (-1 pad)
        tri_ok = _TRI_VALID[case]  # (S, 2)
        tvids = np.take_along_axis(
            vids[:, None, :].repeat(2, axis=1).reshape(s * 2, 6),
            np.maximum(tri_edges, 0).reshape(s * 2, 3),
            axis=1,
        ).reshape(s, 2, 3)
        resolved = (tvids >= 0).all(axis=2)
        distinct = (
            (tvids[..., 0] != tvids[..., 1])
            & (tvids[..., 1] != tvids[..., 2])
            & (tvids[..., 0] != tvids[..., 2])
        )
        keep[:, t] = tri_ok & resolved & distinct & ok[:, None]
        tris_out[:, t] = tvids

    return tris_out[keep]


def _edge_crossing_points(
    u_ijk: np.ndarray, v_ijk: np.ndarray, evalmap: KeyedValues, lattice: SampleLattice
):
    """Batched world-space crossing points on lattice edges (u, v).

    Returns (points (P, 3), valid (P,)); invalid where a value is missing.
    """
    vu, fu = evalmap.lookup(pack_ijk(u_ijk))
    vv, fv = evalmap.lookup(pack_ijk(v_ijk))
    valid = fu & fv & np.isfinite(vu) & np.isfinite(vv)
    denom = vu - vv
    t = np.where(
        np.abs(denom) < _EPS_DIV,
        0.5,
        np.clip(vu / np.where(np.abs(denom) < _EPS_DIV, 1.0, denom), 0.0, 1.0),
    )
    pu = lattice.ijk_to_world(u_ijk)
    pv = lattice.ijk_to_world(v_ijk)
    return pu + t[:, None] * (pv - pu), valid


class _TopologyPlan:
    """Per-unique-mask cluster templates (the mask decides the case except
    for the value-dependent flat-hole branch)."""

    __slots__ = ("case", "clusters_a", "clusters_b", "flat_eligible", "flat_rows")

    def __init__(self, mask: int, cluster: bool):
        def bits(m):
            return [e for e in range(14) if m >> e & 1]

        self.flat_eligible = False
        self.flat_rows = []
        if not cluster:
            self.case = "DoNotCluster"
            self.clusters_a = [[e] for e in bits(mask)]
        elif mask == ALL14_MASK:
            self.case = "ClosedSurface"
            self.clusters_a = [[e] for e in bits(mask)]
        else:
            comps = connected_components_masks(mask)
            if len(comps) > 1:
                self.case = "MultiSurface"
                self.clusters_a = [bits(c) for c in comps]
            else:
                holes = connected_components_masks(ALL14_MASK & ~mask)
                if len(holes) != 1:
                    self.case = "MultiHole"
                    self.clusters_a = [[e] for e in bits(mask)]
                else:
                    # flat-hole is per-sample (value-dependent):
                    # clusters_a = flat (singletons), clusters_b = simple
                    self.flat_eligible = True
                    self.case = None
                    self.clusters_a = [[e] for e in bits(mask)]
                    self.clusters_b = [bits(mask)]
                    for r, (em, om) in enumerate(FLAT_HOLE_MASKS.tolist()):
                        if (mask & em) == 0 and (mask & om) == om:
                            ab = bits(em)
                            cd = bits(om)
                            if len(ab) == 2 and len(cd) == 2:
                                self.flat_rows.append((ab[0], ab[1], cd[0], cd[1]))
        if not self.flat_eligible:
            self.clusters_b = self.clusters_a


def _flat_hole_flags(sample_ijk, rows, evalmap):
    """Vectorised Figure-6 flat-hole test for samples sharing one mask."""
    if not rows:
        return np.zeros(sample_ijk.shape[0], bool)
    flat = np.zeros(sample_ijk.shape[0], bool)
    for a, b, c, d in rows:
        vals = []
        founds = []
        for e in (a, b, c, d):
            v, f = evalmap.lookup(pack_ijk(sample_ijk + EDGE_DELTAS[e]))
            vals.append(v)
            founds.append(f & np.isfinite(v))
        av, bv, cv, dv = vals
        usable = founds[0] & founds[1] & founds[2] & founds[3]

        def near(xv):
            in_x = xv < -_INSIDE_EPS
            out = np.ones(xv.shape, bool)
            for yv in (dv, cv):
                crossing = in_x != (yv < -_INSIDE_EPS)
                denom = xv - yv
                alpha = np.where(
                    np.abs(denom) < _EPS_DIV,
                    0.5,
                    np.clip(xv / np.where(np.abs(denom) < _EPS_DIV, 1.0, denom), 0.0, 1.0),
                )
                out &= crossing & (alpha < 0.5)
            return out

        flat |= usable & (near(av) | near(bv))
    return flat


def build_isosurfaces(
    seed_points,
    extents,
    resolution,
    isovalues,
    isosurface_fn,
    gradient_fn=None,
    cluster_method=ClusterMethod.CurvatureWeighted,
    boundary_closure=BoundaryClosure.None_,
    progress_callback=None,
):
    return [
        build_isosurface(
            seed_points, extents, resolution, iso, isosurface_fn, gradient_fn,
            cluster_method, boundary_closure, progress_callback,
        )
        for iso in isovalues
    ]


def build_isosurface(
    seed_points,
    extents,
    resolution,
    isovalue,
    isosurface_fn,
    gradient_fn=None,
    cluster_method=ClusterMethod.CurvatureWeighted,
    boundary_closure=BoundaryClosure.None_,
    progress_callback=None,
) -> Mesh:
    extents = np.asarray(extents, np.float64).reshape(6)
    lattice = SampleLattice(resolution, extents)
    eps = bbox_eps(extents)

    _emit(progress_callback, isovalue, IsosurfaceStage.ProjectingSeeds, 0.0)

    if gradient_fn is not None:
        def grad_wrap(pts):
            vals, grads = gradient_fn(pts)
            return np.asarray(vals).reshape(-1, 1), np.asarray(grads).reshape(-1, 3)
    else:
        def grad_wrap(pts):
            return seed_projection.central_difference_values_and_gradients(
                pts, isosurface_fn, lattice
            )

    with traced_stage("rmt_seed_projection"):
        seeds = seed_projection.get_unique_seed_point_ijks(
            seed_points, grad_wrap, lattice, isovalue
        )

    evalmap = KeyedValues()

    def evaluate_new(keys: np.ndarray) -> None:
        """Evaluate the field at packed corner keys not yet in the map."""
        if keys.size == 0:
            return
        worlds = lattice.ijk_to_world(unpack_ijk(keys))
        vals = np.asarray(isosurface_fn(worlds), np.float64).reshape(-1) - isovalue
        evalmap.insert(keys, vals)

    _emit(progress_callback, isovalue, IsosurfaceStage.ExpandingWavefront, 0.05)

    # --- wavefront expansion (fully batched per generation) ----------------
    cells = np.asarray(sorted(seeds), np.int64).reshape(-1, 3)
    seen = np.unique(pack_ijk(cells))
    acc_keys = [seen.copy()]  # every visited cell is a sample (mask may be 0)
    acc_bits = [np.zeros(seen.size, np.int64)]
    rev_bits7 = (1 << REVERSE_EDGE[:7]).astype(np.int64)
    own_bit7 = (1 << np.arange(7)).astype(np.int64)

    while cells.shape[0]:
        corners = cells[:, None, :] + _CORNER_OFFSETS[None]  # (M, 8, 3)
        ckeys = pack_ijk(corners)
        uniq = np.unique(ckeys)
        evaluate_new(uniq[~evalmap.contains(uniq)])
        vals, _found = evalmap.lookup(ckeys)  # (M, 8)
        with np.errstate(invalid="ignore", divide="ignore"):
            inside = vals < -_INSIDE_EPS
            s0 = vals[:, 0:1]
            cross = inside[:, 1:] != inside[:, 0:1]
            denom = s0 - vals[:, 1:]
            t = s0 / np.where(np.abs(denom) < _EPS_DIV, 1.0, denom)
            cross &= np.isfinite(vals[:, 0:1]) & np.isfinite(vals[:, 1:])
            near = cross & (t < 0.5)
            far = cross & ~near

        acc_keys.append(ckeys[:, 0])
        acc_bits.append((near * own_bit7[None]).sum(axis=1))
        if far.any():
            acc_keys.append(ckeys[:, 1:][far])
            acc_bits.append(np.broadcast_to(rev_bits7, far.shape)[far])

        has_x = cross.any(axis=1)
        cand = []
        for f in range(6):
            face_in = inside[:, FACES[f]]
            ok = has_x & face_in.any(axis=1) & (~face_in).any(axis=1)
            if ok.any():
                cand.append(cells[ok] + FACE_DIRS[f][None])
        if not cand:
            break
        cand = np.concatenate(cand)
        ckeys2 = pack_ijk(cand)
        k2, first = np.unique(ckeys2, return_index=True)
        cand = cand[first]
        fresh = ~in_sorted(seen, k2)
        cand, k2 = cand[fresh], k2[fresh]
        if cand.shape[0]:
            cc = (cand[:, None, :] + _CORNER_OFFSETS[None]).reshape(-1, 3)
            inb = lattice.extraction_ijk_inbounds(cc).reshape(-1, 8).any(axis=1)
            cand, k2 = cand[inb], k2[inb]
        seen = merge_sorted(seen, k2)
        acc_keys.append(k2)
        acc_bits.append(np.zeros(k2.size, np.int64))
        cells = cand

    # --- assemble sample masks ---------------------------------------------
    all_keys = np.concatenate(acc_keys)
    all_bits = np.concatenate(acc_bits)
    sample_keys, inv = np.unique(all_keys, return_inverse=True)
    sample_masks = np.zeros(sample_keys.size, np.int64)
    np.bitwise_or.at(sample_masks, inv, all_bits)
    sample_ijk = unpack_ijk(sample_keys)

    # --- fill missing neighbour values for topology tests ------------------
    act = sample_masks != 0
    if act.any():
        nbrs = sample_ijk[act][:, None, :] + EDGE_DELTAS[None]  # (S, 14, 3)
        need = np.unique(
            np.concatenate([sample_keys[act], pack_ijk(nbrs).reshape(-1)])
        )
        evaluate_new(need[~evalmap.contains(need)])

    _emit(progress_callback, isovalue, IsosurfaceStage.ClusteringVertices, 0.7)

    # --- topology tests (grouped by unique mask) + clustering --------------
    should_cluster = cluster_method != ClusterMethod.None_
    case_counts = dict.fromkeys(
        ("ClosedSurface", "MultiHole", "FlatHole", "MultiSurface", "SimpleSurface"), 0
    )

    act_idx = np.nonzero(act)[0]
    act_masks = sample_masks[act_idx] & ALL14_MASK
    uniq_masks, mask_inv = np.unique(act_masks, return_inverse=True)
    plans = [_TopologyPlan(int(m), should_cluster) for m in uniq_masks]

    # flattened (sample, edge, cluster) tables, grouped per unique mask and
    # tiled over that mask's samples — no per-sample Python
    pair_sample_parts: list[np.ndarray] = []  # index into act_idx
    pair_edge_parts: list[np.ndarray] = []
    pair_cluster_parts: list[np.ndarray] = []
    cluster_sample_parts: list[np.ndarray] = []
    n_clusters = 0

    def emit_group(members: np.ndarray, template) -> None:
        nonlocal n_clusters
        if members.size == 0 or not template:
            return
        edges_t = np.concatenate([np.asarray(cl, np.int64) for cl in template])
        cl_local = np.concatenate(
            [np.full(len(cl), i, np.int64) for i, cl in enumerate(template)]
        )
        ncl = len(template)
        k = edges_t.size
        m = members.size
        pair_sample_parts.append(np.repeat(members, k))
        pair_edge_parts.append(np.tile(edges_t, m))
        base = n_clusters + np.arange(m, dtype=np.int64) * ncl
        pair_cluster_parts.append((base[:, None] + cl_local[None, :]).reshape(-1))
        cluster_sample_parts.append(np.repeat(members, ncl))
        n_clusters += m * ncl

    for mi, plan in enumerate(plans):
        members = np.nonzero(mask_inv == mi)[0]
        if members.size == 0:
            continue
        if plan.flat_eligible:
            flat = _flat_hole_flags(sample_ijk[act_idx[members]], plan.flat_rows, evalmap)
            case_counts["FlatHole"] += int(flat.sum())
            case_counts["SimpleSurface"] += int((~flat).sum())
            emit_group(members[flat], plan.clusters_a)
            emit_group(members[~flat], plan.clusters_b)
        else:
            if plan.case in case_counts:
                case_counts[plan.case] += members.size
            emit_group(members, plan.clusters_a)

    if n_clusters:
        pair_sample = np.concatenate(pair_sample_parts)
        pair_edge = np.concatenate(pair_edge_parts)
        pair_cluster = np.concatenate(pair_cluster_parts)
        cluster_sample = np.concatenate(cluster_sample_parts)
    else:
        pair_sample = np.zeros(0, np.int64)
        pair_edge = np.zeros(0, np.int64)
        pair_cluster = np.zeros(0, np.int64)
        cluster_sample = np.zeros(0, np.int64)

    # --- crossing points + curvature-weighted cluster candidates -----------
    pair_u = sample_ijk[act_idx[pair_sample]]  # (P, 3)
    pair_v = pair_u + EDGE_DELTAS[pair_edge]
    pair_pts, pair_valid = _edge_crossing_points(pair_u, pair_v, evalmap, lattice)

    if cluster_method == ClusterMethod.CurvatureWeighted and pair_u.shape[0]:
        # owned-edge normalisation: labels >= 7 belong to the neighbour
        flip = pair_edge >= 7
        own_ijk = np.where(flip[:, None], pair_v, pair_u)
        own_lab = np.where(flip, REVERSE_EDGE[pair_edge], pair_edge)
        weights = curvature_weights_batch(own_ijk, own_lab, evalmap, lattice)
        weights = np.where(np.isnan(weights), 1.0, weights)
    else:
        weights = np.ones(pair_u.shape[0])

    weights = np.where(pair_valid, weights, 0.0)
    wsum = np.zeros(n_clusters)
    wpt = np.zeros((n_clusters, 3))
    np.add.at(wsum, pair_cluster, weights)
    np.add.at(wpt, pair_cluster, weights[:, None] * pair_pts)
    # fallback (curvature gave no usable weights): plain mean of valid points
    vcount = np.zeros(n_clusters)
    vsum = np.zeros((n_clusters, 3))
    np.add.at(vcount, pair_cluster, pair_valid.astype(np.float64))
    np.add.at(vsum, pair_cluster, np.where(pair_valid[:, None], pair_pts, 0.0))
    good = wsum > 1e-12
    with np.errstate(invalid="ignore", divide="ignore"):
        cand_pts = np.where(
            good[:, None],
            wpt / np.where(good, wsum, 1.0)[:, None],
            vsum / np.maximum(vcount, 1.0)[:, None],
        )
    cluster_has_pts = vcount > 0

    # drop clusters with no valid crossing points, preserving order
    keep_cluster = cluster_has_pts
    new_cid = np.cumsum(keep_cluster) - 1
    pair_keep = keep_cluster[pair_cluster] & pair_valid
    pair_sample = pair_sample[pair_keep]
    pair_edge = pair_edge[pair_keep]
    pair_cluster = new_cid[pair_cluster[pair_keep]]
    pair_pts = pair_pts[pair_keep]
    pair_u = pair_u[pair_keep]
    pair_v = pair_v[pair_keep]
    cand_pts = cand_pts[keep_cluster]
    cluster_sample = cluster_sample[keep_cluster]
    n_clusters = int(keep_cluster.sum())
    cluster_size = np.bincount(pair_cluster, minlength=n_clusters).astype(np.int64)

    _emit_msg(
        progress_callback,
        "Closed surfaces: {ClosedSurface}\nMulti-holes: {MultiHole}\n"
        "Flat holes: {FlatHole}\nMulti-surfaces: {MultiSurface}\n"
        "Simple surfaces: {SimpleSurface}".format(**case_counts),
    )
    _emit(progress_callback, isovalue, IsosurfaceStage.BuildingFacets, 0.82)

    # --- candidate edge-key registry (owner sample, owned label) -----------
    flip = pair_edge >= 7
    own_keys = pack_ijk(np.where(flip[:, None], pair_v, pair_u))
    own_labs = np.where(flip, REVERSE_EDGE[pair_edge], pair_edge)
    pair_ekeys = edge_key(own_keys, own_labs)

    def _edge_map(values: np.ndarray) -> KeyedValues:
        m = KeyedValues(dtype=np.int64, fill=-1)
        uq, first = np.unique(pair_ekeys, return_index=True)
        m.insert(uq, values[first])
        return m

    march_ijk = sample_ijk  # all samples (mask 0 included) participate

    # --- predicted-edge-count prefilter ------------------------------------
    cand_map = _edge_map(pair_cluster)
    pre_tris = _march_tets_vec(march_ijk, evalmap, cand_map)
    split_candidates = np.zeros(n_clusters, bool)
    if pre_tris.shape[0]:
        e3 = pre_tris[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
        emin = e3.min(axis=1)
        emax = e3.max(axis=1)
        ekeys2 = emin * np.int64(1 << 31) + emax
        uq, counts = np.unique(ekeys2, return_counts=True)
        bad = uq[counts > 2]
        if bad.size:
            a = (bad // (1 << 31)).astype(np.int64)
            b = (bad % (1 << 31)).astype(np.int64)
            for cid in np.unique(np.concatenate([a, b])):
                if cluster_size[cid] > 1:
                    split_candidates[cid] = True

    # --- materialise vertices ----------------------------------------------
    nv_per = np.where(split_candidates, cluster_size, 1)
    v_off = np.concatenate([[0], np.cumsum(nv_per)])
    num_vertices = int(v_off[-1])
    vertices = np.zeros((num_vertices, 3))
    vertices[v_off[:-1][~split_candidates]] = cand_pts[~split_candidates]
    # split candidates: one vertex per pair (crossing point), in pair order
    pair_rank = np.arange(pair_cluster.size) - np.concatenate([[0], np.cumsum(cluster_size)])[pair_cluster]
    pair_vid = np.where(
        split_candidates[pair_cluster],
        v_off[pair_cluster] + pair_rank,
        v_off[pair_cluster],
    )
    vertices[pair_vid[split_candidates[pair_cluster]]] = pair_pts[
        split_candidates[pair_cluster]
    ]
    edge_map = _edge_map(pair_vid)

    # cluster bookkeeping for rollbacks: vid -> pair rows; owner -> vids
    cluster_vertex_pairs: dict[int, np.ndarray] = {}
    cluster_vertex_owner: dict[int, int] = {}
    owner_cluster_vertices: dict[int, list] = {}
    cl_starts = np.concatenate([[0], np.cumsum(cluster_size)])
    for cid in np.nonzero((cluster_size > 1) & ~split_candidates)[0]:
        vid = int(v_off[cid])
        rows = np.arange(cl_starts[cid], cl_starts[cid + 1])  # contiguous
        cluster_vertex_pairs[vid] = rows
        owner = int(cluster_sample[cid])
        cluster_vertex_owner[vid] = owner
        owner_cluster_vertices.setdefault(owner, []).append(vid)

    vertices_list = [vertices]
    next_vid = num_vertices

    def rollback_owners(bad_owners) -> int:
        nonlocal next_vid
        bad_vids = []
        rolled = 0
        for owner in bad_owners:
            vids = owner_cluster_vertices.pop(owner, None)
            if vids:
                rolled += 1
                bad_vids.extend(vids)
        upd_keys = []
        upd_vids = []
        new_pts = []
        for vid in bad_vids:
            rows = cluster_vertex_pairs.pop(vid, None)
            if rows is None:
                continue
            cluster_vertex_owner.pop(vid, None)
            for r in rows:
                upd_keys.append(pair_ekeys[r])
                upd_vids.append(next_vid)
                new_pts.append(pair_pts[r])
                next_vid += 1
        if upd_keys:
            vertices_list.append(np.asarray(new_pts))
            edge_map.update(
                np.asarray(upd_keys, np.int64), np.asarray(upd_vids, np.int64)
            )
        return rolled

    facets = _march_tets_vec(march_ijk, evalmap, edge_map)

    # --- non-manifold rollback (up to 4 rounds) ----------------------------
    if cluster_vertex_pairs and facets.shape[0]:
        total_rolled = 0
        for _ in range(4):
            e3 = facets[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
            ekeys2 = e3.min(axis=1) * np.int64(1 << 31) + e3.max(axis=1)
            uq, inv2, counts = np.unique(ekeys2, return_inverse=True, return_counts=True)
            bad_edge = counts[inv2] > 2  # per (tri, edge) flattened
            bad_tri = bad_edge.reshape(-1, 3).any(axis=1)
            bad_owners = set()
            for vid in np.unique(facets[bad_tri]):
                owner = cluster_vertex_owner.get(int(vid))
                if owner is not None:
                    bad_owners.add(owner)
            if not bad_owners:
                break
            rolled = rollback_owners(bad_owners)
            if rolled == 0:
                break
            total_rolled += rolled
            facets = _march_tets_vec(march_ijk, evalmap, edge_map)
        _emit_msg(
            progress_callback,
            f"Rolled back {total_rolled} sample points from non-manifold edges.",
        )

    # --- self-intersection rollback ----------------------------------------
    if cluster_vertex_pairs and facets.shape[0]:
        verts_arr = np.concatenate(vertices_list)
        inside_f = facets_fully_inside_aabb(verts_arr, facets, extents, eps)
        inside_idx = np.nonzero(inside_f)[0]
        bad_tris = get_intersecting_triangles(verts_arr, facets[inside_idx])
        if bad_tris.size:
            bad_owners = set()
            for vid in np.unique(facets[inside_idx[bad_tris]]):
                owner = cluster_vertex_owner.get(int(vid))
                if owner is not None:
                    bad_owners.add(owner)
            if bad_owners:
                rolled = rollback_owners(bad_owners)
                if rolled:
                    facets = _march_tets_vec(march_ijk, evalmap, edge_map)
                _emit_msg(
                    progress_callback,
                    f"Rolled back {rolled} sample points from self-intersections.",
                )

    # --- clip, clean, cap --------------------------------------------------
    verts_arr = np.concatenate(vertices_list).reshape(-1, 3)
    tris_arr = facets.reshape(-1, 3)

    verts_arr, tris_arr = clip_mesh_to_aabb(verts_arr, tris_arr, extents, eps)

    _emit(progress_callback, isovalue, IsosurfaceStage.CleaningMesh, 0.94)
    verts_arr, tris_arr = clean_mesh(verts_arr, tris_arr, eps)

    _emit(progress_callback, isovalue, IsosurfaceStage.BoundaryClosure, 0.97)
    verts_arr, tris_arr = cap_mesh_to_aabb(
        verts_arr, tris_arr, extents, resolution, boundary_closure, eps
    )

    _emit(progress_callback, isovalue, IsosurfaceStage.Finished, 1.0)
    return Mesh(verts_arr, tris_arr)
