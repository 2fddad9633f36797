"""Topology tests deciding whether a sample point's intersections may
cluster without changing surface topology (Treece et al. section 3.2).

Maps ``ferreus_rmt/src/topology.rs``: the cases are closed-surface,
multi-hole, flat-hole, multi-surface, and simple-surface; components are
connected components of the 14-edge adjacency graph (Table 3 masks), holes
are components of the complement, and the flat-hole criterion follows the
paper's Figure 6 test with near-intersections at alpha < 0.5.
"""

from __future__ import annotations

import enum

from .constants import (
    ALL14_MASK,
    EDGE_DELTAS,
    FLAT_HOLE_MASKS,
    NEIGHBOUR_MASKS,
)
from .isosurface_util import is_inside, lerp_alpha


class TopologyCase(enum.Enum):
    ClosedSurface = "ClosedSurface"
    MultiHole = "MultiHole"
    FlatHole = "FlatHole"
    MultiSurface = "MultiSurface"
    SimpleSurface = "SimpleSurface"
    DoNotCluster = "DoNotCluster"


def _bits(mask: int):
    out = []
    while mask:
        b = mask & (-mask)
        out.append(b.bit_length() - 1)
        mask ^= b
    return out


def connected_components_masks(edge_mask: int):
    """Connected components of set edges under the Table 3 adjacency."""
    remaining = edge_mask & ALL14_MASK
    comps = []
    while remaining:
        seed = remaining & (-remaining)
        remaining ^= seed
        comp = 0
        frontier = seed
        while frontier:
            b = frontier & (-frontier)
            frontier ^= b
            e = b.bit_length() - 1
            comp |= b
            nbrs = int(NEIGHBOUR_MASKS[e]) & remaining
            remaining ^= nbrs
            frontier |= nbrs
        comps.append(comp)
    return comps


def _endpoint_value(ijk, edge, values):
    d = EDGE_DELTAS[edge]
    key = (ijk[0] + int(d[0]), ijk[1] + int(d[1]), ijk[2] + int(d[2]))
    v = values.get(key)
    if v is None or v != v:
        return None
    return v


def _crossing_alpha(a_val, b_val):
    if is_inside(a_val) == is_inside(b_val):
        return None
    return lerp_alpha(a_val, b_val)


def is_flat_hole(surface_comp: int, ijk, values) -> bool:
    """Figure 6: OA/OB without near intersections and OC/OD with them, where
    the AD/AC (or BC/BD) crossings are both near A (resp. B)."""
    sm = surface_comp & ALL14_MASK
    for edge_mask, opposite_mask in FLAT_HOLE_MASKS.tolist():
        if sm & edge_mask:
            continue
        if (sm & opposite_mask) != opposite_mask:
            continue
        ab = _bits(edge_mask)
        cd = _bits(opposite_mask)
        if len(ab) != 2 or len(cd) != 2:
            continue
        a, b = ab
        c, d = cd
        vals = [_endpoint_value(ijk, e, values) for e in (a, b, c, d)]
        if any(v is None for v in vals):
            continue
        a_val, b_val, c_val, d_val = vals

        def near(x_val):
            t1 = _crossing_alpha(x_val, d_val)
            t2 = _crossing_alpha(x_val, c_val)
            return t1 is not None and t1 < 0.5 and t2 is not None and t2 < 0.5

        if near(a_val) or near(b_val):
            return True
    return False


def test_topology(near_mask: int, cluster: bool, ijk, values):
    """Returns (case, clusters) with clusters as lists of edge labels."""
    m = near_mask & ALL14_MASK
    if m == 0:
        return TopologyCase.SimpleSurface, []
    if not cluster:
        return TopologyCase.DoNotCluster, [[e] for e in _bits(m)]
    if m == ALL14_MASK:
        return TopologyCase.ClosedSurface, [[e] for e in _bits(m)]

    comps = connected_components_masks(m)
    if len(comps) > 1:
        return TopologyCase.MultiSurface, [_bits(c) for c in comps]

    holes = connected_components_masks(ALL14_MASK & ~m)
    if len(holes) != 1:
        return TopologyCase.MultiHole, [[e] for e in _bits(m)]
    if is_flat_hole(m, ijk, values):
        return TopologyCase.FlatHole, [[e] for e in _bits(m)]
    return TopologyCase.SimpleSurface, [_bits(m)]
