"""Small shared helpers for the RMT pipeline."""

from __future__ import annotations

import numpy as np

from .constants import EDGE_DELTAS, REVERSE_EDGE, delta_to_edge

_INSIDE_EPS = 1e-9


def is_inside(v: float) -> bool:
    """A value is inside the surface when below -eps (matching the
    reference's sign convention at ``isosurface.rs:286-289``)."""
    return v < -_INSIDE_EPS


def lerp_alpha(vu: float, vv: float) -> float:
    """Interpolation weight for the zero crossing along an edge."""
    denom = vu - vv
    if abs(denom) < 1e-30:
        return 0.5
    return min(max(vu / denom, 0.0), 1.0)


def get_edge_owner(u, v):
    """(owner, other, owned_label) for an edge under 7-edge ownership."""
    delta = (v[0] - u[0], v[1] - u[1], v[2] - u[2])
    eid = delta_to_edge(delta)
    if eid is None:
        return None
    if eid < 7:
        return u, v, eid
    return v, u, int(REVERSE_EDGE[eid])


def edge_intersection_point(u, v, evaluated, lattice):
    """World-space crossing point of the isosurface on lattice edge (u, v)."""
    vu = evaluated.get(u)
    vv = evaluated.get(v)
    if vu is None or vv is None or not np.isfinite(vu) or not np.isfinite(vv):
        return None
    pu = lattice.ijk_to_world(np.asarray(u, np.float64))
    pv = lattice.ijk_to_world(np.asarray(v, np.float64))
    t = lerp_alpha(vu, vv)
    return tuple(pu + t * (pv - pu))


def edge_points_8(ijk):
    """The sample point and its 7 owned-edge endpoints."""
    out = [tuple(ijk)]
    for e in range(7):
        d = EDGE_DELTAS[e]
        out.append((ijk[0] + int(d[0]), ijk[1] + int(d[1]), ijk[2] + int(d[2])))
    return out
