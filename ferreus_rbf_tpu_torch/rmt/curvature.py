"""Curvature-weighted vertex clustering (Treece et al. section 3.4).

Maps ``ferreus_rmt/src/curvature_weighting.rs``: for each intersected edge,
each calculation plane around it yields theta_b/theta_c via Equation (1),
alpha = |theta_b| + |theta_c| (Eq. 2); a local normal estimate from the
cot-weighted perpendiculars orients alpha into beta (Eq. 3), and the edge's
clustering weight is 1/tan(beta/2) (Eq. 4), clamped. The cluster vertex is
the weight-averaged crossing point.
"""

from __future__ import annotations

import numpy as np

from .constants import (
    EDGE_DELTAS,
    NEIGHBOUR_EDGE_PLANE_PAIRS,
    NEIGHBOUR_EDGE_PLANE_PHIS,
)
from .isosurface_util import edge_intersection_point, get_edge_owner

_EPS = 1e-12
_MAX_COT_THETA = 1e12
_MAX_CURVATURE_WEIGHT = 1e12


def _unit(v):
    n = np.linalg.norm(v)
    if n <= _EPS:
        return None
    return v / n


def curvature_weight_for_edge(owner, other, edge_id, evaluated, lattice):
    do_ = evaluated.get(owner)
    da = evaluated.get(other)
    if do_ is None or da is None or not np.isfinite(do_) or not np.isfinite(da):
        return None

    pairs = NEIGHBOUR_EDGE_PLANE_PAIRS[edge_id]
    phis = NEIGHBOUR_EDGE_PLANE_PHIS[edge_id]

    o_world = lattice.ijk_to_world(np.asarray(owner, np.float64))
    a_world = lattice.ijk_to_world(np.asarray(other, np.float64))
    oa = a_world - o_world
    oa_len = np.linalg.norm(oa)
    if oa_len <= _EPS:
        return None
    oa_hat = oa / oa_len

    plane_alphas = []
    plane_axes = []
    projection_sum = np.zeros(3)

    for pair, phi_pair in zip(pairs, phis):
        perp_dirs = []
        thetas = []
        cot_thetas = []
        for side in range(2):
            nbr_edge = pair[side]
            phi = phi_pair[side]
            d = EDGE_DELTAS[nbr_edge]
            nbr = (owner[0] + int(d[0]), owner[1] + int(d[1]), owner[2] + int(d[2]))
            db = evaluated.get(nbr)
            if db is None or not np.isfinite(db):
                return None
            b_world = lattice.ijk_to_world(np.asarray(nbr, np.float64))
            ob = b_world - o_world
            ob_len = np.linalg.norm(ob)
            if ob_len <= _EPS:
                return None
            ob_perp = ob - oa_hat * (ob @ oa_hat)
            ob_perp_dir = _unit(ob_perp)
            if ob_perp_dir is None:
                return None

            # Equation (1)
            denominator = (do_ - da) * ob_len
            if abs(denominator) <= _EPS:
                return None
            ratio = ((do_ - db) * oa_len) / denominator
            divisor = ratio - np.cos(phi)
            if abs(divisor) <= _EPS:
                theta = -np.pi / 2 if divisor < 0 or (divisor == 0 and np.signbit(divisor)) else np.pi / 2
            else:
                theta = np.arctan(np.sin(phi) / divisor)
            tan_theta = np.tan(theta)
            cot = (
                np.copysign(_MAX_COT_THETA, theta)
                if abs(tan_theta) <= _EPS
                else 1.0 / tan_theta
            )
            perp_dirs.append(ob_perp_dir)
            thetas.append(theta)
            cot_thetas.append(cot)

        # Equation (2)
        alpha = abs(thetas[0]) + abs(thetas[1])
        axis = _unit(perp_dirs[0] - perp_dirs[1])
        if axis is None:
            axis = perp_dirs[0]
        plane_alphas.append(alpha)
        plane_axes.append(axis)
        projection_sum += perp_dirs[0] * cot_thetas[0] + perp_dirs[1] * cot_thetas[1]

    scale = 2.0 / 3.0 if len(plane_alphas) == 3 else 1.0
    n_est = _unit(oa_hat + projection_sum * scale)
    if n_est is None:
        return None

    min_abs_tan_half_beta = np.inf
    for alpha, axis in zip(plane_alphas, plane_axes):
        axis_u = _unit(axis)
        if axis_u is None:
            return None
        sin_gamma = min(max(abs(n_est @ axis_u), 0.0), 1.0)
        gamma = np.arcsin(sin_gamma)
        cos_gamma = np.cos(gamma)
        one_minus_cg2 = 1.0 - cos_gamma * cos_gamma
        sin_half_alpha = abs(np.sin(0.5 * alpha))
        if sin_half_alpha <= _EPS:
            beta = 0.0
        else:
            curvature_term = 1.0 / (sin_half_alpha * sin_half_alpha) - 1.0  # Eq. (3)
            if curvature_term < 0.0:
                return None
            inv_tan2 = one_minus_cg2 * curvature_term
            if inv_tan2 <= _EPS:
                continue
            beta = 2.0 * np.arctan(1.0 / np.sqrt(inv_tan2))
        min_abs_tan_half_beta = min(min_abs_tan_half_beta, abs(np.tan(0.5 * beta)))

    if not np.isfinite(min_abs_tan_half_beta):
        return None
    if min_abs_tan_half_beta <= _EPS:
        return _MAX_CURVATURE_WEIGHT
    return min(1.0 / min_abs_tan_half_beta, _MAX_CURVATURE_WEIGHT)  # Eq. (4)


def curvature_weights_batch(owner_ijk, edge_ids, evalmap, lattice):
    """Vectorised Eq. 1-4 weights for (owner sample, owned-edge) pairs.

    Same math as :func:`curvature_weight_for_edge`, batched per edge label
    (the plane structure is fixed per label). ``evalmap`` is a
    ``keymap.KeyedValues`` of corner values. Returns (P,) weights with NaN
    where the scalar path would return None (caller substitutes 1.0).
    """
    from .keymap import pack_ijk

    owner_ijk = np.asarray(owner_ijk, np.int64)
    edge_ids = np.asarray(edge_ids, np.int64)
    out = np.full(owner_ijk.shape[0], np.nan)

    for e in range(14):
        sel = np.nonzero(edge_ids == e)[0]
        if sel.size == 0:
            continue
        o = owner_ijk[sel]
        g = sel.size
        pairs = NEIGHBOUR_EDGE_PLANE_PAIRS[e]
        phis = NEIGHBOUR_EDGE_PLANE_PHIS[e]
        npl = len(pairs)

        do_, f0 = evalmap.lookup(pack_ijk(o))
        da, f1 = evalmap.lookup(pack_ijk(o + EDGE_DELTAS[e]))
        valid = f0 & f1 & np.isfinite(do_) & np.isfinite(da)

        o_world = lattice.ijk_to_world(o)
        a_world = lattice.ijk_to_world(o + EDGE_DELTAS[e])
        oa = a_world - o_world
        oa_len = np.linalg.norm(oa, axis=1)
        valid &= oa_len > _EPS
        safe_oa = np.where(oa_len > _EPS, oa_len, 1.0)
        oa_hat = oa / safe_oa[:, None]

        plane_alphas = np.zeros((npl, g))
        plane_axes = np.zeros((npl, g, 3))
        projection_sum = np.zeros((g, 3))

        for pi in range(npl):
            dirs = []
            thetas = []
            cots = []
            for side in range(2):
                nbr_edge = pairs[pi][side]
                phi = phis[pi][side]
                nbr = o + EDGE_DELTAS[nbr_edge]
                db, fb = evalmap.lookup(pack_ijk(nbr))
                valid &= fb & np.isfinite(db)
                b_world = lattice.ijk_to_world(nbr)
                ob = b_world - o_world
                ob_len = np.linalg.norm(ob, axis=1)
                valid &= ob_len > _EPS
                ob_perp = ob - oa_hat * np.sum(ob * oa_hat, axis=1)[:, None]
                pn = np.linalg.norm(ob_perp, axis=1)
                valid &= pn > _EPS
                dirp = ob_perp / np.where(pn > _EPS, pn, 1.0)[:, None]

                denominator = (do_ - da) * ob_len
                valid &= np.abs(denominator) > _EPS
                safe_den = np.where(np.abs(denominator) > _EPS, denominator, 1.0)
                ratio = ((do_ - db) * oa_len) / safe_den
                divisor = ratio - np.cos(phi)
                small = np.abs(divisor) <= _EPS
                with np.errstate(divide="ignore", invalid="ignore"):
                    theta = np.where(
                        small,
                        np.where(np.signbit(divisor), -np.pi / 2, np.pi / 2),
                        np.arctan(np.sin(phi) / np.where(small, 1.0, divisor)),
                    )
                tan_theta = np.tan(theta)
                cot = np.where(
                    np.abs(tan_theta) <= _EPS,
                    np.copysign(_MAX_COT_THETA, theta),
                    1.0 / np.where(np.abs(tan_theta) <= _EPS, 1.0, tan_theta),
                )
                dirs.append(dirp)
                thetas.append(theta)
                cots.append(cot)

            plane_alphas[pi] = np.abs(thetas[0]) + np.abs(thetas[1])
            axis = dirs[0] - dirs[1]
            an = np.linalg.norm(axis, axis=1)
            plane_axes[pi] = np.where(
                (an > _EPS)[:, None], axis / np.where(an > _EPS, an, 1.0)[:, None], dirs[0]
            )
            projection_sum += dirs[0] * cots[0][:, None] + dirs[1] * cots[1][:, None]

        scale = 2.0 / 3.0 if npl == 3 else 1.0
        n_vec = oa_hat + projection_sum * scale
        n_len = np.linalg.norm(n_vec, axis=1)
        valid &= n_len > _EPS
        n_est = n_vec / np.where(n_len > _EPS, n_len, 1.0)[:, None]

        min_tan = np.full(g, np.inf)
        for pi in range(npl):
            axis = plane_axes[pi]
            an = np.linalg.norm(axis, axis=1)
            valid &= an > _EPS
            axis_u = axis / np.where(an > _EPS, an, 1.0)[:, None]
            sin_gamma = np.clip(np.abs(np.sum(n_est * axis_u, axis=1)), 0.0, 1.0)
            gamma = np.arcsin(sin_gamma)
            cos_gamma = np.cos(gamma)
            one_minus_cg2 = 1.0 - cos_gamma * cos_gamma
            sin_half_alpha = np.abs(np.sin(0.5 * plane_alphas[pi]))
            tiny_alpha = sin_half_alpha <= _EPS
            with np.errstate(divide="ignore", invalid="ignore"):
                curvature_term = (
                    1.0 / np.where(tiny_alpha, 1.0, sin_half_alpha) ** 2 - 1.0
                )
            valid &= tiny_alpha | (curvature_term >= 0.0)
            inv_tan2 = one_minus_cg2 * curvature_term
            skip = (~tiny_alpha) & (inv_tan2 <= _EPS)
            with np.errstate(divide="ignore", invalid="ignore"):
                beta = np.where(
                    tiny_alpha,
                    0.0,
                    2.0 * np.arctan(1.0 / np.sqrt(np.where(inv_tan2 > 0, inv_tan2, 1.0))),
                )
            contrib = np.abs(np.tan(0.5 * beta))
            min_tan = np.where(skip, min_tan, np.minimum(min_tan, contrib))

        w = np.where(
            min_tan <= _EPS,
            _MAX_CURVATURE_WEIGHT,
            np.minimum(1.0 / np.where(min_tan <= _EPS, 1.0, min_tan), _MAX_CURVATURE_WEIGHT),
        )
        w = np.where(np.isfinite(min_tan), w, np.nan)  # no contributing plane
        out[sel] = np.where(valid, w, np.nan)

    return out


def curvature_weighted_cluster_point(edge_endpoints, evaluated, lattice):
    """Weight-averaged cluster vertex; None if no usable weights."""
    weighted = np.zeros(3)
    total = 0.0
    for u, v in edge_endpoints:
        p = edge_intersection_point(u, v, evaluated, lattice)
        if p is None:
            continue
        own = get_edge_owner(u, v)
        if own is None:
            continue
        owner, other, eid = own
        w = curvature_weight_for_edge(owner, other, eid, evaluated, lattice)
        if w is None:
            w = 1.0
        weighted += np.asarray(p) * w
        total += w
    if total <= _EPS:
        return None
    return tuple(weighted / total)
