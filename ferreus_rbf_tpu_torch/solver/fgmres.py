"""Flexible GMRES and the stationary Schwarz-DDM iteration.

Port of ``ferreus_rbf_tpu/solver/fgmres.py``, which follows
``ferreus_rbf/src/iterative_solvers.rs``: restarted FGMRES (Saad) with
right preconditioning, Givens rotations (LAPACK dlartg behaviour), and the
reference's stopping rules — Absolute -> max-norm of the initial residual as
beta and |g| directly; Relative -> l2 norm and |g|/beta. ``fgmres`` is the
host numpy version (modified Gram-Schmidt); the ``*_device`` solvers keep
the Krylov basis on the operator's device as tensors and move only the
Hessenberg column and norms to the host each iteration.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import scipy.linalg
import torch

from ..interpolant_config import FittingAccuracy, FittingAccuracyType
from ..progress import Progress, SolverIteration, emit, progress_from_rel
from ..utils.timing import count, record_event, to_device, traced_stage


def givens_rotation(f: float, g: float):
    """(c, s, r) with [c s; -s c] [f; g] = [r; 0] (dlartg semantics)."""
    safmin = np.finfo(np.float64).tiny
    safmax = np.finfo(np.float64).max
    rtmin = math.sqrt(safmin)
    rtmax = math.sqrt(safmax / 2.0)

    if g == 0.0:
        return 1.0, 0.0, f
    if f == 0.0:
        return 0.0, math.copysign(1.0, g), abs(g)

    f1, g1 = abs(f), abs(g)
    if rtmin <= f1 < rtmax and rtmin <= g1 < rtmax:
        r = math.copysign(math.sqrt(f * f + g * g), f)
        return f1 / abs(r), g / r, r
    u = min(max(max(f1, g1), safmin), safmax)
    fs, gs = f / u, g / u
    rs = math.copysign(math.sqrt(fs * fs + gs * gs), f)
    return abs(fs) / abs(rs), gs / rs, rs * u  # dlartg: s = gs / r, r signed as f


def fgmres(
    a: Callable[[np.ndarray], np.ndarray],
    b: np.ndarray,
    m: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    x0: Optional[np.ndarray] = None,
    max_outer_iterations: int = 20,
    max_inner_iterations: int = 5,
    tolerance: FittingAccuracy = None,
    callback: Optional[Progress] = None,
) -> np.ndarray:
    """Solve A x = b by restarted right-preconditioned flexible GMRES."""
    tolerance = tolerance or FittingAccuracy()
    b = np.asarray(b, np.float64).reshape(-1, 1)
    n = b.shape[0]
    x = np.zeros((n, 1)) if x0 is None else np.asarray(x0, np.float64).copy()

    r = b - a(x)
    if tolerance.tolerance_type == FittingAccuracyType.Absolute:
        beta = np.max(np.abs(r[:, 0]))
    else:
        beta = np.linalg.norm(r[:, 0])
    if beta == 0.0:
        return x

    iteration = 1
    mi = max_inner_iterations

    for _outer in range(max_outer_iterations):
        v = np.zeros((n, mi + 1))
        h = np.zeros((mi + 1, mi))
        z = np.zeros((n, mi))
        g = np.zeros(mi + 1)
        cs = np.zeros(mi)
        sn = np.zeros(mi)

        r_norm = np.linalg.norm(r)
        v[:, 0] = r[:, 0] / r_norm
        g[0] = r_norm

        for j in range(mi):
            w = m(v[:, j : j + 1]) if m is not None else v[:, j : j + 1].copy()
            z[:, j] = w[:, 0]
            wj = a(w)[:, 0]

            # modified Gram-Schmidt
            for i in range(j + 1):
                hij = float(v[:, i] @ wj)
                h[i, j] = hij
                wj = wj - v[:, i] * hij
            norm = np.linalg.norm(wj)
            h[j + 1, j] = norm

            for i in range(j):
                temp = cs[i] * h[i, j] + sn[i] * h[i + 1, j]
                h[i + 1, j] = -sn[i] * h[i, j] + cs[i] * h[i + 1, j]
                h[i, j] = temp

            c, s, _ = givens_rotation(h[j, j], h[j + 1, j])
            h[j, j] = c * h[j, j] + s * h[j + 1, j]
            h[j + 1, j] = 0.0
            temp = c * g[j] + s * g[j + 1]
            g[j + 1] = -s * g[j] + c * g[j + 1]
            g[j] = temp
            cs[j], sn[j] = c, s

            if norm != 0.0:
                v[:, j + 1] = wj / norm

            if tolerance.tolerance_type == FittingAccuracyType.Absolute:
                res_norm = abs(g[j + 1])
            else:
                res_norm = abs(g[j + 1]) / beta

            emit(
                callback,
                SolverIteration(
                    iter=iteration,
                    residual=res_norm,
                    progress=progress_from_rel(res_norm, beta, tolerance.tolerance),
                ),
            )

            if res_norm < tolerance.tolerance:
                x = x + _solution(h, g, z, j + 1)
                return x
            iteration += 1

        x = x + _solution(h, g, z, mi)
        r = b - a(x)
        if tolerance.tolerance_type == FittingAccuracyType.Absolute:
            res_norm = np.max(np.abs(r))
        else:
            res_norm = np.linalg.norm(r) / beta
        if res_norm < tolerance.tolerance:
            break

    return x


def _solution(h, g, z, i):
    y = scipy.linalg.solve_triangular(h[:i, :i], g[:i], lower=False)
    return (z[:, :i] @ y)[:, None]


def _norm(r, tolerance) -> float:
    """The reference's residual norm: max-norm (Absolute) or l2 (Relative)."""
    if tolerance.tolerance_type == FittingAccuracyType.Absolute:
        return float(r.abs().max())
    return float(torch.linalg.norm(r))


def fgmres_device(
    a,
    b,
    m=None,
    x0=None,
    max_outer_iterations: int = 20,
    max_inner_iterations: int = 5,
    tolerance: FittingAccuracy = None,
    callback: Optional[Progress] = None,
    stall_cycle_factor: float = None,
):
    """FGMRES on tensors: the semantics of :func:`fgmres`, with ``a``/``m``
    mapping (n, 1) tensors to tensors and the basis kept on their device.

    Orthogonalisation is classical Gram-Schmidt with one re-orthogonalisation
    pass (CGS2): two matmuls per iteration instead of sequential MGS
    updates, with MGS-like orthogonality.

    ``stall_cycle_factor`` (optional): return early when a full restart
    cycle fails to shrink the l2 residual below ``factor *`` its
    cycle-start value — used by the refined wrapper's f32 rounds, where an
    operator at its accuracy floor would otherwise grind out every restart.
    """
    tolerance = tolerance or FittingAccuracy()
    b = b.reshape(-1, 1)
    x = b.new_zeros(b.shape) if x0 is None else x0.clone()

    r = b - a(x)
    beta = _norm(r, tolerance)
    if beta == 0.0:
        return x

    iteration = 1
    mi = max_inner_iterations

    for _outer in range(max_outer_iterations):
        with traced_stage("fgmres_cycle"):
            h = np.zeros((mi + 1, mi))
            g = np.zeros(mi + 1)
            cs = np.zeros(mi)
            sn = np.zeros(mi)

            r_norm = float(torch.linalg.norm(r))
            v = [r[:, 0] / r_norm]
            z = []
            g[0] = r_norm

            breakdown_at = None
            for j in range(mi):
                w = m(v[j][:, None]) if m is not None else v[j][:, None]
                z.append(w[:, 0])
                wj = a(w)[:, 0]

                vmat = torch.stack(v, dim=1)  # (n, j+1)
                hcol1 = vmat.T @ wj
                wj = wj - vmat @ hcol1
                hcol2 = vmat.T @ wj
                wj = wj - vmat @ hcol2
                norm = float(torch.linalg.norm(wj))
                h[: j + 1, j] = (hcol1 + hcol2).cpu().numpy()
                h[j + 1, j] = norm

                for i in range(j):
                    temp = cs[i] * h[i, j] + sn[i] * h[i + 1, j]
                    h[i + 1, j] = -sn[i] * h[i, j] + cs[i] * h[i + 1, j]
                    h[i, j] = temp

                c, s, _ = givens_rotation(h[j, j], h[j + 1, j])
                h[j, j] = c * h[j, j] + s * h[j + 1, j]
                h[j + 1, j] = 0.0
                temp = c * g[j] + s * g[j + 1]
                g[j + 1] = -s * g[j] + c * g[j + 1]
                g[j] = temp
                cs[j], sn[j] = c, s

                v.append(wj / norm if norm != 0.0 else wj)

                if tolerance.tolerance_type == FittingAccuracyType.Absolute:
                    res_norm = abs(g[j + 1])
                else:
                    res_norm = abs(g[j + 1]) / beta
                emit(
                    callback,
                    SolverIteration(
                        iter=iteration,
                        residual=res_norm,
                        progress=progress_from_rel(res_norm, beta, tolerance.tolerance),
                    ),
                )
                count("fgmres_iters")
                if res_norm < tolerance.tolerance:
                    breakdown_at = j + 1
                    break
                iteration += 1

            i = breakdown_at if breakdown_at is not None else mi
            y = scipy.linalg.solve_triangular(h[:i, :i], g[:i], lower=False)
            zmat = torch.stack(z[:i], dim=1)
            x = x + (zmat @ to_device(y, zmat.device, zmat.dtype))[:, None]
            if breakdown_at is not None:
                return x

            r = b - a(x)
            r_l2 = float(torch.linalg.norm(r))
            if tolerance.tolerance_type == FittingAccuracyType.Absolute:
                res_norm = float(r.abs().max())
            else:
                res_norm = r_l2 / beta
            if res_norm < tolerance.tolerance:
                break
            # r_norm is the cycle-start l2 residual (set before the inner loop)
            if stall_cycle_factor is not None and r_l2 > stall_cycle_factor * r_norm:
                break

    return x


def refined_fgmres_device(
    a_f64,
    a_f32,
    b,
    m=None,
    max_outer_iterations: int = 20,
    max_inner_iterations: int = 5,
    tolerance: FittingAccuracy = None,
    callback: Optional[Progress] = None,
    max_refinements: int = 8,
    history: Optional[list] = None,
):
    """Mixed-precision FGMRES with f64 iterative refinement.

    The inner Krylov iterations run with the float32 operator ``a_f32``
    (whose ~1e-6 relative error caps what one inner solve can achieve);
    the outer loop computes f64 residuals with ``a_f64`` and re-solves for
    the correction — classical iterative refinement. Stopping is measured
    on the f64 residual with the reference's semantics, so the converged
    solution matches a pure-f64 solve at the requested tolerance.

    Refinement contracts only while kappa(A) * eps_inner < 1. When a round
    fails to contract (stiff systems, e.g. 2D thin-plate splines), the
    inner operator escalates to ``a_f64``; if it still fails to contract,
    the best iterate seen is returned. ``history`` (optional list) receives
    one dict per round: ``{"round", "residual", "inner_tier"}``.
    """
    tolerance = tolerance or FittingAccuracy()
    b = b.reshape(-1, 1)
    x = torch.zeros_like(b)

    beta = _norm(b, tolerance)
    if beta == 0.0:
        return x

    def residual(x):
        r = b - a_f64(x)
        res = _norm(r, tolerance)
        return r, res if tolerance.tolerance_type == FittingAccuracyType.Absolute else res / beta

    inner_drop = 1e-5  # what one f32 inner solve reliably achieves
    inner_op = a_f32
    escalated = False
    prev_res = np.inf
    best_res = np.inf
    best_x = x

    for _refine in range(max_refinements):
        r, res = residual(x)
        if res < best_res:
            best_res = res
            best_x = x
        if res < tolerance.tolerance:
            break
        if res > 0.5 * prev_res:
            if escalated:
                break  # not contracting even with the f64 inner operator
            inner_op = a_f64
            escalated = True
            x = best_x  # restart refinement from the best point
            r, res = residual(x)
        prev_res = res

        # inner relative tolerance: enough to finish if possible, else the
        # f32 floor
        if tolerance.tolerance_type == FittingAccuracyType.Absolute:
            remaining = tolerance.tolerance / max(float(torch.linalg.norm(r)), 1e-300)
        else:
            remaining = tolerance.tolerance / max(res, 1e-300)
        inner_tol = max(inner_drop if not escalated else 1e-9, 0.3 * remaining)
        event = {"round": _refine, "residual": res, "inner_tier": "f64" if escalated else "f32"}
        if history is not None:
            history.append(event)
        record_event("refine_round", event)
        dx = fgmres_device(
            inner_op,
            r,
            m=m,
            max_outer_iterations=max_outer_iterations,
            max_inner_iterations=max_inner_iterations,
            tolerance=FittingAccuracy(inner_tol, FittingAccuracyType.Relative),
            callback=callback,
            stall_cycle_factor=None if escalated else 0.5,
        )
        x = x + dx

    # the last update may have overshot on a stiff system: return the best
    # verified iterate
    _, res = residual(x)
    final = min(res, best_res)
    record_event("solve_done", {
        "residual": final,
        "tolerance": tolerance.tolerance,
        "converged": bool(final < tolerance.tolerance),
        "escalated": escalated,
    })
    return x if res <= best_res else best_x


def schwarz_ddm_solver(
    matvec: Callable[[np.ndarray], np.ndarray],
    rhs: np.ndarray,
    m: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    max_iterations: int = 100,
    tolerance: FittingAccuracy = None,
    callback: Optional[Progress] = None,
) -> np.ndarray:
    """Stationary iteration s += M(r); r = b - A s on host arrays
    (``iterative_solvers.rs:234``); returns s, (n, 1)."""
    tolerance = tolerance or FittingAccuracy()
    rhs = np.asarray(rhs, np.float64).reshape(-1, 1)
    rg = rhs.copy()
    sg = np.zeros_like(rhs)
    beta = _norm_host(rg, tolerance)
    res_norm = beta
    iteration = 0
    if m is None:
        return sg

    while res_norm > tolerance.tolerance and iteration < max_iterations:
        sg = sg + m(rg)
        rg = rhs - matvec(sg)
        res_norm = _norm_host(rg, tolerance)
        if tolerance.tolerance_type == FittingAccuracyType.Relative:
            res_norm /= beta
        iteration += 1
        emit(
            callback,
            SolverIteration(
                iter=iteration,
                residual=res_norm,
                progress=progress_from_rel(res_norm, beta, tolerance.tolerance),
            ),
        )
    return sg


def _norm_host(r: np.ndarray, tolerance) -> float:
    if tolerance.tolerance_type == FittingAccuracyType.Absolute:
        return float(np.max(np.abs(r)))
    return float(np.linalg.norm(r))


def schwarz_ddm_solver_device(
    matvec,
    rhs,
    m=None,
    max_iterations: int = 100,
    tolerance: FittingAccuracy = None,
    callback: Optional[Progress] = None,
):
    """Stationary iteration s += M(r); r = b - A s, on tensors."""
    tolerance = tolerance or FittingAccuracy()
    rhs = rhs.reshape(-1, 1)
    rg = rhs
    sg = torch.zeros_like(rhs)
    beta = _norm(rg, tolerance)
    res_norm = beta
    iteration = 0
    if m is None:
        return sg

    while res_norm > tolerance.tolerance and iteration < max_iterations:
        sg = sg + m(rg)
        rg = rhs - matvec(sg)
        res_norm = _norm(rg, tolerance)
        if tolerance.tolerance_type == FittingAccuracyType.Relative:
            res_norm /= beta
        iteration += 1
        emit(
            callback,
            SolverIteration(
                iter=iteration,
                residual=res_norm,
                progress=progress_from_rel(res_norm, beta, tolerance.tolerance),
            ),
        )
    record_event("solve_done", {
        "residual": res_norm,
        "tolerance": tolerance.tolerance,
        "converged": bool(res_norm < tolerance.tolerance),
    })
    return sg
