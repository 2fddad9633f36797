"""Iterative fit orchestration: FMM matvec + DDM/Schwarz + FGMRES.

Port of ``ferreus_rbf_tpu/solver/iterative.py`` (the large-N branch of the
reference's ``setup_and_solve``): the action of [[A + nu*I, P], [P^T, 0]]
is computed as (FMM matvec at the source points) + nugget*w + P c, with the
constraint block handled by the preconditioner's orthogonalisation; the
system is solved per RHS column with restarted FGMRES (20 x 5, mixed
precision with f64 refinement by default) or the stationary DDM iteration,
both right-preconditioned by the multilevel Schwarz hierarchy.

FGMRES runs its restart cycles on the device (``solver/fused.py``, one
host pull per cycle, each cycle a CUDA graph on the card) unless
``FERREUS_RBF_TPU_FUSED`` is "0" or one of ``FusedSystem``'s gates turns
the system away; then, and for the DDM iteration, the solver loop runs on
the host. Either way vectors, the FMM passes, the batched Schwarz leaf
solves and the polynomial block stay on ``device``.
"""

from __future__ import annotations

import os
import types

import numpy as np
import torch

from ..config import Solvers
from ..ops.fmm.api import FmmTree
from ..ops.polynomials import evaluate_monomials
from ..utils.timing import global_tracer, record_event, to_device, traced_stage
from . import fgmres as solvers
from . import fused as fused_mod
from .ddm import DDMTree
from .domain import Coefficients
from .schwarz import schwarz_preconditioner


class DeviceSystem:
    """The saddle-point operator + Schwarz preconditioner on one device."""

    def __init__(self, rbfi):
        points = rbfi.points
        settings = rbfi.interpolant_settings
        params = rbfi.params
        dev = rbfi.device
        self.n = points.shape[0]
        self.m = settings.basis_size
        self.settings = settings

        with traced_stage("fmm_tree_build"):
            self.fmm_tree = FmmTree(
                points,
                params.fmm_params.interpolation_order,
                settings.kernel_params(),
                adaptive_tree=True,
                sparse=True,
                params=params.fmm_params,
                device=dev,
            )
        with traced_stage("prepare_targets_all"):
            self.fmm_tree.prepare_targets(points, "__all__")

        self.monomial_dev = None
        self.ortho_poly = None
        if self.m != 0:
            # under a trend the drift lives in the input space: monomials of
            # the inverse-transformed points, scaled by the fit's factors
            trend = rbfi.global_trend
            monomials = evaluate_monomials(
                trend.inverse_transform_points(points) if trend is not None else points,
                settings.polynomial_degree, self.m,
                rbfi.translation_factor, rbfi.scale_factor,
            )
            self.monomial_dev = to_device(monomials, dev)
            self.ortho_poly = to_device(np.linalg.qr(monomials)[0], dev)

        factor_dtype = torch.float32 if params.precond_factor_dtype == "f32" else torch.float64
        with traced_stage("ddm_tree_build"):
            self.ddm_tree = DDMTree(
                points, settings, params.ddm_params, factor_dtype=factor_dtype, device=dev,
                global_trend=rbfi.global_trend,
            )

        # per-level target binnings for the restricted matvecs the Schwarz
        # sweep issues (level 0's active set is all points: reuse "__all__")
        with traced_stage("prepare_targets_levels"):
            self._level_idx = {}
            cache = self.fmm_tree._target_cache
            for i, level in enumerate(self.ddm_tree.levels[:-1]):
                idx = level.point_indices
                if idx.size == self.n and np.array_equal(idx, np.arange(self.n)):
                    cache[("lvl", i)] = cache["__all__"]
                else:
                    self.fmm_tree.prepare_targets(points[idx], ("lvl", i))
                self._level_idx[i] = to_device(idx, dev)
            coarse_idx = self.ddm_tree.levels[-1].point_indices
            self.fmm_tree.prepare_targets(points[coarse_idx], ("lvl", "coarse"))
            self._level_idx["coarse"] = to_device(coarse_idx, dev)

        self.nugget = settings.nugget

    # -- operators ---------------------------------------------------------
    def matvec(self, w, precision="f64"):
        """Full system operator on an (n + m, nrhs) tensor."""
        with traced_stage("fmm_matvec"):
            wp = w[: self.n]
            top = self.fmm_tree.evaluate_device(wp, "__all__", precision=precision)
            top = top + self.nugget * wp
            if self.monomial_dev is None:
                return top
            top = top + self.monomial_dev @ w[self.n :]
            return torch.cat([top, w.new_zeros((self.m, w.shape[1]))])

    def matvec_f32(self, w):
        return self.matvec(w, precision="f32")

    def matvec_partial(self, w, level_key, precision="f32"):
        """Operator restricted to one Schwarz level's rows (f32: a flexible
        Krylov method tolerates an inexact preconditioner)."""
        wp = w[: self.n]
        idx = self._level_idx[level_key]
        rows = self.fmm_tree.evaluate_device(wp, ("lvl", level_key), precision=precision)
        rows = rows + self.nugget * wp[idx]
        if self.monomial_dev is not None:
            rows = rows + self.monomial_dev[idx] @ w[self.n :]
        out = torch.zeros_like(w)
        out[idx] = rows
        return out

    def precon(self, residuals):
        return schwarz_preconditioner(
            residuals, self.ddm_tree, self.matvec_partial, self.settings, self.ortho_poly
        )


def iterative_fit(rbfi):
    """Fit ``rbfi`` (an RBFInterpolator mid-construction) iteratively."""
    values = rbfi.point_values
    settings = rbfi.interpolant_settings
    params = rbfi.params
    num_cols = values.shape[1]

    with traced_stage("system_setup"):
        system = DeviceSystem(rbfi)
    n, m = system.n, system.m

    rhs = values
    if m != 0:
        rhs = np.concatenate([values, np.zeros((m, num_cols))])

    point_coefficients = np.zeros((n, num_cols))
    poly_coefficients = np.zeros((m, num_cols)) if m else None

    # Device restart cycles (one host pull per cycle) unless the variable
    # turns them off or a gate keeps the host loop (the JAX package's rule)
    fs = None
    if params.solver_type == Solvers.FGMRES and os.environ.get(
            "FERREUS_RBF_TPU_FUSED", "1") not in ("0", "false", "False"):
        with traced_stage("fused_system_build"):
            fs = fused_mod.FusedSystem(system)
        record_event("fused_system", {"ok": fs.ok, "gate": fs.gate,
                                      "factor_bytes": fs.factor_bytes})
        if not fs.ok:
            fs = None

    for col in range(num_cols):
        b = to_device(rhs[:, col : col + 1], rbfi.device)
        with traced_stage("solve_column"):
            sol = _solve_one_column(rbfi, system, fs, b, settings, params).cpu().numpy()
        point_coefficients[:, col] = sol[:n, 0]
        if m:
            poly_coefficients[:, col] = sol[n:, 0]
    if fs is not None:
        record_event("fused_solve", dict(fs.stats))

    # One-M-step preconditioner diagnostic, stashed on the interpolator and
    # not run inline, so the fit's wall-clock stays raw. One preconditioner
    # application and two matvecs: the one-M-step residual at both tiers
    # (is M weak, or is A inexact at this tier?) and the f32-vs-f64
    # operator discrepancy on z = M b. The port's f64 tier is plain f64
    # (the JAX package's "f64grade" key is kept for its readers). It keeps
    # the fit's host inputs, not its device system (at 1M points tens of
    # GB of tables and factors), and rebuilds the system when called.
    fit_state = types.SimpleNamespace(
        points=rbfi.points, interpolant_settings=settings, params=params,
        device=rbfi.device, translation_factor=rbfi.translation_factor,
        scale_factor=rbfi.scale_factor, global_trend=rbfi.global_trend)

    def _m_step_diagnostic(_state=fit_state, _rhs=rhs):
        system = DeviceSystem(_state)
        b0 = to_device(_rhs[:, :1], _state.device)
        nb = max(float(torch.linalg.norm(b0)), 1e-300)
        z = system.precon(b0)
        az32 = system.matvec(z, precision="f32")
        az64 = system.matvec(z)
        disc = float(torch.linalg.norm(az32 - az64)) / max(float(torch.linalg.norm(az64)),
                                                            1e-300)
        out = {
            "one_m_step_residual_f32": float(torch.linalg.norm(b0 - az32)) / nb,
            "one_m_step_residual_f64grade": float(torch.linalg.norm(b0 - az64)) / nb,
            "matvec_tier_discrepancy_on_Mb": disc,
        }
        if global_tracer() is not None:
            record_event("m_step", out)
        return out

    rbfi.m_step_diagnostic = _m_step_diagnostic
    return Coefficients(point_coefficients, poly_coefficients)


def _solve_one_column(rbfi, system, fs, b, settings, params):
    if fs is not None:
        kw = dict(max_outer_iterations=20, max_inner_iterations=5,
                  tolerance=settings.fitting_accuracy, callback=rbfi.progress_callback)
        if params.mixed_precision:
            return fused_mod.refined_fgmres_fused(fs, b, **kw)
        return fused_mod.fgmres_fused(fs, b, prec=fs.f64_prec, **kw)
    kw = dict(m=system.precon, tolerance=settings.fitting_accuracy,
              callback=rbfi.progress_callback)
    if params.solver_type == Solvers.FGMRES:
        if params.mixed_precision:
            return solvers.refined_fgmres_device(
                system.matvec, system.matvec_f32, b,
                max_outer_iterations=20, max_inner_iterations=5, **kw,
            )
        return solvers.fgmres_device(
            system.matvec, b, max_outer_iterations=20, max_inner_iterations=5, **kw,
        )
    return solvers.schwarz_ddm_solver_device(system.matvec, b, max_iterations=100, **kw)
