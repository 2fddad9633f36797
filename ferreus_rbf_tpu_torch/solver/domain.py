"""One overlapping subproblem of the domain-decomposition preconditioner.

Maps ``ferreus_rbf/src/domain.rs``. A ``Domain`` owns a subset of the global
node set and factorises its local RBF system once at setup time. With a
polynomial drift present, the system is cast into Beatson's strictly positive
definite ``Q^T A Q`` form (Beatson/Light/Billings 2000, section 3), with
Cherrie's rank-revealing-QR "special point" selection handling the
non-unisolvent case (Cherrie 2000, section 1.2) — exactly the reference's
procedure at ``domain.rs:153-383``.

Copy of ``ferreus_rbf_tpu/solver/domain.py``: all pivoted-QR combinatorics
and this domain's Cholesky factorisation run on the host in f64
numpy/scipy. The fine Schwarz levels factor their domains in batches on the
device (``ddm.py``); a ``Domain`` serves the naive direct fit and the
coarse level.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from ..interpolant_config import InterpolantSettings
from ..ops.dense import get_a_matrix_symmetric_solver
from ..ops.polynomials import (
    evaluate_lagrange_polynomials,
    evaluate_monomials,
    get_lagrange_coefficients,
)
from ..utils.common import get_cheb_cube_scaling_factors

_RANK_TOL = 1e-10


class Coefficients:
    """Solved coefficients: point (N, nrhs) + optional polynomial (B, nrhs)."""

    def __init__(self, point_coefficients: np.ndarray, poly_coefficients=None):
        self.point_coefficients = np.asarray(point_coefficients, np.float64)
        self.poly_coefficients = (
            None if poly_coefficients is None else np.asarray(poly_coefficients, np.float64)
        )

    def to_dict(self) -> dict:
        return {
            "point_coefficients": self.point_coefficients.tolist(),
            "poly_coefficients": None
            if self.poly_coefficients is None
            else self.poly_coefficients.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Coefficients":
        poly = d.get("poly_coefficients")
        return cls(np.asarray(d["point_coefficients"], np.float64),
                   None if poly is None else np.asarray(poly, np.float64))


def _rank_from_pivoted_qr(r: np.ndarray) -> int:
    """Effective rank: number of |R_ii| above 1e-10 * |R_00|."""
    diag = np.abs(np.diag(r))
    if diag.size == 0:
        return 0
    return int(np.sum(diag > _RANK_TOL * diag[0]))


class _CholeskyOrLU:
    """SPD Cholesky with automatic fallback for numerically indefinite systems.

    Mirrors ``DomainSolver``'s LLT -> Bunch-Kaufman fallback
    (``domain.rs:49-84``); scipy's LDL factor is used as the symmetric
    -indefinite fallback.
    """

    def __init__(self, a: np.ndarray):
        self.n = a.shape[0]
        try:
            self._cho = scipy.linalg.cho_factor(a, lower=True, check_finite=False)
            self._kind = "llt"
        except scipy.linalg.LinAlgError:
            lu, d, perm = scipy.linalg.ldl(a, lower=True)
            self._ldl = (lu, d, perm)
            self._kind = "ldl"

    @property
    def kind(self) -> str:
        return self._kind

    def lower_factor(self) -> np.ndarray:
        """Dense lower Cholesky factor (for device-side batched solves)."""
        if self._kind != "llt":
            raise ValueError("lower_factor only available for SPD factorisations")
        c, lower = self._cho
        return np.tril(c) if lower else np.triu(c).T

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        if self._kind == "llt":
            return scipy.linalg.cho_solve(self._cho, rhs, check_finite=False)
        lu, d, perm = self._ldl
        # A = (P L) D (P L)^T with lu already permuted rows; solve stagewise.
        pl = lu[perm, :]
        y = scipy.linalg.solve_triangular(pl, rhs[perm], lower=True, unit_diagonal=True)
        z = np.linalg.solve(d, y)
        x_perm = scipy.linalg.solve_triangular(pl.T, z, lower=False, unit_diagonal=True)
        x = np.empty_like(x_perm)
        x[perm] = x_perm
        return x


class Domain:
    """A single overlapping domain (``domain.rs:87-468``)."""

    def __init__(self, overlapping_point_indices):
        self.overlapping_point_indices = np.asarray(overlapping_point_indices, np.int64)
        self.internal_points_mask = np.zeros(0, dtype=bool)
        self.extents = np.zeros(0)
        self.solve_for_poly = False
        self._solver: _CholeskyOrLU | None = None
        self._special_point_lu = None
        self.q_matrix_top: np.ndarray | None = None
        self.a_special_points_rows: np.ndarray | None = None
        self.special_point_indices: np.ndarray | None = None

    # -- factorisation ----------------------------------------------------
    def factorise(
        self,
        source_points: np.ndarray,
        interpolant_settings: InterpolantSettings,
        solve_for_poly: bool,
        global_trend=None,
    ) -> None:
        """Build and factorise the local system (QTAQ when drift present).

        Under a ``global_trend`` the points are the transformed ones: the
        monomials are taken on the inverse-transformed points, while the
        Chebyshev scaling factors stay those of the transformed points, as
        in the JAX package."""
        pts = np.asarray(source_points, np.float64)
        kparams = interpolant_settings.kernel_params()
        nugget = interpolant_settings.nugget
        domain_points = pts[self.overlapping_point_indices]

        if interpolant_settings.basis_size != 0:
            translation, scale = get_cheb_cube_scaling_factors(domain_points)
            monomial_points = (
                global_trend.inverse_transform_points(domain_points)
                if global_trend is not None
                else domain_points
            )
            monomials = evaluate_monomials(
                monomial_points,
                interpolant_settings.polynomial_degree,
                interpolant_settings.basis_size,
                translation,
                scale,
            )

            # Column-pivoted QR -> linearly independent monomial columns.
            _, rc, piv = scipy.linalg.qr(monomials, mode="economic", pivoting=True)
            rank = _rank_from_pivoted_qr(rc)
            unisolvent_columns = np.sort(piv[:rank])
            full_rank_monomials = monomials[:, unisolvent_columns]

            # Rank-revealing QR of the transpose selects the "special points":
            # well separated in monomial feature space, a stable unisolvent set.
            _, _, piv2 = scipy.linalg.qr(full_rank_monomials.T, mode="economic", pivoting=True)
            special_local = np.sort(piv2[:rank])

            is_special = np.zeros(domain_points.shape[0], dtype=bool)
            is_special[special_local] = True
            non_special_local = np.nonzero(~is_special)[0]

            special_monomials = full_rank_monomials[special_local]
            non_special_monomials = full_rank_monomials[non_special_local]

            # Reorder this domain so the special points come first; keep the
            # internal mask aligned.
            order = np.concatenate([special_local, non_special_local])
            self.overlapping_point_indices = self.overlapping_point_indices[order]
            self.internal_points_mask = self.internal_points_mask[order]
            self.special_point_indices = np.arange(rank)

            sorted_points = pts[self.overlapping_point_indices]
            a_matrix = np.asarray(
                get_a_matrix_symmetric_solver(sorted_points, kparams, nugget, xp=np)
            )

            m = domain_points.shape[0] - rank

            # Q = [[Q_top], [I_m]] with Q_top = -(L(non_special))^T where L is
            # the Lagrange basis of the special points; P^T Q = 0 by
            # construction (Beatson's "possible choice for Q").
            lagrange = get_lagrange_coefficients(special_monomials)
            q_top = -evaluate_lagrange_polynomials(non_special_monomials, lagrange).T

            a11 = a_matrix[:rank, :rank]
            a12 = a_matrix[:rank, rank:]
            a21 = a_matrix[rank:, :rank]
            a22 = a_matrix[rank:, rank:]
            lhs = q_top.T @ (a11 @ q_top) + q_top.T @ a12 + a21 @ q_top + a22

            self.q_matrix_top = q_top
            if solve_for_poly:
                self.solve_for_poly = True
                self.a_special_points_rows = a_matrix[:rank, :]
                self._special_point_lu = scipy.linalg.lu_factor(special_monomials)
        else:
            domain_points = pts[self.overlapping_point_indices]
            lhs = np.asarray(get_a_matrix_symmetric_solver(domain_points, kparams, nugget, xp=np))

        self._solver = _CholeskyOrLU(lhs)

    # -- solve ------------------------------------------------------------
    def solve(self, source_values: np.ndarray) -> Coefficients:
        """Local solve against the full global value vector."""
        values = np.asarray(source_values, np.float64)
        if values.ndim == 1:
            values = values[:, None]
        return self.solve_gathered(values[self.overlapping_point_indices])

    def solve_gathered(self, domain_values: np.ndarray) -> Coefficients:
        """Local solve: rhs projection through Q^T, Cholesky, expand lambda = Q gamma.

        Optionally recovers the polynomial tail by interpolating the residual
        at the special points (``domain.rs:393-467``). ``domain_values`` are
        the rows already gathered at ``overlapping_point_indices``.
        """
        domain_values = np.asarray(domain_values, np.float64)
        if domain_values.ndim == 1:
            domain_values = domain_values[:, None]
        n_total = self.overlapping_point_indices.shape[0]
        nrhs = domain_values.shape[1]

        if self.q_matrix_top is not None:
            k = self.special_point_indices.shape[0]
            rhs = self.q_matrix_top.T @ domain_values[:k] + domain_values[k:]
        else:
            k = 0
            rhs = domain_values

        gamma = self._solver.solve(rhs)

        point_coefficients = np.zeros((n_total, nrhs))
        if self.q_matrix_top is not None:
            point_coefficients[:k] = self.q_matrix_top @ gamma
            point_coefficients[k:] = gamma
        else:
            point_coefficients[:] = gamma

        poly_coefficients = None
        if self.solve_for_poly:
            d_special = domain_values[:k]
            residual = d_special - self.a_special_points_rows @ point_coefficients
            poly_coefficients = scipy.linalg.lu_solve(self._special_point_lu, residual)

        return Coefficients(point_coefficients, poly_coefficients)

    # -- device extraction -------------------------------------------------
    @property
    def num_points(self) -> int:
        return int(self.overlapping_point_indices.shape[0])

    @property
    def num_special(self) -> int:
        return 0 if self.special_point_indices is None else int(self.special_point_indices.shape[0])

    def cholesky_lower(self) -> np.ndarray:
        """Lower factor of the (QTAQ-reduced) system for batched device solves."""
        return self._solver.lower_factor()

    @property
    def is_spd(self) -> bool:
        return self._solver is not None and self._solver.kind == "llt"
