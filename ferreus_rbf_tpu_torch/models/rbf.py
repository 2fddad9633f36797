"""The RBF interpolator: fit and evaluate.

Port of ``ferreus_rbf_tpu/models/rbf.py``. The fit pipeline is:

1. optional kernel-aware duplicate removal,
2. optional global-trend transform of the points (an affine map pinned at
   their mean; the drift stays in the input space),
3. ``N < naive_solve_threshold`` -> one direct ``Domain`` factor + solve on
   the host; otherwise FGMRES (restart 20 x 5) or the stationary DDM
   iteration, preconditioned by the multilevel Schwarz hierarchy over FMM
   matvecs on ``device``.

Evaluation builds an FMM tree on ``device`` over the union of source and
target extents, with or without target gradients; ``build_evaluator``
keeps one tree with its locals for the leaf-only ``evaluate_targets*``
calls, and ``build_isosurface(s)`` runs regularised marching tetrahedra
(``rmt``) against it. Under a trend the trees hold transformed points
and extents, and gradients come back in the input space (through B^T).

``save_model``/``load_model`` read and write the JAX package's
``ferreus_rbf.json`` v1 envelope with the same keys, so a model saved by
either package loads in the other. ``device`` defaults to the CUDA card;
pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import scipy.optimize
import scipy.spatial

from .. import progress as progress_mod
from ..config import Params
from ..interpolant_config import InterpolantSettings
from ..ops import kernels as kernels_mod
from ..ops import polynomials
from ..ops.fmm.api import FmmTree, resolve_device
from ..parallel.sharding import active_mesh
from ..progress import DuplicatesRemoved, Message, Progress
from ..solver.domain import Coefficients, Domain
from ..utils import common
from ..utils.timing import muted_events, traced_stage
from .global_trend import GlobalTrend, GlobalTrendTransform

JSON_FORMAT_NAME = "ferreus_rbf.json"
JSON_VERSION = 1


def duplicate_cutoff_distance(h_ref: float, interpolant_settings: InterpolantSettings) -> float:
    """Kernel-aware duplicate cutoff: the radius where |phi(r) - phi(0)|
    rises above machine epsilon relative to |phi(h_ref) - phi(0)|."""
    kernel = kernels_mod.make_kernel(interpolant_settings.kernel_params(), xp=np)

    def phi(r):
        return float(kernel.phi(np.asarray([r]))[0])

    phi0 = phi(0.0)
    target = np.finfo(np.float64).eps * abs(phi(h_ref) - phi0)

    def resid(r):
        return abs(phi(r) - phi0) - target

    if resid(h_ref) <= 0.0:
        return h_ref
    try:
        return scipy.optimize.brentq(resid, 0.0, h_ref, rtol=1e-12)
    except ValueError:
        return h_ref


def remove_duplicates(points: np.ndarray, interpolant_settings: InterpolantSettings) -> np.ndarray:
    """Indices of unique points under the kernel-aware infinity-norm radius
    (greedy first-in-group-wins grouping via a KD-tree)."""
    pts = np.asarray(points, np.float64)
    extents = common.get_pointarray_extents(pts)
    d = pts.shape[1]
    tol = duplicate_cutoff_distance(float(np.max(np.abs(extents[d:] - extents[:d]))),
                                    interpolant_settings)
    groups = scipy.spatial.cKDTree(pts).query_ball_point(pts, tol, p=np.inf, workers=-1)
    visited = np.zeros(pts.shape[0], dtype=bool)
    unique = []
    for i in range(pts.shape[0]):
        if visited[i]:
            continue
        unique.append(i)
        visited[groups[i]] = True
    return np.asarray(unique, np.int64)


def _scalar_or_matrix(values: np.ndarray) -> np.ndarray:
    """Single-column value blocks come back 1-D, like the reference."""
    v = np.asarray(values)
    return v[:, 0] if v.ndim == 2 and v.shape[1] == 1 else v


class RBFInterpolator:
    """Radial basis function interpolator (fitted on construction).

    ``device`` names the torch device the iterative fit and the FMM
    evaluations run on; by default the CUDA card (without one, pass
    ``device="cpu"``). Built under ``parallel.use_mesh`` the fit is sharded
    over the mesh's ranks, and only rank 0 emits progress messages and
    tracer events.
    """

    def __init__(
        self,
        points,
        values,
        interpolant_settings: InterpolantSettings,
        params: Optional[Params] = None,
        global_trend: Optional[GlobalTrend] = None,
        progress_callback: Optional[Progress] = None,
        device=None,
        _skip_solve: bool = False,
    ):
        device = resolve_device(device)
        mesh = active_mesh()
        quiet = mesh is not None and mesh.rank != 0  # one stream: rank 0's
        if quiet:
            progress_callback = None
        span = contextlib.nullcontext() if _skip_solve else traced_stage("fit")
        with muted_events(quiet), span:
            solver_start = time.perf_counter()
            points = np.asarray(points, np.float64)
            values = np.asarray(values, np.float64)
            if values.ndim == 1:
                values = values[:, None]
            dimensions = points.shape[1]
            if not 1 <= dimensions <= 3:
                raise ValueError(f"Unsupported number of dimensions: {dimensions}")

            settings = dataclasses.replace(interpolant_settings)
            settings.set_basis_size(dimensions)
            self.interpolant_settings = settings
            self.params = (params if params is not None
                           else Params.new_defaults(settings.kernel_type))
            self.progress_callback = progress_callback
            self.device = device

            if self.params.test_unique and not _skip_solve:
                idx = remove_duplicates(points, settings)
                if idx.shape[0] != points.shape[0]:
                    progress_mod.emit(
                        progress_callback,
                        DuplicatesRemoved(num_duplicates=points.shape[0] - idx.shape[0]),
                    )
                    points = points[idx]
                    values = values[idx]

            self.global_trend = None
            if global_trend is not None:
                self.global_trend = GlobalTrendTransform(points.mean(axis=0), global_trend)
                points = self.global_trend.transform_points(points)

            self.points = points
            self.point_values = values
            self.coefficients = Coefficients(np.zeros((0, values.shape[1])))
            self.translation_factor = np.zeros(0)
            self.scale_factor = np.ones(0)
            self._evaluator = None

            if not _skip_solve:
                self._setup_and_solve()
                duration = time.perf_counter() - solver_start
                progress_mod.emit(
                    progress_callback,
                    Message(
                        message=(
                            f"Took {duration:.3f}s to solve RBF for {self.points.shape[0]} points "
                            f"using the following settings:\n"
                            f"Kernel: {settings.kernel_type.value}, "
                            f"Polynomial degree: {settings.polynomial_degree}\n"
                            f"Fitting accuracy: {settings.fitting_accuracy.tolerance}, "
                            f"Tolerance type: {settings.fitting_accuracy.tolerance_type.value}"
                        )
                    ),
                )

    @classmethod
    def from_numpy_state(
        cls,
        points,
        values,
        settings: InterpolantSettings,
        point_coefficients,
        poly_coefficients,
        translation_factor,
        scale_factor,
        params: Optional[Params] = None,
        device=None,
        global_trend=None,
    ) -> "RBFInterpolator":
        """A fitted interpolator from another fit's arrays, without solving:
        the way a JAX package model comes across (its ``points``,
        ``coefficients``, scaling factors and, under a trend, its
        ``global_trend``, a ``GlobalTrendTransform`` or its ``to_dict()``)."""
        model = cls(points, values, settings, params=params, device=device, _skip_solve=True)
        if isinstance(global_trend, dict):
            global_trend = GlobalTrendTransform.from_dict(global_trend)
        model.global_trend = global_trend
        model.coefficients = Coefficients(
            np.asarray(point_coefficients, np.float64).reshape(model.points.shape[0], -1),
            poly_coefficients,
        )
        model.translation_factor = np.asarray(translation_factor, np.float64)
        model.scale_factor = np.asarray(scale_factor, np.float64)
        return model

    # ------------------------------------------------------------------ fit
    def _setup_and_solve(self) -> None:
        num_points = self.points.shape[0]
        if self.interpolant_settings.basis_size != 0:
            self.translation_factor, self.scale_factor = common.get_cheb_cube_scaling_factors(
                self.points
            )
        if num_points < self.params.naive_solve_threshold:
            domain = Domain(np.arange(num_points))
            domain.internal_points_mask = np.ones(num_points, dtype=bool)
            domain.factorise(self.points, self.interpolant_settings, True, self.global_trend)
            sol = domain.solve(self.point_values)
            point_coefficients = np.zeros_like(sol.point_coefficients)
            point_coefficients[domain.overlapping_point_indices] = sol.point_coefficients
            self.coefficients = Coefficients(point_coefficients, sol.poly_coefficients)
        else:
            from ..solver.iterative import iterative_fit

            self.coefficients = iterative_fit(self)

        if self.global_trend is not None:
            self.points = self.global_trend.inverse_transform_points(self.points)

    # ----------------------------------------------------------- properties
    @property
    def source_points(self) -> np.ndarray:
        return self.points

    @property
    def source_values(self) -> np.ndarray:
        return self.point_values

    # ----------------------------------------------------------- evaluation
    def _make_evaluator(self, sparse: bool, extents=None) -> FmmTree:
        """An FMM tree over the (trend-transformed) points; under a trend the
        extents' corners are transformed before their box is taken."""
        pts = self.points
        if self.global_trend is not None:
            pts = self.global_trend.transform_points(pts)
            if extents is not None:
                d = pts.shape[1]
                extents = np.asarray(extents, np.float64)
                corners = common.bounding_box_corners(extents[:d], extents[d:])
                extents = common.get_pointarray_extents(
                    self.global_trend.transform_points(corners))
        if extents is None:
            extents = common.get_pointarray_extents(pts)
        return FmmTree(
            pts,
            self.params.fmm_params.interpolation_order,
            self.interpolant_settings.kernel_params(),
            adaptive_tree=True,
            sparse=sparse,
            extents=np.asarray(extents, np.float64),
            params=self.params.fmm_params,
            device=self.device,
        )

    def _evaluator_union_extents(self, target_points=None, target_extents=None) -> np.ndarray:
        source_extents = common.get_pointarray_extents(self.points)
        if target_points is not None:
            return common.union_extents(
                source_extents, common.get_pointarray_extents(np.asarray(target_points, np.float64)))
        if target_extents is not None:
            return common.union_extents(source_extents, target_extents)
        return source_extents

    def _evaluate(self, tree: FmmTree, target_points, evaluate_gradients: bool,
                  add_nugget: bool, leaves_mode: bool):
        """FMM values (and gradients) + nugget + polynomial drift (and its
        gradient). Gradients come back (n, nrhs * d). Under a trend the tree
        sees transformed targets, and x' = x B + b turns its gradients into
        the input space's as g B^T; the drift takes the raw targets."""
        targets = np.asarray(target_points, np.float64)
        tree_targets = targets
        if self.global_trend is not None:
            tree_targets = self.global_trend.transform_points(targets)
        weights = self.coefficients.point_coefficients
        gradients = None
        if evaluate_gradients:
            fn = tree.evaluate_leaves_with_gradients if leaves_mode else tree.evaluate_with_gradients
            values, gradients = fn(weights, tree_targets)
            if self.global_trend is not None:
                d, nrhs = targets.shape[1], weights.shape[1]
                bt = self.global_trend.linear_part(d).T
                gradients = np.einsum("nrj,jk->nrk", gradients.reshape(-1, nrhs, d),
                                      bt).reshape(-1, nrhs * d)
        else:
            fn = tree.evaluate_leaves if leaves_mode else tree.evaluate
            values = fn(weights, tree_targets)
        if add_nugget:
            values = values + weights * self.interpolant_settings.nugget
        if self.interpolant_settings.basis_size != 0:
            settings = self.interpolant_settings
            monomials = polynomials.evaluate_monomials(
                targets, settings.polynomial_degree, settings.basis_size,
                self.translation_factor, self.scale_factor,
            )
            values = values + monomials @ self.coefficients.poly_coefficients
            if gradients is not None:
                gradients = gradients + polynomials.evaluate_monomial_gradients(
                    targets, self.coefficients.poly_coefficients, settings.polynomial_degree,
                    self.translation_factor, self.scale_factor,
                )
        return _scalar_or_matrix(values), gradients

    def evaluate(self, target_points) -> np.ndarray:
        """One-shot evaluation over the union of source/target extents."""
        with traced_stage("evaluate"):
            tree = self._make_evaluator(False, self._evaluator_union_extents(target_points))
            tree.set_weights(self.coefficients.point_coefficients)
            return self._evaluate(tree, target_points, False, False, leaves_mode=False)[0]

    def evaluate_with_gradients(self, target_points):
        """One-shot values and gradients ((n, nrhs * d)) over the union of
        source/target extents."""
        with traced_stage("evaluate"):
            tree = self._make_evaluator(False, self._evaluator_union_extents(target_points))
            tree.set_weights(self.coefficients.point_coefficients)
            return self._evaluate(tree, target_points, True, False, leaves_mode=False)

    def evaluate_at_source(self, add_nugget: bool = False) -> np.ndarray:
        """Evaluate at the training sites (convergence diagnostics)."""
        tree = self._make_evaluator(sparse=True)
        tree.set_weights(self.coefficients.point_coefficients)
        return self._evaluate(tree, self.points, False, add_nugget, leaves_mode=False)[0]

    def build_evaluator(self, extents=None) -> None:
        """Build and keep an evaluator (one full downward pass) for the
        leaf-only ``evaluate_targets*`` calls."""
        tree = self._make_evaluator(False, extents)
        tree.set_weights(self.coefficients.point_coefficients)
        tree.set_local_coefficients(self.coefficients.point_coefficients)
        self._evaluator = tree

    def evaluate_targets(self, target_points) -> np.ndarray:
        """Leaf-only evaluation against the stored evaluator."""
        if self._evaluator is None:
            raise RuntimeError("call build_evaluator before evaluate_targets")
        return self._evaluate(self._evaluator, target_points, False, False, leaves_mode=True)[0]

    def evaluate_targets_with_gradients(self, target_points):
        if self._evaluator is None:
            raise RuntimeError("call build_evaluator before evaluate_targets_with_gradients")
        return self._evaluate(self._evaluator, target_points, True, False, leaves_mode=True)

    # ---------------------------------------------------------- isosurface
    def build_isosurface(self, extents, resolution: float, isovalue: float,
                         boundary_closure=None):
        return self.build_isosurfaces(extents, resolution, [isovalue], boundary_closure)[0]

    def build_isosurfaces(self, extents, resolution: float, isovalues, boundary_closure=None):
        """Surface-following RMT extraction, one mesh per isovalue. The
        evaluator spans the union of the source and ``extents`` boxes padded
        by ten lattice steps; seeds are the source points."""
        from ..isosurfacing import BoundaryClosure, ClusterMethod
        from ..rmt.isosurface import build_isosurface as rmt_build

        if boundary_closure is None:
            boundary_closure = BoundaryClosure.None_
        dims = self.points.shape[1]
        if dims != 3:
            raise ValueError("Only supported for 3D isosurfacing")
        extents = np.asarray(extents, np.float64)
        evaluator_extents = self._evaluator_union_extents(target_extents=extents)
        evaluator_extents[:dims] -= resolution * 10.0
        evaluator_extents[dims:] += resolution * 10.0
        self.build_evaluator(evaluator_extents)
        return [
            rmt_build(self.points, extents, resolution, isovalue, self.evaluate_targets,
                      self.evaluate_targets_with_gradients, ClusterMethod.CurvatureWeighted,
                      boundary_closure, self.progress_callback)
            for isovalue in isovalues
        ]

    # ------------------------------------------------------------ model I/O
    def _model_dict(self) -> dict:
        return {
            "format": JSON_FORMAT_NAME,
            "version": JSON_VERSION,
            "points": self.points.tolist(),
            "point_values": self.point_values.tolist(),
            "coefficients": self.coefficients.to_dict(),
            "interpolant_settings": self.interpolant_settings.to_dict(),
            "translation_factor": np.asarray(self.translation_factor).tolist(),
            "scale_factor": np.asarray(self.scale_factor).tolist(),
            "params": self.params.to_dict(),
            "global_trend": None if self.global_trend is None else self.global_trend.to_dict(),
        }

    def save_model(self, path) -> None:
        """Save to the versioned JSON envelope ``{format, version, ...model}``
        (the JAX package's keys)."""
        with open(path, "w") as fh:
            json.dump(self._model_dict(), fh)

    @classmethod
    def load_model(cls, path, progress_callback: Optional[Progress] = None,
                   device=None) -> "RBFInterpolator":
        """Load and validate the JSON envelope; the model evaluates on
        ``device`` (the CUDA card by default)."""
        with open(path) as fh:
            env = json.load(fh)
        if env.get("format") != JSON_FORMAT_NAME:
            raise ValueError(
                f"unsupported format {env.get('format')!r} (expected {JSON_FORMAT_NAME!r})"
            )
        if env.get("version") != JSON_VERSION:
            raise ValueError(
                f"unsupported version {env.get('version')} (expected {JSON_VERSION})"
            )
        model = cls.__new__(cls)
        model.device = resolve_device(device)
        model.interpolant_settings = InterpolantSettings.from_dict(env["interpolant_settings"])
        model.params = Params.from_dict(env["params"])
        model.points = np.asarray(env["points"], np.float64)
        model.point_values = np.asarray(env["point_values"], np.float64)
        model.coefficients = Coefficients.from_dict(env["coefficients"])
        model.translation_factor = np.asarray(env["translation_factor"], np.float64)
        model.scale_factor = np.asarray(env["scale_factor"], np.float64)
        trend = env.get("global_trend")
        model.global_trend = None if trend is None else GlobalTrendTransform.from_dict(trend)
        model.progress_callback = progress_callback
        model._evaluator = None
        return model

    @classmethod
    def builder(cls, points, values, interpolant_settings: InterpolantSettings,
                device=None) -> "_RBFInterpolatorBuilder":
        return _RBFInterpolatorBuilder(points, values, interpolant_settings, device)


class _RBFInterpolatorBuilder:
    """Fluent builder: ``RBFInterpolator.builder(points, values, settings)
    .params(...).global_trend(...).progress_callback(...).build()``."""

    def __init__(self, points, values, interpolant_settings: InterpolantSettings, device=None):
        self._points = points
        self._values = values
        self._settings = interpolant_settings
        self._device = device
        self._params: Optional[Params] = None
        self._global_trend: Optional[GlobalTrend] = None
        self._progress: Optional[Progress] = None

    def params(self, params: Params):
        self._params = params
        return self

    def global_trend(self, global_trend: GlobalTrend):
        self._global_trend = global_trend
        return self

    def progress_callback(self, progress: Progress):
        self._progress = progress
        return self

    def build(self) -> RBFInterpolator:
        return RBFInterpolator(
            self._points, self._values, self._settings, params=self._params,
            global_trend=self._global_trend, progress_callback=self._progress,
            device=self._device,
        )
