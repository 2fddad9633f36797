"""Standalone BBFMM module (port of ``ferreus_rbf_tpu/bbfmm.py``, the
counterpart of the reference's separately shipped ``ferreus_bbfmm``).

Exposes the raw fast-multipole evaluator for generic kernel summation:
``FmmTree`` with ``set_weights`` / ``evaluate`` / ``evaluate_with_gradients``
/ ``set_local_coefficients`` / ``evaluate_leaves`` (+ gradients) /
``source_points``, the seven user-facing kernel types (Laplacian, 1/r^2 and
1/r^4 besides the RBFs, with the parameterised spheroidal family), M2L
compression selection and ``FmmParams`` tuning. It wraps the port's
``ops/fmm/api.py`` ``FmmTree``: the near field runs on the CUDA kernels
H1-H3 on the card (each specialised per kernel type), on their plain
versions on the CPU. ``device`` defaults to the CUDA card; pass
``device="cpu"`` to run on the CPU.

Each method that runs a pass is one outermost stage of the port's tracer
(``utils/timing.py``), ``bbfmm_<method>``, which holds the copy of the
weights to the device and of the result back to the host; its counters
(targets binned, bytes copied to the device) form one ``counters`` event
per call. Nothing is recorded while tracing is off.
"""

from __future__ import annotations

import enum

import numpy as np

from .config import FmmCompressionType as M2LCompressionType
from .config import FmmParams
from .ops.fmm.api import (
    FmmTree as _FmmTree,
    KernelDoesNotSupportGradientsError,
    PointOutsideTreeError,
)
from .ops.kernels import KernelParams as _KernelParams
from .ops.kernels import KernelType as _KernelType
from .utils.timing import traced_stage


class FmmKernelType(enum.Enum):
    """Kernels available through the standalone FMM interface."""

    Laplacian = "Laplacian"
    OneOverR2 = "OneOverR2"
    OneOverR4 = "OneOverR4"
    LinearRbf = "LinearRbf"
    ThinPlateSplineRbf = "ThinPlateSplineRbf"
    CubicRbf = "CubicRbf"
    SpheroidalRbf = "SpheroidalRbf"


class SpheroidalOrder(enum.Enum):
    Three = 3
    Five = 5
    Seven = 7
    Nine = 9


_SPHEROIDAL = {
    SpheroidalOrder.Three: _KernelType.Spheroidal3Rbf,
    SpheroidalOrder.Five: _KernelType.Spheroidal5Rbf,
    SpheroidalOrder.Seven: _KernelType.Spheroidal7Rbf,
    SpheroidalOrder.Nine: _KernelType.Spheroidal9Rbf,
}


class KernelParams:
    """Kernel selection + spheroidal parameters for the FMM interface."""

    def __init__(
        self,
        kernel_type: FmmKernelType,
        spheroidal_order: SpheroidalOrder = SpheroidalOrder.Three,
        base_range: float = 1.0,
        total_sill: float = 1.0,
    ):
        self.kernel_type = kernel_type
        self.spheroidal_order = spheroidal_order
        self.base_range = base_range
        self.total_sill = total_sill

    def _to_internal(self) -> _KernelParams:
        if self.kernel_type == FmmKernelType.SpheroidalRbf:
            kt = _SPHEROIDAL[self.spheroidal_order]
        else:
            kt = _KernelType(self.kernel_type.value)
        return _KernelParams(kt, self.base_range, self.total_sill)


class FmmTree:
    """Black-box FMM over fixed source points (multi-RHS, gradients)."""

    def __init__(
        self,
        source_points,
        interpolation_order: int,
        kernel_params: KernelParams,
        adaptive_tree: bool = True,
        sparse: bool = False,
        extents=None,
        params: FmmParams | None = None,
        device=None,
    ):
        self._tree = _FmmTree(
            np.asarray(source_points, np.float64),
            interpolation_order,
            kernel_params._to_internal(),
            adaptive_tree=adaptive_tree,
            sparse=sparse,
            extents=extents,
            params=params,
            device=device,
        )

    @property
    def source_points(self) -> np.ndarray:
        return self._tree.source_points

    def set_weights(self, weights) -> None:
        with traced_stage("bbfmm_set_weights"):
            self._tree.set_weights(weights)

    def set_local_coefficients(self, weights) -> None:
        with traced_stage("bbfmm_set_local_coefficients"):
            self._tree.set_local_coefficients(weights)

    def evaluate(self, weights, target_points) -> np.ndarray:
        with traced_stage("bbfmm_evaluate"):
            return self._tree.evaluate(weights, target_points)

    def evaluate_with_gradients(self, weights, target_points):
        with traced_stage("bbfmm_evaluate_with_gradients"):
            return self._tree.evaluate_with_gradients(weights, target_points)

    def evaluate_leaves(self, weights, target_points) -> np.ndarray:
        with traced_stage("bbfmm_evaluate_leaves"):
            return self._tree.evaluate_leaves(weights, target_points)

    def evaluate_leaves_with_gradients(self, weights, target_points):
        with traced_stage("bbfmm_evaluate_leaves_with_gradients"):
            return self._tree.evaluate_leaves_with_gradients(weights, target_points)


__all__ = [
    "FmmKernelType",
    "FmmParams",
    "FmmTree",
    "KernelDoesNotSupportGradientsError",
    "KernelParams",
    "M2LCompressionType",
    "PointOutsideTreeError",
    "SpheroidalOrder",
]
