"""ferreus_rbf_tpu_torch: fast global RBF interpolation on PyTorch and CUDA.

The port of ``ferreus_rbf_tpu`` (JAX/Pallas) to PyTorch, with hand-written
CUDA kernels for the FMM near field on NVIDIA Hopper. Module paths mirror
the JAX package's. Ported: the iterative fit (BBFMM matvecs, FGMRES with
multilevel Schwarz preconditioning, mixed-precision refinement), global
trends, evaluation with and without gradients, the leaf-only evaluator,
RMT isosurfacing, model I/O (the JAX package's ``ferreus_rbf.json``
envelope), the builder and the standalone ``bbfmm`` module. Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.
"""

import torch as _torch

# True-f32 products: the mixed-precision solver's f32 inner iterations are
# useless at TF32's ~1e-3 relative error.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import DDMParams, FmmCompressionType, FmmParams, Params, Solvers  # noqa: E402
from .interpolant_config import (  # noqa: E402
    Drift,
    FittingAccuracy,
    FittingAccuracyType,
    InterpolantSettings,
    RBFKernelType,
    SpheroidalOrder,
    get_min_drift,
)
from .isosurfacing import BoundaryClosure, ClusterMethod, Mesh  # noqa: E402
from .models.global_trend import GlobalTrend, GlobalTrendTransform  # noqa: E402
from .models.rbf import Coefficients, RBFInterpolator  # noqa: E402
from .models.test_functions import RBFTestFunctions  # noqa: E402
from .progress import Progress, ProgressMsg, closure_sink  # noqa: E402
from .utils.common import (  # noqa: E402
    create_evaluation_grid,
    csv_to_point_arrays,
    generate_random_points,
    pad_and_snap_extents,
    point_arrays_to_csv,
)

__all__ = [
    "BoundaryClosure",
    "ClusterMethod",
    "Coefficients",
    "DDMParams",
    "Drift",
    "FittingAccuracy",
    "FittingAccuracyType",
    "FmmCompressionType",
    "FmmParams",
    "GlobalTrend",
    "GlobalTrendTransform",
    "InterpolantSettings",
    "Mesh",
    "Params",
    "Progress",
    "ProgressMsg",
    "RBFInterpolator",
    "RBFKernelType",
    "RBFTestFunctions",
    "Solvers",
    "SpheroidalOrder",
    "closure_sink",
    "create_evaluation_grid",
    "csv_to_point_arrays",
    "generate_random_points",
    "get_min_drift",
    "pad_and_snap_extents",
    "point_arrays_to_csv",
]

__version__ = "0.1.0"
