"""Fit Franke's 2D test function and evaluate it on a regular grid.

The port of ``examples/franke_2d.py``: 2,000 points, below the
``naive_solve_threshold``, so the fit takes the direct solve.
"""

import numpy as np

import ferreus_rbf_tpu_torch as frt
from ferreus_rbf_tpu_torch.examples.common import parse_args


def main(argv=None):
    args = parse_args(__doc__, argv)
    points = frt.generate_random_points(2000, 2, seed=42)
    values = frt.RBFTestFunctions.franke_2d(points)

    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.ThinPlateSpline)
    rbfi = frt.RBFInterpolator(points, values, settings, device=args.device)

    resid = np.max(np.abs(rbfi.evaluate(points) - values))
    print(f"max residual at sources: {resid:.3e}")

    grid = frt.create_evaluation_grid([(0.0, 1.0), (0.0, 1.0)], [101, 101])
    interpolated = rbfi.evaluate(grid)
    err = np.max(np.abs(interpolated - frt.RBFTestFunctions.franke_2d(grid)))
    print(f"max grid error vs analytic Franke: {err:.3e}")

    frt.point_arrays_to_csv(grid, interpolated, "franke_2d_interpolated.csv")
    print("wrote franke_2d_interpolated.csv")


if __name__ == "__main__":
    main()
