"""Fit the albatite dataset with the biharmonic (Linear) kernel and extract
the zero isosurface.

The port of ``examples/isosurface_linear.py``.
"""

import numpy as np

import ferreus_rbf_tpu_torch as frt
from ferreus_rbf_tpu_torch.examples.common import load_albatite, parse_args


def main(argv=None):
    args = parse_args(__doc__, argv)
    points, values = load_albatite()
    extents = np.concatenate([points.min(axis=0), points.max(axis=0)])
    span = np.max(extents[3:] - extents[:3])

    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    rbfi = frt.RBFInterpolator(points, values, settings, device=args.device)

    # values are (n, 1) and evaluate_at_source gives (n,): compare like with
    # like (the JAX example's subtraction broadcasts to (n, n))
    resid = np.max(np.abs(rbfi.evaluate_at_source(True) - values.reshape(-1)))
    print(f"fit residual: {resid:.3e} over {points.shape[0]} points")

    mesh = rbfi.build_isosurface(extents, span / 100.0, 0.0, frt.BoundaryClosure.None_)
    print(f"isosurface: {mesh.num_vertices} vertices, {mesh.num_facets} facets")
    mesh.save_obj("albatite_linear.obj")


if __name__ == "__main__":
    main()
