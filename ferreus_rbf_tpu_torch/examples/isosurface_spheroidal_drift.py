"""Spheroidal fit with an explicit linear drift term + isosurface.

The port of ``examples/isosurface_spheroidal_drift.py``.
"""

import numpy as np

import ferreus_rbf_tpu_torch as frt
from ferreus_rbf_tpu_torch.examples.common import load_albatite, parse_args


def main(argv=None):
    args = parse_args(__doc__, argv)
    points, values = load_albatite()
    extents = np.concatenate([points.min(axis=0), points.max(axis=0)])
    span = np.max(extents[3:] - extents[:3])

    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.Spheroidal,
        spheroidal_order=frt.SpheroidalOrder.Five,
        drift=frt.Drift.Linear,
        base_range=span / 4.0,
        total_sill=span / 4.0,
    )
    rbfi = frt.RBFInterpolator(points, values, settings, device=args.device)
    print("poly coefficients:\n", rbfi.coefficients.poly_coefficients)

    mesh = rbfi.build_isosurface(extents, span / 100.0, 0.0, frt.BoundaryClosure.None_)
    print(f"isosurface: {mesh.num_vertices} vertices, {mesh.num_facets} facets")
    mesh.save_obj("albatite_spheroidal_drift.obj")


if __name__ == "__main__":
    main()
