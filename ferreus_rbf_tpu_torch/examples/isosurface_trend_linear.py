"""Linear-kernel fit under a 3D global trend (anisotropy) + isosurface.

The port of ``examples/isosurface_trend_linear.py``.
"""

import numpy as np

import ferreus_rbf_tpu_torch as frt
from ferreus_rbf_tpu_torch.examples.common import load_albatite, parse_args


def main(argv=None):
    args = parse_args(__doc__, argv)
    points, values = load_albatite()
    extents = np.concatenate([points.min(axis=0), points.max(axis=0)])
    span = np.max(extents[3:] - extents[:3])

    trend = frt.GlobalTrend.three(
        dip=30.0,
        dip_direction=45.0,
        pitch=0.0,
        major_ratio=2.0,
        semi_major_ratio=1.5,
        minor_ratio=1.0,
    )

    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    rbfi = frt.RBFInterpolator(points, values, settings, global_trend=trend,
                               device=args.device)

    mesh = rbfi.build_isosurface(extents, span / 100.0, 0.0, frt.BoundaryClosure.None_)
    print(f"isosurface: {mesh.num_vertices} vertices, {mesh.num_facets} facets")
    mesh.save_obj("albatite_trend.obj")


if __name__ == "__main__":
    main()
