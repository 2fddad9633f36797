"""Standalone RMT driven by explicit RBF evaluator callbacks.

The port of ``examples/isosurface_linear_rmt.py``: fit an RBF, then call the
standalone ``build_isosurface`` with user-supplied surface and gradient
callbacks over ``build_evaluator`` instead of the interpolator's
convenience wrapper.
"""

import numpy as np

import ferreus_rbf_tpu_torch as frt
from ferreus_rbf_tpu_torch.examples.common import load_albatite, parse_args
from ferreus_rbf_tpu_torch.isosurfacing import BoundaryClosure, ClusterMethod, build_isosurface


def main(argv=None):
    args = parse_args(__doc__, argv)
    points, values = load_albatite()
    extents = np.concatenate([points.min(axis=0), points.max(axis=0)])
    span = np.max(extents[3:] - extents[:3])
    resolution = span / 80.0

    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    rbfi = frt.RBFInterpolator(points, values, settings, device=args.device)

    ev_extents = extents.copy()
    ev_extents[:3] -= resolution * 10
    ev_extents[3:] += resolution * 10
    rbfi.build_evaluator(ev_extents)

    def surface_fn(targets):
        return rbfi.evaluate_targets(targets)

    def gradient_fn(targets):
        return rbfi.evaluate_targets_with_gradients(targets)

    mesh = build_isosurface(
        points, extents, resolution, 0.0, surface_fn, gradient_fn,
        ClusterMethod.CurvatureWeighted, BoundaryClosure.None_,
    )
    print(f"isosurface: {mesh.num_vertices} vertices, {mesh.num_facets} facets")
    mesh.save_obj("albatite_rmt.obj")


if __name__ == "__main__":
    main()
