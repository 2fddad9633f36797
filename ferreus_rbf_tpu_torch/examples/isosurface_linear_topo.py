"""Clip one isosurface by another: an orebody surface clipped by topography.

The port of ``examples/isosurface_linear_topo.py`` (the topography is
synthesised, as there): fit two RBFs, one to signed distances of the body
and one (2-D, ThinPlateSpline) to the elevation of the topography surface,
extract the body isosurface, then drop every facet whose centroid lies
above the topography.
"""

import numpy as np

import ferreus_rbf_tpu_torch as frt
from ferreus_rbf_tpu_torch.examples.common import load_albatite, parse_args


def main(argv=None):
    args = parse_args(__doc__, argv)
    points, values = load_albatite()
    extents = np.concatenate([points.min(axis=0), points.max(axis=0)])
    span = np.max(extents[3:] - extents[:3])

    # synthetic topography through the middle of the body
    rng = np.random.default_rng(7)
    topo_xy = rng.uniform(extents[:2], extents[3:5], size=(2000, 2))
    z_mid = 0.5 * (extents[2] + extents[5])
    topo_z = z_mid + 0.1 * span * np.sin(topo_xy[:, 0] / span * 6.0) * np.cos(
        topo_xy[:, 1] / span * 5.0
    )

    body_settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    body = frt.RBFInterpolator(points, values, body_settings, device=args.device)

    topo_settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.ThinPlateSpline)
    topo = frt.RBFInterpolator(topo_xy, topo_z[:, None], topo_settings, device=args.device)

    mesh = body.build_isosurface(extents, span / 100.0, 0.0, frt.BoundaryClosure.None_)
    print(f"body isosurface: {mesh.num_facets} facets")

    # keep facets whose centroid is below the topo surface
    centroids = mesh.vertices[mesh.facets].mean(axis=1)
    topo_at = topo.evaluate(centroids[:, :2])
    keep = centroids[:, 2] <= topo_at
    clipped = frt.Mesh(mesh.vertices, mesh.facets[keep])
    print(f"clipped below topography: {clipped.num_facets} facets")
    clipped.save_obj("albatite_topo_clipped.obj")


if __name__ == "__main__":
    main()
