"""Extract a sphere isosurface from an analytic SDF with standalone RMT.

The port of ``examples/isosurface_sphere.py``, the golden-output workflow
(540 vertices / 1076 facets at resolution 0.2 in [-1.5, 1.5]^3). The
surface is analytic, so RMT runs on the host only; ``--device`` is
accepted for a uniform command line.
"""

import numpy as np

from ferreus_rbf_tpu_torch.examples.common import parse_args, sphere_grad, sphere_sdf
from ferreus_rbf_tpu_torch.isosurfacing import BoundaryClosure, ClusterMethod, build_isosurface


def main(argv=None):
    parse_args(__doc__, argv)
    mesh = build_isosurface(
        np.array([[1.0, 0.0, 0.0]]),
        [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5],
        0.2,
        0.0,
        sphere_sdf,
        sphere_grad,
        ClusterMethod.CurvatureWeighted,
        BoundaryClosure.None_,
    )
    print(f"sphere mesh: {mesh.num_vertices} vertices, {mesh.num_facets} facets")
    mesh.save_obj("sphere.obj")
    print("wrote sphere.obj")


if __name__ == "__main__":
    main()
