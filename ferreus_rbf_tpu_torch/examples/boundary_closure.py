"""Boundary closure demo: watertight caps on a clipped sphere.

The port of ``examples/boundary_closure.py``: extract the same clipped
surface open, closed-positive and closed-negative, and report
watertightness and enclosed volume. The surface is an analytic signed
distance, so RMT runs on the host only; ``--device`` is accepted for a
uniform command line.
"""

import numpy as np

from ferreus_rbf_tpu_torch.examples.common import parse_args, sphere_grad, sphere_sdf
from ferreus_rbf_tpu_torch.isosurfacing import BoundaryClosure, ClusterMethod, build_isosurface


def stats(mesh):
    edges = {}
    for t in mesh.facets:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            k = (min(a, b), max(a, b))
            edges[k] = edges.get(k, 0) + 1
    watertight = all(c == 2 for c in edges.values())
    tri = mesh.vertices[mesh.facets]
    vol = np.einsum("ij,ij->i", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum() / 6.0
    return watertight, vol


def main(argv=None):
    parse_args(__doc__, argv)
    seeds = np.array([[1.0, 0.0, 0.0]])
    extents = [-1.5, -1.5, -1.5, 0.6, 1.5, 1.5]  # clips the sphere at x=0.6
    for mode in (BoundaryClosure.None_, BoundaryClosure.ClosePositive,
                 BoundaryClosure.CloseNegative):
        mesh = build_isosurface(
            seeds, extents, 0.2, 0.0, sphere_sdf, sphere_grad,
            ClusterMethod.CurvatureWeighted, mode,
        )
        watertight, vol = stats(mesh)
        print(f"{mode.value:>14}: V={mesh.num_vertices:4d} F={mesh.num_facets:4d} "
              f"watertight={watertight} volume={vol:8.4f}")
        mesh.save_obj(f"sphere_{mode.value}.obj")


if __name__ == "__main__":
    main()
