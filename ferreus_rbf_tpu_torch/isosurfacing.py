"""Isosurfacing public surface: Mesh, BoundaryClosure, ClusterMethod.

Copy of ``ferreus_rbf_tpu/isosurfacing.py``, which mirrors the
``ferreus_rbf.isosurfacing`` submodule of the reference bindings
(``py_ferreus_rbf/src/lib.rs``, ``ferreus_rmt/src/lib.rs:127-131``). The
extraction engine itself lives in ``ferreus_rbf_tpu_torch.rmt``, the port's
own copy of the JAX package's pure-numpy ``rmt``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class BoundaryClosure(enum.Enum):
    """How to close isosurface boundary loops on the clipping box.

    * ``None_``: leave clipped boundaries open.
    * ``ClosePositive``: cap so the region with values above the isovalue is
      enclosed.
    * ``CloseNegative``: cap so the region below the isovalue is enclosed.
    """

    None_ = "None"
    ClosePositive = "ClosePositive"
    CloseNegative = "CloseNegative"


class ClusterMethod(enum.Enum):
    """Vertex clustering method for regularised marching tetrahedra.

    ``CurvatureWeighted`` implements Treece et al. (1999) section 3.4;
    ``Mean`` is the plain centroid; ``None_`` disables clustering
    (classic marching tetrahedra).
    """

    None_ = "None"
    Mean = "Mean"
    CurvatureWeighted = "CurvatureWeighted"


@dataclasses.dataclass
class Mesh:
    """Triangle mesh: (N, 3) float64 vertices, (M, 3) int facets."""

    vertices: np.ndarray
    facets: np.ndarray

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float64).reshape(-1, 3)
        self.facets = np.asarray(self.facets, np.int64).reshape(-1, 3)

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_facets(self) -> int:
        return self.facets.shape[0]

    def save_obj(self, path: str) -> None:
        """Write a Wavefront OBJ file (1-based vertex indices)."""
        with open(path, "w") as fh:
            fh.write("# ferreus_rbf_tpu mesh\n")
            for v in self.vertices:
                fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for f in self.facets:
                fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def build_isosurface(*args, **kwargs):
    """Standalone extraction against user-supplied surface/gradient callbacks."""
    from .rmt.isosurface import build_isosurface as _impl

    return _impl(*args, **kwargs)


def build_isosurfaces(*args, **kwargs):
    from .rmt.isosurface import build_isosurfaces as _impl

    return _impl(*args, **kwargs)
