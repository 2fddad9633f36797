"""Regularised marching tetrahedra (Treece, Prager & Gee 1999).

Surface-following isosurface extraction against an implicit function:
seed projection -> batched wavefront expansion -> topology-aware vertex
clustering (curvature weighted) -> marching tetrahedra -> non-manifold and
self-intersection rollbacks -> AABB clip -> cleanup -> boundary closure.

Host/device split: the wavefront driver and mesh combinatorics are host
code; every field evaluation is batched through the supplied
``isosurface_fn`` / ``gradient_fn`` callbacks, which in the RBF pipeline hit
the FMM leaf evaluator on the device (one batch per wavefront generation,
mirroring the reference's batching at ``isosurface.rs:552-578``).
"""

from .isosurface import build_isosurface, build_isosurfaces

__all__ = ["build_isosurface", "build_isosurfaces"]
