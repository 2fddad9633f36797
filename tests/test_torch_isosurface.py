"""The port's RMT isosurfacing against the JAX package's, on the CPU.

* The golden sphere through the port's own ``rmt`` copy: exactly 540
  vertices and 1076 facets, watertight (``tests/test_rmt.py``, the
  reference's acceptance test).
* The same analytic field through both packages' ``rmt``: identical meshes
  (the same numpy code).
* A fit of sphere signed distances, then ``build_isosurface`` in both
  packages, the port's interpolator built by ``from_numpy_state`` from the
  JAX fit: the same vertex and facet counts and vertices within 1e-8 (the
  two field evaluations agree to ~1e-13; the mesh inherits that through
  the lattice-edge interpolation and clustering).
"""

import numpy as np
import pytest

import ferreus_rbf_tpu as jrt
import ferreus_rbf_tpu_torch as prt
from ferreus_rbf_tpu.isosurfacing import BoundaryClosure as JBC
from ferreus_rbf_tpu.isosurfacing import ClusterMethod as JCM
from ferreus_rbf_tpu.rmt.isosurface import build_isosurface as jax_rmt
from ferreus_rbf_tpu_torch.isosurfacing import BoundaryClosure, ClusterMethod, Mesh
from ferreus_rbf_tpu_torch.rmt import topology
from ferreus_rbf_tpu_torch.rmt.isosurface import build_isosurface

SEEDS = np.array([[1.0, 0.0, 0.0]])


def sphere_sdf(pts):
    return np.linalg.norm(pts, axis=1, keepdims=True) - 1.0


def sphere_grad(pts):
    n = np.linalg.norm(pts, axis=1, keepdims=True)
    return n - 1.0, pts / np.maximum(n, 1e-12)


def edge_counts(mesh):
    edges = {}
    for t in mesh.facets:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            k = (min(a, b), max(a, b))
            edges[k] = edges.get(k, 0) + 1
    return edges


def is_watertight(mesh):
    counts = list(edge_counts(mesh).values())
    return bool(counts) and all(c == 2 for c in counts)


def test_golden_sphere():
    mesh = build_isosurface(
        SEEDS, [-1.5] * 3 + [1.5] * 3, 0.2, 0.0, sphere_sdf, sphere_grad,
        ClusterMethod.CurvatureWeighted, BoundaryClosure.None_,
    )
    assert isinstance(mesh, Mesh)
    assert mesh.num_vertices == 540
    assert mesh.num_facets == 1076
    assert is_watertight(mesh)
    assert mesh.num_vertices - len(edge_counts(mesh)) + mesh.num_facets == 2  # a sphere
    r = np.linalg.norm(mesh.vertices, axis=1)
    assert r.min() > 0.98 and r.max() < 1.01


@pytest.mark.parametrize("closure", ["None_", "ClosePositive", "CloseNegative"])
def test_rmt_copy_matches_jax_rmt(closure):
    """The sphere clipped by the x <= 0.6 face, each boundary closure:
    the port's copy gives the JAX package's mesh exactly."""
    extents = [-1.5, -1.5, -1.5, 0.6, 1.5, 1.5]
    seeds = np.array([[-1.0, 0.0, 0.0]])
    got = build_isosurface(seeds, extents, 0.2, 0.0, sphere_sdf, sphere_grad,
                           ClusterMethod.CurvatureWeighted, BoundaryClosure[closure])
    want = jax_rmt(seeds, extents, 0.2, 0.0, sphere_sdf, sphere_grad,
                   JCM.CurvatureWeighted, JBC[closure])
    np.testing.assert_array_equal(got.facets, want.facets)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    if closure != "None_":
        assert is_watertight(got)


def test_topology_connected_components():
    assert len(topology.connected_components_masks(0b11)) == 1
    assert len(topology.connected_components_masks((1 << 1) | (1 << 8))) == 2
    assert len(topology.connected_components_masks(topology.ALL14_MASK)) == 1


@pytest.fixture(scope="module")
def sphere_fits():
    """The 400-point sphere signed-distance fit of ``tests/test_rmt.py``."""
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(400, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = np.array([0.7, 1.0, 1.3]).repeat(134)[:400]
    pts = dirs * radii[:, None]
    vals = np.linalg.norm(pts, axis=1, keepdims=True) - 1.0
    jfit = jrt.RBFInterpolator(pts, vals, jrt.InterpolantSettings(
        kernel_type=jrt.RBFKernelType.Linear))
    model = prt.RBFInterpolator.from_numpy_state(
        jfit.points, jfit.point_values,
        prt.InterpolantSettings(kernel_type=prt.RBFKernelType.Linear),
        jfit.coefficients.point_coefficients, jfit.coefficients.poly_coefficients,
        jfit.translation_factor, jfit.scale_factor, device="cpu")
    extents = [-1.4] * 3 + [1.4] * 3
    return {
        "jax": jfit.build_isosurface(extents, 0.25, 0.0, JBC.None_),
        "port": model.build_isosurface(extents, 0.25, 0.0, BoundaryClosure.None_),
        "model": model,
    }


def test_rbf_isosurface_matches_jax(sphere_fits):
    got, want = sphere_fits["port"], sphere_fits["jax"]
    assert got.num_facets > 100
    assert (got.num_vertices, got.num_facets) == (want.num_vertices, want.num_facets)
    np.testing.assert_array_equal(got.facets, want.facets)
    assert np.max(np.abs(got.vertices - want.vertices)) < 1e-8
    assert is_watertight(got)
    assert abs(np.mean(np.linalg.norm(got.vertices, axis=1)) - 1.0) < 0.05


def test_build_isosurfaces_one_mesh_per_isovalue(sphere_fits):
    model = sphere_fits["model"]
    meshes = model.build_isosurfaces([-1.4] * 3 + [1.4] * 3, 0.25, [0.0, 0.2])
    assert len(meshes) == 2
    assert meshes[0].num_facets == sphere_fits["port"].num_facets
    r = [np.mean(np.linalg.norm(m.vertices, axis=1)) for m in meshes]
    assert r[1] > r[0] + 0.1  # the 0.2 level set lies outside the zero one
    with pytest.raises(ValueError, match="3D"):
        prt.RBFInterpolator.from_numpy_state(
            np.zeros((3, 2)), np.zeros(3), prt.InterpolantSettings(
                kernel_type=prt.RBFKernelType.Linear),
            np.zeros(3), np.zeros((1, 1)), np.zeros(2), np.ones(2),
            device="cpu").build_isosurface([0, 0, 1, 1], 0.1, 0.0)
