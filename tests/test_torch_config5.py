"""Config 5 (``bench.py`` ``config5_3m_rmt``) at a small size, on the CPU.

3,000 points of ``bench.py``'s ``_synthetic_sd`` (seed 11, the port's copy
held bit for bit to it) are fitted by the JAX package and carried to the
port with ``RBFInterpolator.from_numpy_state``. Both packages isosurface
the fit over [-1.4, 1.4]^3 at 0.1:

* facets equal and vertices within 1e-8 (the tolerance of
  ``tests/test_torch_isosurface.py::test_rbf_isosurface_matches_jax``:
  the two field evaluations agree to ~1e-13);
* the port's mesh closed (every edge on two facets), one component,
  V - E + F = 2, every vertex within one lattice step (0.1) of the bumpy
  sphere that is the data's zero level;
* ``python3 -m ferreus_rbf_tpu_torch.scripts.config5_isosurface 3000
  --resolution 0.1 --device cpu`` run in-process prints every key of its
  JSON line, passes its checks and gives the same mesh (the port's own
  direct fit: facets equal, vertices within 1e-8);
* the port's seed dedup (a 1-D unique of packed cell keys) picks the JAX
  copy's seeds exactly, and the Newton steps see the same points.
"""

import json

import numpy as np
import pytest
import torch

import bench
import ferreus_rbf_tpu as jrt
import ferreus_rbf_tpu_torch as prt
from ferreus_rbf_tpu.isosurfacing import BoundaryClosure as JBC
from ferreus_rbf_tpu.rmt import seed_projection as jseed
from ferreus_rbf_tpu_torch.isosurfacing import BoundaryClosure
from ferreus_rbf_tpu_torch.rmt import seed_projection as tseed
from ferreus_rbf_tpu_torch.rmt.lattice import SampleLattice
from ferreus_rbf_tpu_torch.scripts import config5_isosurface as c5
from ferreus_rbf_tpu_torch.scripts.fit_at_scale import synthetic_sd

N = 3000
RESOLUTION = 0.1
VERTEX_TOL = 1e-8

JSON_KEYS = {
    "card", "fit_s", "fit_stages_s", "solver_residual_rel", "solver_converged",
    "refinement_rounds", "solver_path", "weights_per_chunk", "true_residual_rel_max",
    "oracle_n_sample", "isosurface_s", "isosurface_split", "isosurface_launches", "mesh",
    "checks", "peak_device_gb", "peak_isosurface_gb",
}
SPLIT_KEYS = {
    "build_evaluator_s", "seed_projection_s", "seed_unique", "newton_calls", "newton_targets",
    "newton_s", "lattice_calls", "lattice_points", "lattice_s", "host_rmt_s",
}
CARD_ONLY = {"card", "peak_device_gb", "peak_isosurface_gb"}
ITERATIVE_ONLY = {"solver_residual_rel", "solver_converged"}  # no residual from a direct solve


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU's cores, and a torch thread pool per worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    pts, sd = bench._synthetic_sd(N)
    jfit = jrt.RBFInterpolator(pts, sd, jrt.InterpolantSettings(
        kernel_type=jrt.RBFKernelType.Linear))
    model = prt.RBFInterpolator.from_numpy_state(
        jfit.points, jfit.point_values,
        prt.InterpolantSettings(kernel_type=prt.RBFKernelType.Linear),
        jfit.coefficients.point_coefficients, jfit.coefficients.poly_coefficients,
        jfit.translation_factor, jfit.scale_factor, device="cpu")
    return {
        "jax": jfit.build_isosurface(c5.EXTENTS, RESOLUTION, 0.0, JBC.None_),
        "port": model.build_isosurface(c5.EXTENTS, RESOLUTION, 0.0, BoundaryClosure.None_),
    }


def test_synthetic_data_is_bench_data():
    for got, want in zip(synthetic_sd(N), bench._synthetic_sd(N)):
        np.testing.assert_array_equal(got, want)


def test_config5_mesh_matches_jax_and_the_bumpy_sphere(meshes):
    got, want = meshes["port"], meshes["jax"]
    assert got.num_facets > 1000
    np.testing.assert_array_equal(got.facets, want.facets)
    assert np.max(np.abs(got.vertices - want.vertices)) < VERTEX_TOL
    checks = c5.check_mesh(got.vertices, got.facets, RESOLUTION)
    assert checks["facets_per_edge"] == [2, 2]
    assert checks["components"] == 1 and checks["euler_characteristic"] == 2
    assert checks["surface_deviation_max"] <= RESOLUTION


def test_config5_script_prints_every_key_and_the_same_mesh(meshes, capsys):
    record, mesh = c5.main([str(N), "--resolution", str(RESOLUTION), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert JSON_KEYS - CARD_ONLY - ITERATIVE_ONLY <= set(printed)
    assert printed["true_residual_rel_max"] < 1e-10 and printed["oracle_n_sample"] == 512
    assert SPLIT_KEYS <= set(printed["isosurface_split"])
    assert printed["checks"]["passed"] is True
    assert printed["mesh"] == {"vertices": mesh.num_vertices, "facets": mesh.num_facets}
    assert record["solver_path"] == "direct"  # 3,000 < naive_solve_threshold
    want = meshes["jax"]
    np.testing.assert_array_equal(mesh.facets, want.facets)
    assert np.max(np.abs(mesh.vertices - want.vertices)) < VERTEX_TOL


def test_config5_script_needs_a_card_or_the_cpu_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        c5.main([str(N)])


@pytest.mark.parametrize("extent", [1.4, 0.9])
def test_seed_dedup_matches_the_jax_copy(extent):
    """100,000 seeds over a box that holds them all (1.4) and one that
    clamps many (0.9): the same seed cells, and each Newton step sees the
    same points in the same order."""
    pts, _ = bench._synthetic_sd(100_000)
    lattice = SampleLattice(0.02, np.array([-extent] * 3 + [extent] * 3))
    seen = {"jax": [], "port": []}

    def sphere_gradient(key):
        def fn(x):
            seen[key].append(x.copy())
            r = np.linalg.norm(x, axis=1, keepdims=True)
            return r - 1.0, x / r
        return fn

    want = jseed.get_unique_seed_point_ijks(pts, sphere_gradient("jax"), lattice, 0.0)
    got = tseed.get_unique_seed_point_ijks(pts, sphere_gradient("port"), lattice, 0.0)
    assert got == want and len(got) > 1000
    assert len(seen["port"]) == len(seen["jax"]) >= 2
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
