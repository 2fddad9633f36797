"""The port at d = 1 and d = 2 against the JAX package, on the CPU.

* A 1-D adaptive FMM matvec (a dense blob in a sparse background, so the
  tree is deep and uneven) against the JAX package's: f64 to 1e-12
  relative (the JAX package's XLA scan path is true f64 here, as in
  ``test_torch_fmm.py``), f32 to 1e-5 (the f32 tier's bound).
* A 1-D iterative fit (6,000 points, above ``naive_solve_threshold``)
  to its residual: the solver's l2 residual at most 1e-6 and converged,
  ``evaluate_at_source`` within 1e-4 of max |values|.
* A 2-D JAX fit (3,000 Franke points, ThinPlateSpline: the direct solve)
  carried into the port with ``from_numpy_state`` and through
  ``save_model``/``load_model`` both ways: evaluations and gradients
  within 1e-11 relative of the JAX package's (the same f64 arithmetic,
  summed in other orders, as ``test_torch_io.py`` holds them), and the
  loaded model bit for bit the carried one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ferreus_rbf_tpu as jrt
import ferreus_rbf_tpu_torch as prt
from ferreus_rbf_tpu.config import FmmCompressionType as JFC
from ferreus_rbf_tpu.config import FmmParams as JFP
from ferreus_rbf_tpu.ops import kernels as jk
from ferreus_rbf_tpu.ops.fmm.api import FmmTree as JaxTree
from ferreus_rbf_tpu_torch.config import FmmCompressionType, FmmParams
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree
from ferreus_rbf_tpu_torch.utils import timing


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU's cores, and a torch thread pool per worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(want)))


@pytest.fixture(scope="module", params=["LinearRbf", "ThinPlateSplineRbf", "Spheroidal5Rbf"])
def matvecs_1d(request):
    """Both packages' ``evaluate_device`` at 2,000 clustered 1-D sources, 2
    RHS, p = 5: the JAX package's in f64, the port's in f64 and f32."""
    rng = np.random.default_rng(5)
    pts = np.clip(np.concatenate([rng.normal(0.3, 0.01, (1500, 1)), rng.random((500, 1))]),
                  0.0, 1.0)
    name = request.param
    kw = {"base_range": 1.0, "total_sill": 0.7} if "Spheroidal" in name else {}
    fmm = dict(interpolation_order=5, max_points_per_cell=32, epsilon=1e-5)
    jt = JaxTree(pts, 5, jk.KernelParams(jk.KernelType(name), **kw), adaptive_tree=True,
                 sparse=True, params=JFP(compression_type=JFC.ACA, **fmm))
    tt = FmmTree(pts, 5, tk.KernelParams(tk.KernelType(name), **kw), adaptive_tree=True,
                 sparse=True, params=FmmParams(compression_type=FmmCompressionType.ACA, **fmm),
                 device="cpu")
    jt.prepare_targets(pts, "src")
    tt.prepare_targets(pts, "src")
    n = pts.shape[0]
    w = np.random.default_rng(1).standard_normal((jt._target_cache["src"]["n_pad"], 2))
    out = {"jax": np.asarray(jt.evaluate_device(jnp.asarray(w), "src", precision="f64"))[:n],
           "depth": tt.tree.depth}
    for prec in ("f64", "f32"):
        out[prec] = tt.evaluate_device(torch.as_tensor(w[:n]), "src", prec).numpy()
    return out


@pytest.mark.parametrize("prec,tol", [("f64", 1e-12), ("f32", 1e-5)])
def test_1d_adaptive_matvec_matches_jax(matvecs_1d, prec, tol):
    assert matvecs_1d["depth"] >= 6  # the blob makes a deep, uneven tree
    assert matvecs_1d[prec].shape == matvecs_1d["jax"].shape == (2000, 2)
    assert _rel(matvecs_1d[prec], matvecs_1d["jax"]) < tol


def test_1d_iterative_fit_reaches_its_residual():
    x = np.random.default_rng(5).random((6000, 1))
    f = np.sin(12 * x[:, 0]) + 0.3 * np.cos(31 * x[:, 0])
    settings = prt.InterpolantSettings(kernel_type=prt.RBFKernelType.Linear)
    tracer = timing.enable_global_tracer()
    try:
        rbfi = prt.RBFInterpolator(x, f, settings, device="cpu")
    finally:
        timing.disable_global_tracer()
    done = [e for e in tracer.events if e["event"] == "solve_done"][-1]
    assert any(e["event"] == "ddm_level" for e in tracer.events)  # the iterative path
    assert done["converged"] and done["residual"] <= 1e-6
    pred = rbfi.evaluate_at_source(add_nugget=True)
    assert pred.shape == f.shape and _rel(pred, f) < 1e-4


@pytest.fixture(scope="module")
def fit_2d():
    """A JAX fit of Franke's function at 3,000 2-D points (the direct solve)
    and the port's interpolator made from its arrays."""
    pts = jrt.generate_random_points(3000, 2, seed=42)
    vals = jrt.RBFTestFunctions.franke_2d(pts)
    jfit = jrt.RBFInterpolator(
        pts, vals, jrt.InterpolantSettings(kernel_type=jrt.RBFKernelType.ThinPlateSpline))
    port = prt.RBFInterpolator.from_numpy_state(
        jfit.points, jfit.point_values,
        prt.InterpolantSettings(kernel_type=prt.RBFKernelType.ThinPlateSpline),
        jfit.coefficients.point_coefficients, jfit.coefficients.poly_coefficients,
        jfit.translation_factor, jfit.scale_factor, device="cpu")
    targets = prt.create_evaluation_grid([(0.0, 1.0), (0.0, 1.0)], [23, 23])
    return {"jax": jfit, "port": port, "targets": targets}


def test_2d_jax_fit_carried_across_matches_jax(fit_2d):
    jfit, port, targets = fit_2d["jax"], fit_2d["port"], fit_2d["targets"]
    assert _rel(port.evaluate(targets), jfit.evaluate(targets)) < 1e-11
    got_v, got_g = port.evaluate_with_gradients(targets)
    want_v, want_g = jfit.evaluate_with_gradients(targets)
    assert got_g.shape == (targets.shape[0], 2)
    assert _rel(got_v, want_v) < 1e-11 and _rel(got_g, want_g) < 1e-11


def test_2d_jax_model_loads_in_port(fit_2d, tmp_path):
    path = tmp_path / "jax.json"
    fit_2d["jax"].save_model(path)
    loaded = prt.RBFInterpolator.load_model(path, device="cpu")
    targets = fit_2d["targets"]
    got = loaded.evaluate(targets)
    assert np.array_equal(got, fit_2d["port"].evaluate(targets))
    assert _rel(got, fit_2d["jax"].evaluate(targets)) < 1e-11


def test_2d_port_model_loads_in_jax(fit_2d, tmp_path):
    path = tmp_path / "port.json"
    fit_2d["port"].save_model(path)
    loaded = jrt.RBFInterpolator.load_model(path)
    targets = fit_2d["targets"]
    assert _rel(loaded.evaluate(targets), fit_2d["jax"].evaluate(targets)) < 1e-11
