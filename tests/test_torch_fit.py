"""The port's interpolator against the JAX package's, on the CPU.

A 5,000-point 3-D Linear fit takes the iterative path (FGMRES, Schwarz
DDM, FMM matvecs; the ``_iter_params`` of ``tests/test_solver.py``) in
both packages. Tolerances:

* source residual < 5e-6 for each package (``tests/test_solver.py``);
* grid values of the two fits agree within 1e-5 of the data's scale: both
  solve to the 1e-6 relative l2 residual, by different Krylov paths;
* one set of fitted arrays evaluated by both packages agrees to 1e-11
  relative: the same evaluation in true f64 on both sides.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import ferreus_rbf_tpu as jrt
import ferreus_rbf_tpu_torch as prt
from ferreus_rbf_tpu_torch.utils import timing


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU's cores, and a torch thread pool per worker oversubscribes them;
    the port's CPU fits, thousands of small parallel regions, then spend
    their time in thread barriers and run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _iter_params(mod, kernel_type, leaf=300, coarse=800):
    params = mod.Params.builder(kernel_type).naive_solve_threshold(1000).build()
    params.ddm_params = mod.DDMParams(
        leaf_threshold=leaf, overlap_quota=0.5, coarse_ratio=0.25, coarse_threshold=coarse,
    )
    return params


@pytest.fixture(scope="module")
def fits():
    pts = jrt.generate_random_points(5000, 3, seed=42)
    vals = jrt.RBFTestFunctions.f1_3d(pts)
    jfit = jrt.RBFInterpolator(
        pts, vals, jrt.InterpolantSettings(kernel_type=jrt.RBFKernelType.Linear),
        params=_iter_params(jrt, jrt.RBFKernelType.Linear),
    )
    tracer = timing.enable_global_tracer()
    try:
        pfit = prt.RBFInterpolator(
            pts, vals, prt.InterpolantSettings(kernel_type=prt.RBFKernelType.Linear),
            params=_iter_params(prt, prt.RBFKernelType.Linear), device="cpu",
        )
    finally:
        timing.disable_global_tracer()
    grid = jrt.create_evaluation_grid([(0.1, 0.9)] * 3, [9, 9, 9])
    return {"pts": pts, "vals": vals, "jax": jfit, "port": pfit, "grid": grid,
            "events": tracer.events}


def test_port_fit_source_residual(fits):
    resid = np.max(np.abs(fits["port"].evaluate_at_source(True) - fits["vals"]))
    assert resid < 5e-6, resid


def test_jax_fit_source_residual(fits):
    resid = np.max(np.abs(fits["jax"].evaluate_at_source(True) - fits["vals"]))
    assert resid < 5e-6, resid


def test_port_fit_reports_converged_residual(fits):
    done = [e for e in fits["events"] if e["event"] == "solve_done"]
    assert done and done[-1]["converged"] and done[-1]["residual"] <= 1e-6


def test_grid_values_of_both_fits_agree(fits):
    want = fits["jax"].evaluate(fits["grid"])
    got = fits["port"].evaluate(fits["grid"])
    assert got.shape == want.shape == (fits["grid"].shape[0],)
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(fits["vals"]))


def test_from_numpy_state_reproduces_jax_evaluate(fits):
    j = fits["jax"]
    model = prt.RBFInterpolator.from_numpy_state(
        j.points, j.point_values,
        prt.InterpolantSettings(kernel_type=prt.RBFKernelType.Linear),
        j.coefficients.point_coefficients, j.coefficients.poly_coefficients,
        j.translation_factor, j.scale_factor,
        params=_iter_params(prt, prt.RBFKernelType.Linear), device="cpu",
    )
    want = j.evaluate(fits["grid"])
    got = model.evaluate(fits["grid"])
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-11


def test_direct_fit_matches_jax():
    """Below naive_solve_threshold both packages factor one host domain:
    the same f64 arithmetic, so the coefficients agree to rounding."""
    pts = jrt.generate_random_points(400, 2, seed=3)
    vals = jrt.RBFTestFunctions.franke_2d(pts)
    jfit = jrt.RBFInterpolator(
        pts, vals, jrt.InterpolantSettings(kernel_type=jrt.RBFKernelType.ThinPlateSpline))
    pfit = prt.RBFInterpolator(
        pts, vals, prt.InterpolantSettings(kernel_type=prt.RBFKernelType.ThinPlateSpline),
        device="cpu")
    want = jfit.coefficients.point_coefficients
    got = pfit.coefficients.point_coefficients
    assert np.max(np.abs(got - want)) <= 1e-9 * np.max(np.abs(want))
    np.testing.assert_allclose(pfit.coefficients.poly_coefficients,
                               jfit.coefficients.poly_coefficients, rtol=1e-9, atol=1e-12)


def test_stationary_ddm_solver_converges():
    pts = prt.generate_random_points(2500, 2, seed=5)
    vals = prt.RBFTestFunctions.franke_2d(pts)
    params = _iter_params(prt, prt.RBFKernelType.ThinPlateSpline, leaf=200, coarse=500)
    params.solver_type = prt.Solvers.DDM
    rbfi = prt.RBFInterpolator(
        pts, vals, prt.InterpolantSettings(kernel_type=prt.RBFKernelType.ThinPlateSpline),
        params=params, device="cpu",
    )
    resid = np.max(np.abs(rbfi.evaluate_at_source(True) - vals))
    assert resid < 5e-6, resid


def test_tps_drift_fit_2d():
    """Linear drift (k = 3 special points per domain): QTAQ-reduced Schwarz
    domains, the polynomial block of the operator, and its coefficients."""
    pts = prt.generate_random_points(3000, 2, seed=1)
    vals = prt.RBFTestFunctions.franke_2d(pts)
    rbfi = prt.RBFInterpolator(
        pts, vals, prt.InterpolantSettings(kernel_type=prt.RBFKernelType.ThinPlateSpline),
        params=_iter_params(prt, prt.RBFKernelType.ThinPlateSpline), device="cpu",
    )
    assert rbfi.coefficients.poly_coefficients.shape == (3, 1)
    resid = np.max(np.abs(rbfi.evaluate_at_source(True) - vals))
    assert resid < 5e-6, resid


@pytest.mark.parametrize("offset", [0.0, 3.3e5, 7.7e6])
def test_f32_factors_keep_real_world_coordinates(offset):
    """A batch of Schwarz blocks of close points (spacing ~1, as in the
    albatite dataset) factored in f32 at world offsets up to a northing of
    7.7e6 (where f32 resolves 0.5): the factors stay those of the points at
    the origin, within f32 rounding of the block."""
    import torch

    from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType
    from ferreus_rbf_tpu_torch.solver.ddm import factor_bucket

    rng = np.random.default_rng(12)
    pts = torch.as_tensor(rng.random((4, 96, 3)) * 20.0)
    mask = torch.ones((4, 96), dtype=torch.bool)
    mask[3, 80:] = False
    q_top = torch.zeros((4, 1, 95), dtype=torch.float64)
    q_top[:] = -1.0  # the constant drift's Q_top: one special point
    q_top[3, :, 79:] = 0.0  # the padded columns of the 80-point domain
    kw = dict(kparams=KernelParams(KernelType.LinearRbf), nugget=0.0, k=1,
              dtype=torch.float32)
    want, want_failed = factor_bucket(pts, mask, q_top, **kw)
    got, failed = factor_bucket(pts + offset, mask, q_top, **kw)
    assert not bool(want_failed.any()) and not bool(failed.any())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_host_refactor_indefinite_block_falls_back_spd():
    """A genuinely indefinite leaf block (TPS without QTAQ reduction) comes
    back as a finite SPD factor: the shift loop cannot rescue it, so the
    spectral-clip fallback engages (``tests/test_solver.py`` for the JAX
    package)."""
    import torch

    from ferreus_rbf_tpu_torch.solver.ddm import DDMTree, LeafPlan

    n, s_pad = 24, 32
    pts = prt.generate_random_points(n, 2, seed=3)
    stub = DDMTree.__new__(DDMTree)
    stub.points = pts
    stub.settings = prt.InterpolantSettings(kernel_type=prt.RBFKernelType.ThinPlateSpline)
    plan = LeafPlan(np.arange(n), np.ones(n, bool),
                    np.concatenate([pts.min(0), pts.max(0)]), None, 0)
    chol = torch.full((1, s_pad, s_pad), float("nan"), dtype=torch.float32)
    stub._host_refactor([plan], chol, np.array([0]), 0)
    low = chol[0, :n, :n].double().numpy()
    assert torch.isfinite(chol).all()
    assert np.allclose(low, np.tril(low)) and (np.diag(low) > 0).all()


def test_port_imports_without_jax():
    code = (
        "import sys, ferreus_rbf_tpu_torch\n"
        "from ferreus_rbf_tpu_torch.solver import iterative\n"
        "from ferreus_rbf_tpu_torch import bbfmm\n"
        "from ferreus_rbf_tpu_torch.ops.fmm import diagnostics\n"
        "from ferreus_rbf_tpu_torch.ops.fmm import api, near_field\n"
        "from ferreus_rbf_tpu_torch import isosurfacing, rmt\n"
        "from ferreus_rbf_tpu_torch.rmt import isosurface, seed_projection\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ferreus_rbf_tpu' or m.startswith('ferreus_rbf_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
