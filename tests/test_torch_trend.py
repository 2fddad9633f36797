"""Global trends on the port against the JAX package, on the CPU.

Tolerances:

* the transforms are the same numpy operations in both packages: bitwise;
* direct fits (one host domain, the same f64 arithmetic): coefficients
  within 1e-9 relative (``test_direct_fit_matches_jax``);
* iterative fits (~1,500 points, ``naive_solve_threshold(1000)`` and the
  leaf settings of ``tests/test_torch_fit.py``): source residuals < 5e-6
  for each package, grid values within 1e-5 of max |values| of each other
  (both solve to a 1e-6 relative l2 residual by different Krylov paths),
  and one set of fitted arrays evaluated by both within 1e-11 relative;
* gradients against central finite differences: rtol 1e-4, atol 1e-6
  (``tests/test_rbf_dense.py``).
"""

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

TRENDS = [
    ("one", (1.7,)),
    ("one", (0.6,)),
    ("two", (0.0, 2.0, 1.0)),
    ("two", (37.5, 1.5, 0.8)),
    ("two", (-120.0, 3.0, 1.25)),
    ("three", (30.0, 45.0, 0.0, 2.0, 1.5, 1.0)),
    ("three", (20.0, 30.0, 10.0, 1.5, 1.2, 1.0)),
    ("three", (75.0, 210.0, -35.0, 4.0, 2.0, 0.5)),
]
DIMS = {"one": 1, "two": 2, "three": 3}


def _pair(kind, args, dims):
    rng = np.random.default_rng(DIMS[kind] * 10 + len(args))
    center = rng.random(dims) * 10.0
    make = lambda mod: mod.GlobalTrendTransform(  # noqa: E731
        center, getattr(mod.GlobalTrend, kind)(*args))
    return make(jrt), make(prt)


@pytest.mark.parametrize("kind, args", TRENDS)
def test_trend_transform_matches_jax_bitwise(kind, args):
    dims = DIMS[kind]
    jt, pt = _pair(kind, args, dims)
    pts = np.random.default_rng(3).random((50, dims)) * 20.0 - 5.0
    assert np.array_equal(pt.affine_transform, jt.affine_transform)
    assert np.array_equal(pt.inverse_transform, jt.inverse_transform)
    assert np.array_equal(pt.transform_points(pts), jt.transform_points(pts))
    assert np.array_equal(pt.inverse_transform_points(pts), jt.inverse_transform_points(pts))
    assert np.array_equal(pt.linear_part(dims), jt.linear_part(dims))
    back = pt.inverse_transform_points(pt.transform_points(pts))
    assert np.max(np.abs(back - pts)) < 1e-12 * np.max(np.abs(pts))


@pytest.mark.parametrize("kind, args", TRENDS[::3])
def test_trend_dict_round_trip(kind, args):
    dims = DIMS[kind]
    _, pt = _pair(kind, args, dims)
    again = prt.GlobalTrendTransform.from_dict(pt.to_dict())
    pts = np.random.default_rng(4).random((20, dims))
    assert np.array_equal(again.affine_transform, pt.affine_transform)
    assert np.array_equal(again.inverse_transform, pt.inverse_transform)
    assert np.array_equal(again.transform_points(pts), pt.transform_points(pts))


DIRECT = [
    (1, "one", (2.0,), "Cubic"),
    (2, "two", (30.0, 2.0, 1.0), "ThinPlateSpline"),
    (3, "three", (30.0, 45.0, 10.0, 2.0, 1.5, 1.0), "Linear"),
]


@pytest.mark.parametrize("dims, kind, args, kernel", DIRECT)
def test_direct_trend_fit_matches_jax(dims, kind, args, kernel):
    rng = np.random.default_rng(dims)
    pts = rng.random((300, dims))
    vals = np.sin(3.0 * pts).sum(axis=1) + pts[:, 0] ** 2
    fits = {}
    for mod, kw in ((jrt, {}), (prt, {"device": "cpu"})):
        settings = mod.InterpolantSettings(kernel_type=getattr(mod.RBFKernelType, kernel))
        fits[mod] = mod.RBFInterpolator(pts, vals, settings,
                                        global_trend=getattr(mod.GlobalTrend, kind)(*args), **kw)
    j, p = fits[jrt], fits[prt]
    want, got = j.coefficients.point_coefficients, p.coefficients.point_coefficients
    assert np.max(np.abs(got - want)) <= 1e-9 * np.max(np.abs(want))
    np.testing.assert_allclose(p.coefficients.poly_coefficients,
                               j.coefficients.poly_coefficients, rtol=1e-9, atol=1e-12)
    assert np.array_equal(p.points, j.points)  # inverse-transformed after the solve
    targets = rng.random((30, dims))
    assert np.max(np.abs(p.evaluate(targets) - j.evaluate(targets))) <= 1e-9 * np.max(np.abs(vals))


def _iter_params(mod, kernel_type):
    """``tests/test_torch_fit.py``'s iterative settings, at p = 7 (LinearRbf's
    default order; CubicRbf's higher default would triple the test's time)."""
    params = mod.Params.builder(kernel_type).naive_solve_threshold(1000).build()
    params.ddm_params = mod.DDMParams(
        leaf_threshold=300, overlap_quota=0.5, coarse_ratio=0.25, coarse_threshold=800,
    )
    params.fmm_params.interpolation_order = 7
    params.fmm_params.epsilon = 1e-7
    return params


ITERATIVE = {
    "linear": ("Linear", None),
    "cubic_linear_drift": ("Cubic", "Linear"),
}


def _settings(mod, kernel, drift):
    kw = {"kernel_type": getattr(mod.RBFKernelType, kernel)}
    if drift is not None:
        kw["drift"] = getattr(mod.Drift, drift)
    return mod.InterpolantSettings(**kw)


@pytest.fixture(scope="module", params=sorted(ITERATIVE))
def iter_fits(request):
    kernel, drift = ITERATIVE[request.param]
    pts = jrt.generate_random_points(1500, 3, seed=8)
    vals = jrt.RBFTestFunctions.f1_3d(pts)
    trend = (30.0, 45.0, 0.0, 2.0, 1.5, 1.0)
    jfit = jrt.RBFInterpolator(
        pts, vals, _settings(jrt, kernel, drift),
        params=_iter_params(jrt, getattr(jrt.RBFKernelType, kernel)),
        global_trend=jrt.GlobalTrend.three(*trend))
    tracer = timing.enable_global_tracer()
    try:
        pfit = prt.RBFInterpolator(
            pts, vals, _settings(prt, kernel, drift),
            params=_iter_params(prt, getattr(prt.RBFKernelType, kernel)),
            global_trend=prt.GlobalTrend.three(*trend), device="cpu")
    finally:
        timing.disable_global_tracer()
    grid = jrt.create_evaluation_grid([(0.1, 0.9)] * 3, [7, 7, 7])
    return {"pts": pts, "vals": vals, "jax": jfit, "port": pfit, "grid": grid,
            "kernel": kernel, "drift": drift, "events": tracer.events}


def test_iterative_trend_fit_source_residuals(iter_fits):
    for key in ("jax", "port"):
        resid = np.max(np.abs(iter_fits[key].evaluate_at_source(True) - iter_fits["vals"]))
        assert resid < 5e-6, (key, resid)
    done = [e for e in iter_fits["events"] if e["event"] == "solve_done"]
    assert done and done[-1]["converged"] and done[-1]["residual"] <= 1e-6


def test_iterative_trend_fit_grid_values_agree(iter_fits):
    want = iter_fits["jax"].evaluate(iter_fits["grid"])
    got = iter_fits["port"].evaluate(iter_fits["grid"])
    assert got.shape == want.shape == (iter_fits["grid"].shape[0],)
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(iter_fits["vals"]))


def test_from_numpy_state_with_trend_reproduces_jax(iter_fits):
    j = iter_fits["jax"]
    assert j.coefficients.poly_coefficients is not None  # the trended drift is exercised
    settings = _settings(prt, iter_fits["kernel"], iter_fits["drift"])
    model = prt.RBFInterpolator.from_numpy_state(
        j.points, j.point_values, settings, j.coefficients.point_coefficients,
        j.coefficients.poly_coefficients, j.translation_factor, j.scale_factor,
        params=_iter_params(prt, settings.kernel_type), device="cpu",
        global_trend=j.global_trend.to_dict(),
    )
    grid = iter_fits["grid"]
    want = j.evaluate(grid)
    assert np.max(np.abs(model.evaluate(grid) - want)) / np.max(np.abs(want)) < 1e-11
    wv, wg = j.evaluate_with_gradients(grid)
    gv, gg = model.evaluate_with_gradients(grid)
    assert gg.shape == wg.shape == (grid.shape[0], 3)
    assert np.max(np.abs(gv - wv)) / np.max(np.abs(wv)) < 1e-11
    assert np.max(np.abs(gg - wg)) / np.max(np.abs(wg)) < 1e-11


def test_m_step_diagnostic_records_event(iter_fits):
    """The stashed diagnostic keeps the fit's host inputs, not its device
    system (no DeviceSystem outlives the fit), and rebuilds it when called."""
    import gc

    from ferreus_rbf_tpu_torch.solver.iterative import DeviceSystem

    gc.collect()
    assert not any(type(o) is DeviceSystem for o in gc.get_objects())
    rbfi = iter_fits["port"]
    tracer = timing.enable_global_tracer()
    try:
        out = rbfi.m_step_diagnostic()
    finally:
        timing.disable_global_tracer()
    keys = {"one_m_step_residual_f32", "one_m_step_residual_f64grade",
            "matvec_tier_discrepancy_on_Mb"}
    assert set(out) == keys and all(np.isfinite(v) for v in out.values())
    events = [e for e in tracer.events if e["event"] == "m_step"]
    assert len(events) == 1 and {k: events[0][k] for k in keys} == out
    assert rbfi.m_step_diagnostic() == out  # no tracer: the same numbers, no event


def test_trend_gradients_match_finite_differences():
    rng = np.random.default_rng(5)
    points = rng.random((300, 3))
    values = prt.RBFTestFunctions.f1_3d(points)
    trend = prt.GlobalTrend.three(dip=30.0, dip_direction=45.0, pitch=10.0,
                                  major_ratio=2.0, semi_major_ratio=1.5, minor_ratio=1.0)
    rbfi = prt.RBFInterpolator(points, values, prt.InterpolantSettings(
        kernel_type=prt.RBFKernelType.Linear), global_trend=trend, device="cpu")
    assert np.max(np.abs(rbfi.evaluate(points) - values)) < 1e-8
    targets = 0.2 + 0.6 * rng.random((10, 3))
    _, grads = rbfi.evaluate_with_gradients(targets)
    h = 1e-6
    for d in range(3):
        tp, tm = targets.copy(), targets.copy()
        tp[:, d] += h
        tm[:, d] -= h
        fd = (rbfi.evaluate(tp) - rbfi.evaluate(tm)) / (2 * h)
        np.testing.assert_allclose(grads[:, d], fd, rtol=1e-4, atol=1e-6)
