"""Model I/O and the builder on the port, against the JAX package, on the CPU.

Both packages write the ``ferreus_rbf.json`` v1 envelope. Tolerances: a
model saved and loaded by the port evaluates bitwise equal (the same
arrays, the same tree); across packages the evaluations agree within
1e-11 relative (the same f64 arithmetic on both sides, summed in other
orders); the builder's fit equals the constructor's bitwise.
"""

import json

import numpy as np
import pytest
import torch

import ferreus_rbf_tpu as jrt
import ferreus_rbf_tpu_torch as prt


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

TREND = (20.0, 30.0, 10.0, 1.5, 1.2, 1.0)


def _fit(mod, trend, **kw):
    rng = np.random.default_rng(1)
    pts = rng.random((300, 3))
    vals = jrt.RBFTestFunctions.f4_3d(pts)
    settings = mod.InterpolantSettings(kernel_type=mod.RBFKernelType.Spheroidal,
                                       base_range=0.8, total_sill=0.7)
    return mod.RBFInterpolator(
        pts, vals, settings, global_trend=mod.GlobalTrend.three(*TREND) if trend else None,
        **kw)


@pytest.fixture(scope="module", params=[False, True], ids=["no_trend", "trend"])
def models(request):
    targets = np.random.default_rng(2).random((40, 3))
    return {"jax": _fit(jrt, request.param), "port": _fit(prt, request.param, device="cpu"),
            "targets": targets, "trend": request.param}


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def test_port_save_load_is_bitwise(models, tmp_path):
    rbfi, targets = models["port"], models["targets"]
    path = tmp_path / "m.json"
    rbfi.save_model(path)
    loaded = prt.RBFInterpolator.load_model(path, device="cpu")
    assert loaded.device.type == "cpu" and loaded._evaluator is None
    assert (loaded.global_trend is not None) == models["trend"]
    assert np.array_equal(loaded.evaluate(targets), rbfi.evaluate(targets))
    for got, want in zip(loaded.evaluate_with_gradients(targets),
                         rbfi.evaluate_with_gradients(targets)):
        assert np.array_equal(got, want)


def test_port_model_loads_in_jax(models, tmp_path):
    ppath, jpath = tmp_path / "port.json", tmp_path / "jax.json"
    models["port"].save_model(ppath)
    models["jax"].save_model(jpath)
    penv, jenv = json.loads(ppath.read_text()), json.loads(jpath.read_text())
    assert list(penv) == list(jenv)
    assert penv["format"] == "ferreus_rbf.json" and penv["version"] == 1
    loaded = jrt.RBFInterpolator.load_model(ppath)
    targets = models["targets"]
    assert _rel(loaded.evaluate(targets), models["port"].evaluate(targets)) < 1e-11


def test_jax_model_loads_in_port(models, tmp_path):
    path = tmp_path / "jax.json"
    models["jax"].save_model(path)
    loaded = prt.RBFInterpolator.load_model(path, device="cpu")
    targets = models["targets"]
    assert _rel(loaded.evaluate(targets), models["jax"].evaluate(targets)) < 1e-11
    got = loaded.evaluate_with_gradients(targets)
    want = models["jax"].evaluate_with_gradients(targets)
    assert all(_rel(g, w) < 1e-11 for g, w in zip(got, want))


def test_load_model_rejects_bad_envelopes(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"format": "other", "version": 1}))
    with pytest.raises(ValueError, match="unsupported format"):
        prt.RBFInterpolator.load_model(path, device="cpu")
    path.write_text(json.dumps({"format": "ferreus_rbf.json", "version": 99}))
    with pytest.raises(ValueError, match="unsupported version"):
        prt.RBFInterpolator.load_model(path, device="cpu")


def test_builder_equals_constructor_bitwise():
    rng = np.random.default_rng(6)
    pts = rng.random((250, 3))
    vals = prt.RBFTestFunctions.f1_3d(pts)
    settings = prt.InterpolantSettings(kernel_type=prt.RBFKernelType.Linear)
    params = prt.Params.new_defaults(prt.RBFKernelType.Linear)
    msgs = []
    built = (prt.RBFInterpolator.builder(pts, vals, settings, device="cpu")
             .params(params).global_trend(prt.GlobalTrend.three(*TREND))
             .progress_callback(prt.closure_sink(0, msgs.append)[0]).build())
    direct = prt.RBFInterpolator(pts, vals, settings, params=params,
                                 global_trend=prt.GlobalTrend.three(*TREND), device="cpu")
    assert msgs  # the builder's progress callback reached the fit
    assert built.device.type == "cpu" and built.params is params
    assert np.array_equal(built.points, direct.points)
    assert np.array_equal(built.coefficients.point_coefficients,
                          direct.coefficients.point_coefficients)
    assert np.array_equal(built.coefficients.poly_coefficients,
                          direct.coefficients.poly_coefficients)
    assert np.array_equal(built.global_trend.affine_transform,
                          direct.global_trend.affine_transform)


def test_coefficients_dict_round_trip():
    c = prt.Coefficients(np.arange(6.0).reshape(3, 2), np.ones((4, 2)))
    again = prt.Coefficients.from_dict(json.loads(json.dumps(c.to_dict())))
    assert np.array_equal(again.point_coefficients, c.point_coefficients)
    assert np.array_equal(again.poly_coefficients, c.poly_coefficients)
    bare = prt.Coefficients.from_dict(prt.Coefficients(np.zeros((2, 1))).to_dict())
    assert bare.poly_coefficients is None
