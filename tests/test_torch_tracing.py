"""The port's tracer (``utils/timing.py``) on the CPU: spans with ids and
parents, counters and the ``counters`` event of each outermost span, the
host-to-device helper, muted events, and that tracing changes no result.

The fits are those of ``tests/test_torch_fused.py`` (1,500 random 3-D
points, ThinPlateSpline, the iterative path forced), with FMM leaves of at
most 64 points so that the tree has M2L levels; on the CPU the fused
cycle runs eagerly. Counts are compared exactly and results bitwise.
"""

import inspect
import os
import re

import numpy as np
import pytest
import torch

import ferreus_rbf_tpu_torch as prt
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops.fmm import m2l
from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree
from ferreus_rbf_tpu_torch.progress import SolverIteration
from ferreus_rbf_tpu_torch.utils import timing

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "ferreus_rbf_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU's cores, and a torch thread pool per worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    timing.disable_global_tracer()


def _case():
    rng = np.random.default_rng(21)
    pts = rng.random((1500, 3))
    vals = np.sin(4 * pts[:, 0]) * np.cos(3 * pts[:, 1]) + 0.5 * pts[:, 2]
    settings = prt.InterpolantSettings(
        kernel_type=prt.RBFKernelType.ThinPlateSpline,
        fitting_accuracy=prt.FittingAccuracy(1e-6, prt.FittingAccuracyType.Relative))
    params = prt.Params(
        ddm_params=prt.DDMParams(leaf_threshold=128, coarse_ratio=0.5, coarse_threshold=400),
        fmm_params=prt.FmmParams(max_points_per_cell=64),
        naive_solve_threshold=0)
    return pts, vals, settings, params


def _bytes_sent(data, dtype):
    """The bytes that placing ``data`` on the CPU device as ``dtype`` sends,
    counted from the host data alone: a tensor there already sends
    nothing; anything else sends its numpy array's ``nbytes`` after the
    conversion to ``dtype`` (to torch's default dtype for Python floats)."""
    if isinstance(data, torch.Tensor):
        return 0
    arr = np.asarray(data)
    if dtype is not None:
        arr = arr.astype(torch.empty(0, dtype=dtype).numpy().dtype)
    elif isinstance(data, (float, list, tuple)) and arr.dtype.kind == "f":
        arr = arr.astype(torch.empty(0).numpy().dtype)
    return arr.nbytes


def _fit_and_evaluate(path, traced, record=None):
    """(fit, evaluate's values, tracer or None, progress messages) of one
    fit on ``path`` ("fused" or "host") and one ``evaluate``, from a cold
    memo of compressed M2L levels."""
    m2l.clear_cache()
    pts, vals, settings, params = _case()
    targets = np.random.default_rng(3).random((300, 3))
    messages = []
    tracer = timing.enable_global_tracer() if traced else None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FERREUS_RBF_TPU_FUSED", "1" if path == "fused" else "0")
        if record is not None:
            as_tensor = torch.as_tensor

            def recording(data, *args, **kw):
                if inspect.currentframe().f_back.f_code is timing.to_device.__code__:
                    record.append(_bytes_sent(data, kw.get("dtype")))
                return as_tensor(data, *args, **kw)

            mp.setattr(torch, "as_tensor", recording)
        try:
            fit = prt.RBFInterpolator(pts, vals, settings, params, device="cpu",
                                      progress_callback=prt.Progress(messages.append))
            values = fit.evaluate(targets)
        finally:
            timing.disable_global_tracer()
    return fit, values, tracer, messages


@pytest.fixture(scope="module")
def fits():
    record = []
    out = {"record": record,
           "fused": _fit_and_evaluate("fused", True, record),
           "host": _fit_and_evaluate("host", True),
           "fused_off": _fit_and_evaluate("fused", False)}
    return out


def _counters_events(tracer):
    return [e for e in tracer.events if e["event"] == "counters"]


def test_spans_nest_with_ids_and_parents():
    tracer = timing.enable_global_tracer()
    with timing.traced_stage("a"):
        with timing.traced_stage("b"):
            with timing.traced_stage("c"):
                pass
        with timing.traced_stage("b"):
            pass
    with timing.traced_stage("d"):
        pass
    spans = {s[0]: s for s in tracer.spans}
    assert sorted(spans) == list(range(5))
    parents = {sid: (name, None if pid is None else spans[pid][2])
               for sid, pid, name, *_ in tracer.spans}
    assert sorted(parents.values(), key=str) == sorted(
        [("a", None), ("b", "a"), ("c", "b"), ("b", "a"), ("d", None)], key=str)
    for sid, pid, name, start, host_end, end in tracer.spans:
        assert start <= host_end <= end
        if pid is not None:  # a child lies inside its parent
            assert spans[pid][3] <= start and end <= spans[pid][5]
    rows = tracer.report().splitlines()
    assert rows[0].split() == ["stage", "calls", "total", "host", "wait"]
    assert [r[: len(r) - len(r.lstrip())].count(" ") for r in rows[1:]] == [0, 2, 4, 0]
    assert [r.split()[:2] for r in rows[1:]] == [["a", "1"], ["b", "2"], ["c", "1"], ["d", "1"]]


def test_stage_keeps_one_argument():
    """A wrapper of one argument may stand in for ``Tracer.stage`` and still
    see every stage (the benchmark swaps one in)."""
    assert list(inspect.signature(timing.Tracer.stage).parameters) == ["self", "name"]
    tracer = timing.enable_global_tracer()
    inner, seen = tracer.stage, []

    def stage(name):
        seen.append(name)
        return inner(name)

    tracer.stage = stage
    with timing.traced_stage("outer"):
        with timing.traced_stage("inner"):
            timing.count("n", 3)
    assert seen == ["outer", "inner"] and [s[2] for s in tracer.spans] == ["inner", "outer"]
    assert _counters_events(tracer)[0]["n"] == 3


def test_counters_roll_up_to_the_outermost_span():
    tracer = timing.enable_global_tracer()
    timing.count("loose")  # outside any stage: the total only
    with timing.traced_stage("top"):
        timing.count("x")
        with timing.traced_stage("mid"):
            timing.count("x", 2)
            timing.count("y", 5)
    (event,) = _counters_events(tracer)
    assert event["span"] == "top" and event["seconds"] >= 0
    assert (event["x"], event["y"]) == (3, 5) and "loose" not in event
    assert dict(tracer.counters) == {"loose": 1, "x": 3, "y": 5}


def test_count_is_a_no_op_when_off():
    timing.disable_global_tracer()
    timing.count("x")
    out = timing.to_device(np.ones(4), "cpu")
    assert timing.global_tracer() is None and out.dtype == torch.float64


def test_events_stay_muted_under_muted_events():
    tracer = timing.enable_global_tracer()
    with timing.muted_events():
        with timing.traced_stage("quiet"):
            timing.count("x", 2)
            timing.record_event("solve_done", {"converged": True})
    with timing.muted_events(False):
        with timing.traced_stage("loud"):
            timing.count("x")
    assert [e["span"] for e in tracer.events] == ["loud"]
    assert tracer.counters["x"] == 3 and tracer.totals.keys() == {"quiet", "loud"}


def test_to_device_counts_the_bytes_it_copies():
    tracer = timing.enable_global_tracer()
    on_device = torch.ones(10, dtype=torch.float64)
    parts = [timing.to_device(np.ones((7, 3)), "cpu"),
             timing.to_device(np.ones(5, bool), "cpu"),
             timing.to_device(np.ones(6), "cpu", torch.float32),  # converted on the host
             timing.to_device(2.5, "cpu", torch.float64),
             timing.to_device(on_device, "cpu")]  # already there: nothing crosses
    assert parts[-1] is on_device and parts[2].dtype == torch.float32
    assert tracer.counters["h2d_bytes"] == 7 * 3 * 8 + 5 + 6 * 4 + 8


@pytest.mark.parametrize("d", [2, 3])
def test_m2l_operators_per_tree_build(d):
    """(depth - 1) x the reference vectors of ``d`` dimensions per tree, from
    a cold memo of compressed M2L levels."""
    m2l.clear_cache()
    pts = np.random.default_rng(d).random((4000, d))
    tracer = timing.enable_global_tracer()
    tree = FmmTree(pts, 4, tk.KernelParams(tk.KernelType("ThinPlateSplineRbf")),
                   params=prt.FmmParams(interpolation_order=4, max_points_per_cell=32,
                                        epsilon=1e-4), device="cpu")
    assert tree.tree.depth >= 3
    refs = m2l.reference_m2l_vectors(d).shape[0]
    assert tracer.counters["m2l_operators"] == (tree.tree.depth - 1) * refs
    assert tracer.totals["fmm_m2l_build"] > 0


def test_counters_event_once_per_fit_and_evaluate(fits):
    _, _, tracer, _ = fits["fused"]
    events = _counters_events(tracer)
    assert [e["span"] for e in events] == ["fit", "evaluate"]
    for key in ("fgmres_iters", "m2l_operators", "m2l_cache_hits", "h2d_bytes"):
        assert sum(e.get(key, 0) for e in events) == tracer.counters[key] > 0
    for e in events:
        assert e.get("m2l_operators", 0) + e.get("m2l_cache_hits", 0) > 0
    # the evaluate's tree spans the fit's box: every level it needs, the fit built
    assert events[1].get("m2l_operators", 0) == 0
    assert events[1]["m2l_cache_hits"] == events[0]["m2l_operators"]
    for sid, pid, name, start, host_end, end in tracer.spans:
        assert start <= host_end <= end
    names = {s[0]: s[2] for s in tracer.spans}
    parent = {s[2]: names.get(s[1]) for s in tracer.spans}
    assert parent["fgmres_cycle"] == "solve_column" and parent["schwarz_apply"] == "fgmres_cycle"
    assert parent["fmm_m2l_build"] == "fmm_operators" and parent["fit"] is None


@pytest.mark.parametrize("path", ["fused", "host"])
def test_fgmres_iters_match_progress_messages(fits, path):
    _, _, tracer, messages = fits[path]
    steps = sum(isinstance(m, SolverIteration) for m in messages)
    assert tracer.counters["fgmres_iters"] == steps > 0
    assert tracer.totals["fgmres_cycle"] > 0 and tracer.totals["schwarz_apply"] > 0


def test_h2d_bytes_sum_what_passed_through_the_helper(fits):
    _, _, tracer, _ = fits["fused"]
    assert tracer.counters["h2d_bytes"] == sum(fits["record"]) > 0


def test_tracing_changes_no_result(fits):
    fit, values, _, _ = fits["fused"]
    fit_off, values_off, _, _ = fits["fused_off"]
    assert np.array_equal(fit.coefficients.point_coefficients,
                          fit_off.coefficients.point_coefficients)
    assert np.array_equal(fit.coefficients.poly_coefficients,
                          fit_off.coefficients.poly_coefficients)
    assert np.array_equal(values, values_off)


def test_models_solver_ops_copy_through_the_helper():
    """No ``torch.as_tensor(..., device=...)`` or ``torch.tensor(...,
    device=...)`` outside ``timing.to_device``, so ``h2d_bytes`` sees every
    explicit copy of the fit and evaluation paths."""
    direct = re.compile(r"torch\.(as_)?tensor\((?:[^()]|\([^()]*\))*device\s*=")
    found = []
    for sub in ("models", "solver", "ops"):
        for root, _, files in os.walk(os.path.join(PORT, sub)):
            for f in files:
                if f.endswith(".py"):
                    with open(os.path.join(root, f)) as fh:
                        found += [f"{f}: {m.group(0)}" for m in direct.finditer(fh.read())]
    assert found == []
