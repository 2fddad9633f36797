"""The ``matvec`` cell on the CPU at a tiny size: its driver runs the public
``bbfmm.FmmTree`` against the plain multi-RHS sum (``reference/
kernel_sum.py``) and passes the port, its traced run reads the new
per-layer metrics, and its check fails the control (the FMM at order 4
where the configuration states 5), float32 (the port's own f32 passes and
the plain sum in float32) and each planted fault of ``control_matvec.py``. ``kernel_sum`` agrees with ``field.dense_field``
column by column for every kernel type the latter knows.

The tiny configuration is ``bbfmm_linear_100k_p5`` at 3,000 points with
leaves of at most 32 (a depth-3 uniform tree with M2L levels). Its limits
lie between the port's readings and the others' at this size (read on the
CPU: ``value_err`` the port 1.8e-05, order 4 7.7e-05, the faults 5.2e-02
and above; ``linearity_err`` the port 2.8e-15, float32 7.7e-07 and above).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark import control_matvec, harness, inputs
from benchmark.reference import field, kernel_sum

from conftest import add_cell

SEED = 2**31 + 4242
TINY = "tiny.matvec100k"


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def matvec_root(scratch):
    """The scratch copy with the tiny configuration and its cell."""
    with open(os.path.join(scratch, "benchmark", "configs", "bbfmm_linear_100k_p5.json")) as fh:
        config = json.load(fh)
    config.update(name="bbfmm_tiny", points=3000)
    config["fmm"]["max_points_per_cell"] = 32
    with open(os.path.join(scratch, "benchmark", "configs", "bbfmm_tiny.json"), "w") as fh:
        json.dump(config, fh)
    path = os.path.join(scratch, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "bbfmm_tiny", "source": "tests", "reduced": ["points"],
                             "file": "benchmark/configs/bbfmm_tiny.json", "why": "tests"})
    with open(path, "w") as fh:
        json.dump(bench, fh)
    add_cell(scratch, TINY, "bbfmm_tiny", "matvec_loop",
             {"driver": "matvec", "pool": 2, "check_rows": 300, "limits": {"value_err": 4e-5, "linearity_err": 1e-10}})
    return scratch


def _run(root, variant="program", trace=0):
    cell = harness.Cell(TINY, SEED, 0.0, trace, root=root, device="cpu")
    with control_matvec.substituted(variant, inputs.reference_kernel(cell)):
        run = harness.measure(cell)
    return harness.result(cell, run, harness.judge(cell))


@pytest.mark.parametrize("trace", [0, 1])
def test_driver_passes_the_port_on_cpu(matvec_root, trace):
    line = _run(matvec_root, trace=trace)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"
    metrics = line["metrics"]
    if trace:
        assert metrics["targets_binned.matvec"]["value"] == 3000
        assert metrics["h2d_gb.matvec"]["value"] > 3000 * 8 * 8 / 1e9  # the weights and more
        for name in ("fmm_upward_s.matvec", "fmm_pass_s.eval", "fmm_plan_s.eval"):
            assert metrics[name]["value"] > 0
        assert not any(k.startswith(("nf_roofline", "idle_share")) for k in metrics)  # no card
    else:
        assert metrics["eval_points_per_s"]["value"] > 0 and metrics["setup_s"]["value"] > 0


@pytest.mark.parametrize("variant", ("order4",) + control_matvec.FAULTS)
def test_control_and_faults_are_not_correct(matvec_root, variant):
    line = _run(matvec_root, variant)
    assert not line["correct"]
    assert line["checks"]["value_err"]["value"] > line["checks"]["value_err"]["limit"]


@pytest.mark.parametrize("variant", ("f32", "reference_f32"))
def test_float32_is_not_correct(matvec_root, variant):
    """The truncation hides float32 from ``value_err``; ``linearity_err``
    cancels it."""
    line = _run(matvec_root, variant)
    assert not line["correct"]
    check = line["checks"]["linearity_err"]
    assert check["value"] > check["limit"]


KERNELS = [{"type": "Linear"}, {"type": "ThinPlateSpline"}, {"type": "Cubic"},
           {"type": "Spheroidal", "order": 3, "base_range": 0.6, "total_sill": 0.5},
           {"type": "Spheroidal", "order": 9, "base_range": 0.6, "total_sill": 0.5}]


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: f"{k['type']}{k.get('order', '')}")
def test_kernel_sum_matches_dense_field_by_column(kernel):
    rng = np.random.default_rng(8)
    src, tgt = rng.random((300, 3)), np.concatenate([rng.random((40, 3)), rng.random((5, 3))])
    tgt[-5:] = src[:5]  # r = 0 included
    w = rng.standard_normal((300, 4))
    got = kernel_sum.kernel_sum(kernel, src, w, tgt)
    assert got.shape == (45, 4)
    for c in range(4):
        want = field.dense_field(kernel, src, w[:, c], tgt)
        np.testing.assert_allclose(got[:, c], want, rtol=1e-13, atol=1e-13)
    one = kernel_sum.kernel_sum(kernel, src, w[:, 0], tgt)  # 1-D weights: a 1-D sum
    assert one.shape == (45,)
    np.testing.assert_allclose(one, got[:, 0], rtol=1e-13, atol=1e-13)
