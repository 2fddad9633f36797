"""The harness on the CPU: every cell resolves by name, each driver runs a
tiny cell against the plain reference, a cell added as files is found, the
result line has the contract's keys, and no run loads JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness

from conftest import ROOT, add_cell

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "card", "checks"]
SEED = 2**31 + 12345  # past 32 signed bits


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves_by_name(name):
    cell = harness.Cell(name, SEED, 1, 0)
    assert cell.config["name"] == cell.entry["config"]
    for fn in ("setup", "step", "release", "check"):
        assert callable(getattr(cell.driver, fn))
    assert set(cell.workload["limits"]) and all(v > 0 for v in cell.workload["limits"].values())
    for kind in ("end_to_end", "per_layer"):
        for m in cell.metrics(kind):
            assert callable(harness.metric_reader(cell, m["name"]).read)
    assert os.path.exists(cell.path("generators", f"{cell.config['data']['kind']}.py"))
    assert {m["name"] for m in cell.metrics("end_to_end")} >= {"setup_s", "peak_device_gb"}
    assert cell.metrics("per_layer")


def test_every_file_belongs_to_an_entry():
    bench = _bench()
    cells = {w["name"] for w in bench["workloads"]}
    found = {f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark", "workloads"))}
    assert found == cells
    metrics = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    found = {f[:-3] for f in os.listdir(os.path.join(ROOT, "benchmark", "metrics"))
             if f.endswith(".py")}
    # a reader is a metric's own file, or its stem's, shared by every suffix
    assert found == {m if m in found else m.split(".")[0] for m in metrics}
    kinds = set()
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            kinds.add(json.load(fh)["data"]["kind"])
    found = {f[:-3] for f in os.listdir(os.path.join(ROOT, "benchmark", "generators"))
             if f.endswith(".py")}
    assert found == kinds


@pytest.mark.parametrize("name,trace", [("tiny.albatite.fit", 0), ("tiny.sdf.fit", 1),
                                        ("tiny.grid_eval", 0), ("tiny.grid_eval", 1)])
def test_driver_against_reference_on_cpu(scratch, name, trace):
    cell = harness.Cell(name, SEED, 0.01, trace, root=scratch, device="cpu")
    run = harness.measure(cell)
    checks = harness.judge(cell)
    line = harness.result(cell, run, checks)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] == run.steps >= 1
    keys = RESULT_KEYS[:5] + ["breakdown"] * trace + RESULT_KEYS[5:]
    assert list(line) == keys  # "checks" comes last
    assert line["device"]["platform"] == "cpu"  # never a device metric from the CPU
    assert "peak_device_gb" not in line["metrics"]
    assert not any(k.startswith(("nf_roofline", "idle_share")) for k in line["metrics"])
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(v["value"] >= 0 for v in line["metrics"].values())
    else:
        assert line["metrics"]["setup_s"]["value"] > 0


def test_added_cell_is_found_without_code(scratch):
    add_cell(scratch, "added.fit", "sdf_tiny", "fit_loop",
             {"driver": "fit", "pool": 1, "check_rows": 300, "limits": {"resid_l2": 2e-5}})
    cell = harness.Cell("added.fit", 7, 0.0, 0, root=scratch, device="cpu")
    assert "fit_s" in {m["name"] for m in cell.metrics("end_to_end")}
    assert "solve_s.fit" in {m["name"] for m in cell.metrics("per_layer")}
    run = harness.measure(cell)
    assert run.steps == 1 and harness.judge(cell)["resid_l2"][0] < 2e-5


def test_same_seed_same_inputs(scratch):
    from benchmark import inputs

    a = harness.Cell("tiny.sdf.fit", SEED, 0, 0, root=scratch, device="cpu")
    b = harness.Cell("tiny.sdf.fit", SEED, 0, 0, root=scratch, device="cpu")
    c = harness.Cell("tiny.sdf.fit", SEED + 1, 0, 0, root=scratch, device="cpu")
    pa, pb, pc = (inputs.points_and_values(x, "fit", 0)[0] for x in (a, b, c))
    assert (pa == pb).all() and not (pa == pc).all()


def test_run_without_a_card_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "albatite.fit",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "no CUDA card" in proc.stderr


def test_a_run_loads_no_jax(scratch):
    code = f"""
import sys, json
sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, "benchmark")!r}]
import benchmark.run, benchmark.control, benchmark.tracing
from benchmark import harness
cell = harness.Cell("tiny.grid_eval", 3, 0.0, 1, root={scratch!r}, device="cpu")
run = harness.measure(cell)
harness.result(cell, run, harness.judge(cell))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(json.loads(proc.stdout.splitlines()[-1]))
    assert "ferreus_rbf_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "ferreus_rbf_tpu"}
