"""Fixtures of the benchmark's own tests: a scratch copy of the benchmark
with tiny CPU cells, and the card (decided inside a fixture, never while a
module is imported). Run them from the root of the repository:

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny cells of the two configurations, small enough for the CPU; their
# limits lie between the port's readings and its control's (the FMM at
# order 5) at these sizes: 1,500 albatite points (a direct solve) 2.4e-15;
# 4,500-5,000 (the FMM path) 6.2e-06-6.5e-06, order 5 2.3e-04; 5,000 shell
# points 3.4e-06, order 5 1.1e-04; 12^3 grid 1.1e-06, order 5 4.5e-05
TINY_CONFIGS = {
    "albatite_tiny": ("albatite_spheroidal5", {"points": 1500}),
    "albatite_fmm": ("albatite_spheroidal5", {"points": 4500}),
    "sdf_tiny": ("sdf_bumpy_sphere_250k", {"points": 5000}),
}
TINY_CELLS = {
    "tiny.albatite.fit": ("albatite_tiny", "fit_loop",
                          {"driver": "fit", "pool": 2, "check_rows": 0,
                           "limits": {"resid_l2": 1e-8}}),
    "tiny.albatite_fmm.fit": ("albatite_fmm", "fit_loop",
                              {"driver": "fit", "pool": 1, "check_rows": 0,
                               "limits": {"resid_l2": 4e-5}}),
    "tiny.sdf.fit": ("sdf_tiny", "fit_loop",
                     {"driver": "fit", "pool": 2, "check_rows": 700,
                      "limits": {"resid_l2": 2e-5}}),
    "tiny.grid_eval": ("sdf_tiny", "grid12",
                       {"driver": "grid_eval", "grid": 12, "box": [-1.4, 1.4], "pool": 2,
                        "check_targets": 300, "limits": {"value_err": 8e-6}}),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def add_cell(root, name, config, traffic, workload, chips=1):
    """Add a cell to the copy at ``root``: its workload file and its entry."""
    with open(os.path.join(root, "benchmark", "workloads", f"{name}.json"), "w") as fh:
        json.dump({"config": config, "traffic": traffic, **workload}, fh)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": chips, "why": "a tiny cell of the tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for cell in list(m.get("workloads", [])):
            if _kind(cell) == _kind(name) and name not in m["workloads"]:
                m["workloads"].append(name)
    with open(path, "w") as fh:
        json.dump(bench, fh)


def _kind(cell):
    return cell.rsplit(".", 1)[-1]


@pytest.fixture
def scratch(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with the tiny cells."""
    return make_scratch(str(tmp_path / "checkout"))


def make_scratch(root):
    """Copy BENCHMARK.json and benchmark/ to ``root`` (the port and the data
    set stay the repository's) and add the tiny configurations and cells."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "datasets"), os.path.join(root, "datasets"))
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as fh:
        bench = json.load(fh)
    for name, (base, changes) in TINY_CONFIGS.items():
        with open(os.path.join(root, "benchmark", "configs", f"{base}.json")) as fh:
            config = {**json.load(fh), **changes, "name": name}
        with open(os.path.join(root, "benchmark", "configs", f"{name}.json"), "w") as fh:
            json.dump(config, fh)
        bench["configs"].append({"name": name, "source": "tests", "reduced": ["points"],
                                 "file": f"benchmark/configs/{name}.json", "why": "tests"})
    with open(bench_path, "w") as fh:
        json.dump(bench, fh)
    for name, (config, traffic, workload) in TINY_CELLS.items():
        add_cell(root, name, config, traffic, workload)
    return root
