"""Every cell on the card through ``benchmark/run.py`` (skips without a card):

    python -m pytest benchmark/tests/test_portbench_card.py -m cuda -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT


def _cells():
    with open(f"{ROOT}/BENCHMARK.json") as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", _cells())
def test_cell_runs_correct_on_the_card(card, name, trace):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                           "3000000001", "--seconds", "1", "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert all(v["value"] <= 105 for k, v in line["metrics"].items()
                   if k.startswith("nf_roofline"))
    else:
        assert {"setup_s", "peak_device_gb"} <= set(line["metrics"])
