"""The check fails what it must: each cell's control (the FMM at order 5
where the configuration states 7), and a run with the timed path broken
underneath, come out not correct (CPU, tiny cells; the harness's look for
a card is skipped by passing the device). The substitutes are
``control.py``'s, the ones read on the card.

Faults, where the cell can have them: a step that returns its state
unchanged, half of the batch left out with the mean taken over the rest,
an answer altered where it is produced. The cells run on one card, so no
exchange between cards can be left out.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import control, harness

SEED = 2**31 + 777


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(root, name, variant="program"):
    cell = harness.Cell(name, SEED, 0.0, 0, root=root, device="cpu")
    with control.substituted(variant, cell.workload["driver"]):
        run = harness.measure(cell)
    return harness.result(cell, run, harness.judge(cell))


@pytest.mark.parametrize("fault", control.FAULTS)
@pytest.mark.parametrize("name", ["tiny.albatite.fit", "tiny.sdf.fit"])
def test_fit_fault_is_not_correct(scratch, name, fault):
    line = _run(scratch, name, fault)
    assert not line["correct"] and line["failed"] == line["attempted"]
    assert line["checks"]["resid_l2"]["value"] > line["checks"]["resid_l2"]["limit"]


@pytest.mark.parametrize("fault", control.FAULTS)
def test_grid_eval_fault_is_not_correct(scratch, fault):
    line = _run(scratch, "tiny.grid_eval", fault)
    assert not line["correct"]
    assert line["checks"]["value_err"]["value"] > line["checks"]["value_err"]["limit"]


@pytest.mark.parametrize("name", ["tiny.albatite_fmm.fit", "tiny.sdf.fit", "tiny.grid_eval"])
def test_control_is_not_correct(scratch, name):
    torch.set_num_threads(4)  # the FMM's host plan of 4,500 albatite points
    assert _run(scratch, name)["correct"]
    assert not _run(scratch, name, "order5")["correct"]
