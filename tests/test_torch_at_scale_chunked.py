"""The port's P2M and L2P weights made per chunk, against the resident
tables, on the CPU.

Moved out of ``test_torch_at_scale.py`` (its module fixture takes many
chunks at ``eval_chunk_size=4``): above ``_WEIGHT_TABLE_BYTES`` (forced to
0 here) the weights are made per chunk, and the matvecs and gradients
match the resident tables' within 1e-13 (f64, gradients) and 1e-6 (f32).
"""

import numpy as np
import pytest
import torch

from ferreus_rbf_tpu_torch.ops.fmm import api as tapi
from ferreus_rbf_tpu_torch.utils import timing

# the helpers and the two autouse fixtures (no gate variable, one torch
# thread) of the file these tests come from
from test_torch_at_scale import (  # noqa: F401
    _clustered, _no_gate_env, _one_torch_thread, _port_tree, _rel)


@pytest.fixture(scope="module")
def chunked_pair():
    """The same tree with resident P2M/L2P tables and with the weights made
    per chunk (budget 0), at a small ``eval_chunk_size`` so that both
    passes take many chunks; Spheroidal5, 2 RHS."""
    pts = _clustered()
    targets = pts[::5]
    w = np.random.default_rng(9).standard_normal((pts.shape[0], 2))
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for key, budget in (("resident", tapi._WEIGHT_TABLE_BYTES), ("chunked", 0)):
            mp.setattr(tapi, "_WEIGHT_TABLE_BYTES", budget)
            tree = _port_tree(pts, "Spheroidal5Rbf", eval_chunk_size=4)
            tree.prepare_targets(pts, "src")
            out[(key, "flags")] = ("p2m_w" in tree._floats64,
                                   tree._target_cache["src"]["l2p_resident"])
            for prec in ("f32", "f64"):
                out[(key, prec)] = tree.evaluate_device(torch.as_tensor(w), "src", prec).numpy()
            out[(key, "grad")] = tree.evaluate_with_gradients(w, targets)
    finally:
        mp.undo()
    return out


def test_chunked_weights_take_the_chunked_path(chunked_pair):
    assert chunked_pair[("resident", "flags")] == (True, True)
    assert chunked_pair[("chunked", "flags")] == (False, False)


@pytest.mark.parametrize("prec,tol", [("f32", 1e-6), ("f64", 1e-13)])
def test_chunked_weights_match_resident(chunked_pair, prec, tol):
    assert _rel(chunked_pair[("chunked", prec)], chunked_pair[("resident", prec)]) < tol


def test_chunked_gradients_match_resident(chunked_pair):
    for got, want in zip(chunked_pair[("chunked", "grad")], chunked_pair[("resident", "grad")]):
        assert _rel(got, want) < 1e-13


def test_gradient_tables_count_in_the_budget(monkeypatch):
    """Fault P4: the L2P derivative tables (d times the weights) count in
    ``_WEIGHT_TABLE_BYTES``. Under a budget that holds a target set's
    weights but not its weights and derivatives, a gradient pass makes
    them per chunk, whether the set is binned for it or was kept for
    values first, and matches the resident tables within 1e-13 (at
    config 5's 3M points the kept derivative tables ran the card out of
    memory). A kept set's gradient pass reads its kept weights, makes the
    derivatives per chunk and records that in an ``fmm_targets`` event."""
    pts = _clustered()
    targets = pts[::5]
    w = np.random.default_rng(9).standard_normal((pts.shape[0], 2))
    tree = _port_tree(pts, "Spheroidal5Rbf", eval_chunk_size=4)
    tree.set_local_coefficients(w)
    want = tree.evaluate_leaves_with_gradients(w, targets)
    weights_bytes = tree._bin_targets(targets)["tcnt"].shape[0] * tree._tmax * tree.nnodes * 8
    monkeypatch.setattr(tapi, "_WEIGHT_TABLE_BYTES", 2 * weights_bytes)
    fresh = tree._bin_targets(targets, with_grads=True)
    assert not fresh["l2p_resident"] and "l2p_dw" not in fresh
    tree.prepare_targets(targets, "kept")
    tracer = timing.enable_global_tracer()
    try:
        got_kept = tree.evaluate_leaves_with_gradients(w, targets, "kept")
    finally:
        timing.disable_global_tracer()
    kept = tree._target_cache["kept"]
    assert kept["l2p_resident"] and "l2p_dw" not in kept
    assert [(e["l2p_resident"], e.get("kept")) for e in tracer.events
            if e["event"] == "fmm_targets"] == [(False, True)]
    for got in (tree.evaluate_leaves_with_gradients(w, targets), got_kept):
        for g, v in zip(got, want):
            assert _rel(g, v) < 1e-13
