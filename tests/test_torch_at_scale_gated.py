"""The port's gated FmmTree against the JAX package's, on the CPU.

Moved out of ``test_torch_at_scale.py`` (its module fixture builds the JAX
package's gated tree with its Pallas kernels in interpret mode, the
slowest part of that file): the gated tree's matvecs and gradients
against the JAX package's gated tree (f32 through ``p2p_rows``) and the
port's ungated tree. Tolerances (max |diff| / max |reference|): 1e-5 in
f32 (the f32 tier's bound), 1e-12 in f64 and for gradients (summation
order only).
"""

import functools
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ferreus_rbf_tpu.ops.fmm import p2p_pallas as pp

# the helpers and the two autouse fixtures (no gate variable, one torch
# thread) of the file these tests come from
from test_torch_at_scale import (  # noqa: F401
    GATE, _clustered, _jax_tree, _no_gate_env, _one_torch_thread, _port_tree, _rel)


def _interpret_kernels(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (the recipe of
    ``tests/test_fmm.py``, the JAX package's gate test)."""
    for kname in ("p2p_leaf_pairs", "p2p_leaf_fused", "p2p_leaf_slab", "p2p_rows"):
        fn = getattr(pp, kname)
        statics = tuple(n for n in ("kparams", "interpret")
                        if n in inspect.signature(fn.__wrapped__).parameters)
        monkeypatch.setattr(pp, kname, functools.partial(
            jax.jit(fn.__wrapped__, static_argnames=statics), interpret=True))


@pytest.fixture(scope="module")
def gated_trees():
    """The JAX package's gated tree (f32 on its Pallas route in interpret
    mode, so its M2P runs ``p2p_rows``; f64 and gradients on its scan) and
    the port's gated and ungated trees: matvecs at the sources and
    gradients at 600 of them, Spheroidal5, 2 RHS."""
    pts = _clustered()
    name = "Spheroidal5Rbf"
    w = np.random.default_rng(5).standard_normal((pts.shape[0], 2))
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        _interpret_kernels(mp)
        mp.setenv(GATE, "0")
        jt = _jax_tree(pts, name)
        gt = _port_tree(pts, name)
        mp.delenv(GATE)
        ut = _port_tree(pts, name)
        jt.prepare_targets(pts, "src")
        jt.set_weights(w)
        out[("jax", "grad")] = jt.evaluate_with_gradients(w, pts[:600])
        out[("jax", "f64")] = np.asarray(jt.evaluate_device(jnp.asarray(w), "src", "f64"))
        jt._use_pallas = True
        out[("jax", "f32")] = np.asarray(jt.evaluate_device(jnp.asarray(w), "src", "f32"))
    finally:
        mp.undo()
        jax.clear_caches()
    assert jt._m2p_tiles_gated and gt._m2p_tiles_gated and not ut._m2p_tiles_gated
    for key, tree in (("gated", gt), ("ungated", ut)):
        tree.prepare_targets(pts, "src")
        for prec in ("f32", "f64"):
            out[(key, prec)] = tree.evaluate_device(torch.as_tensor(w), "src", prec).numpy()
        tree.set_weights(w)
        out[(key, "grad")] = tree.evaluate_with_gradients(w, pts[:600])
    return out


@pytest.mark.parametrize("prec,tol", [("f32", 1e-5), ("f64", 1e-12)])
def test_gated_matvec_matches_jax_gated(gated_trees, prec, tol):
    assert _rel(gated_trees[("gated", prec)], gated_trees[("jax", prec)]) < tol


@pytest.mark.parametrize("prec,tol", [("f32", 1e-5), ("f64", 1e-12)])
def test_gated_matvec_matches_ungated(gated_trees, prec, tol):
    assert _rel(gated_trees[("gated", prec)], gated_trees[("ungated", prec)]) < tol


@pytest.mark.parametrize("other", ["jax", "ungated"])
def test_gated_gradients_match(gated_trees, other):
    got_v, got_g = gated_trees[("gated", "grad")]
    want_v, want_g = gated_trees[(other, "grad")]
    assert got_g.shape == (600, 6)
    assert _rel(got_v, want_v) < 1e-12
    assert _rel(got_g, want_g) < 1e-12
