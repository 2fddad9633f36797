"""The standalone ``bbfmm`` module, the FMM error budget, telemetry and the
M2M add order, on the CPU.

Tolerances: the JAX package's own bounds where a test mirrors one
(``tests/test_api_surface.py``: the Laplacian within 1e-2 of max |want| at
p = 4, leaf evaluation within 1e-10); the port against the JAX package's
``bbfmm`` at the same points, weights and params within 1e-12 relative
(the same f64 arithmetic, summed in other orders); the per-octant M2M
against one add over all octants within 1e-15 relative (the same sums).
"""

import numpy as np
import pytest
import torch

from ferreus_rbf_tpu import bbfmm as jbb
from ferreus_rbf_tpu_torch import bbfmm
from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree as PortTree
from ferreus_rbf_tpu_torch.ops.fmm.diagnostics import fmm_error_budget
from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType, make_kernel
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


def _rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _params(mod):
    return mod.FmmParams(interpolation_order=4, max_points_per_cell=64,
                         compression_type=mod.M2LCompressionType.SVD, epsilon=1e-4)


def _spheroidal(mod):
    return mod.KernelParams(mod.FmmKernelType.SpheroidalRbf,
                            spheroidal_order=mod.SpheroidalOrder.Five,
                            base_range=1.0, total_sill=0.8)


def test_bbfmm_module_surface():
    rng = np.random.default_rng(0)
    pts = rng.random((800, 3))
    w = rng.standard_normal((800, 2))
    tree = bbfmm.FmmTree(pts, 4, _spheroidal(bbfmm), adaptive_tree=True, sparse=False,
                         params=_params(bbfmm), device="cpu")
    tree.set_weights(w)
    targets = rng.random((100, 3))
    vals = tree.evaluate(w, targets)
    assert vals.shape == (100, 2)
    vals2, grads = tree.evaluate_with_gradients(w, targets)
    assert grads.shape == (100, 6)
    np.testing.assert_allclose(vals, vals2)
    tree.set_local_coefficients(w)
    np.testing.assert_allclose(tree.evaluate_leaves(w, targets), vals, atol=1e-10)
    lv, lg = tree.evaluate_leaves_with_gradients(w, targets)
    np.testing.assert_allclose(lg, grads, atol=1e-10)
    assert tree.source_points.shape == (800, 3)

    # the Laplacian through the same surface, against a dense sum
    tree2 = bbfmm.FmmTree(pts, 4, bbfmm.KernelParams(bbfmm.FmmKernelType.Laplacian),
                          params=_params(bbfmm), device="cpu")
    tree2.set_weights(w)
    v = tree2.evaluate(w, targets)
    want = make_kernel(KernelParams(KernelType.Laplacian), xp=np).pair(targets, pts) @ w
    assert np.max(np.abs(v - want)) < 1e-2 * np.max(np.abs(want))


KERNELS = [
    ("Laplacian", {}),
    ("OneOverR2", {}),
    ("OneOverR4", {}),
    ("LinearRbf", {}),
    ("SpheroidalRbf", {"spheroidal_order": "Five", "base_range": 1.0, "total_sill": 0.8}),
]


@pytest.mark.parametrize("name, kw", KERNELS, ids=[k for k, _ in KERNELS])
def test_bbfmm_matches_jax(name, kw):
    rng = np.random.default_rng(11)
    pts = rng.random((600, 3))
    w = rng.standard_normal((600, 2))
    targets = 1.05 * rng.random((80, 3)) - 0.025  # some outside the sources' box

    def tree(mod, **extra):
        kwargs = dict(kw)
        if "spheroidal_order" in kwargs:
            kwargs["spheroidal_order"] = getattr(mod.SpheroidalOrder, kwargs["spheroidal_order"])
        kp = mod.KernelParams(getattr(mod.FmmKernelType, name), **kwargs)
        extents = np.concatenate([np.full(3, -0.05), np.full(3, 1.05)])
        return mod.FmmTree(pts, 4, kp, extents=extents, params=_params(mod), **extra)

    jt, pt = tree(jbb), tree(bbfmm, device="cpu")
    assert _rel(pt.evaluate(w, targets), jt.evaluate(w, targets)) < 1e-12
    got = pt.evaluate_with_gradients(w, targets)
    want = jt.evaluate_with_gradients(w, targets)
    assert all(_rel(g, x) < 1e-12 for g, x in zip(got, want))


def test_bbfmm_outside_point_raises():
    rng = np.random.default_rng(1)
    pts = rng.random((200, 3))
    tree = bbfmm.FmmTree(pts, 3, bbfmm.KernelParams(bbfmm.FmmKernelType.LinearRbf),
                         params=_params(bbfmm), device="cpu")
    w = rng.standard_normal(200)
    with pytest.raises(bbfmm.PointOutsideTreeError):
        tree.evaluate(w, np.array([[5.0, 5.0, 5.0]]))


def test_error_budget_tracks_order():
    rng = np.random.default_rng(3)
    pts = rng.random((1000, 3))
    w = rng.standard_normal(1000)
    out = fmm_error_budget(pts, w, KernelParams(KernelType.LinearRbf), orders=(3, 5),
                           n_sample=128, max_points_per_cell=64, device="cpu")
    err = {(e["p"], e["prec"]): e["err"] for e in out["entries"]}
    assert set(err) == {(3, "f64"), (3, "f32"), (5, "f64"), (5, "f32")}
    assert all(np.isfinite(v) for v in err.values())
    assert err[(5, "f64")] < err[(3, "f64")]
    assert out["verdict"] == "cheb_truncation" and out["tracks_p"]
    assert out["n"] == 1000 and out["n_sample"] == 128


def test_tracer_report_names_stages():
    tracer = timing.enable_global_tracer()
    try:
        assert timing.global_tracer() is tracer
        with timing.traced_stage("stage_a"):
            pass
        with tracer.stage("stage_b"):
            pass
        tracer.add("stage_b", 0.5)
    finally:
        timing.disable_global_tracer()
    assert timing.global_tracer() is None
    rows = {line.split()[0]: line.split()[1:] for line in tracer.report().splitlines()[1:]}
    assert rows["stage_a"][0] == "1" and rows["stage_b"][0] == "2"  # calls
    assert tracer.totals["stage_b"] >= 0.5


def test_profiler_trace_writes_a_trace(tmp_path):
    with timing.profiler_trace(str(tmp_path)) as prof:
        torch.ones(64).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert prof.key_averages() is not None


def _upward_one_add(tree, wt, fs):
    """The M2M as it was: all octant groups of a level in one index_add_."""
    ncells, nr = tree.tree.num_cells, wt.shape[1]
    mult = wt.new_zeros((ncells + 1, tree.nnodes, nr))
    mult[tree._dev["leaf_cells"]] = torch.bmm(wt[: tree.nsl], fs["p2m_w"]).transpose(1, 2)
    for ch, pa in tree._dev["m2m_groups"]:
        contrib = torch.einsum("opq,ocqr->ocpr", fs["m2m_ops"], mult[ch])
        mult.index_add_(0, pa.reshape(-1), contrib.reshape(-1, tree.nnodes, nr))
    return mult[:ncells]


def test_upward_per_octant_order():
    """P1: the per-octant M2M gives the one-add sums on a clustered 3-D
    adaptive tree, and two calls are bitwise equal."""
    rng = np.random.default_rng(3)
    blob = rng.normal(scale=0.02, size=(1500, 3)) + 0.25
    pts = np.clip(np.concatenate([blob, rng.random((500, 3))]), 0, 1)
    params = bbfmm.FmmParams(interpolation_order=4, max_points_per_cell=32, epsilon=1e-4)
    tree = PortTree(pts, 4, KernelParams(KernelType.LinearRbf), adaptive_tree=True,
                    sparse=True, params=params, device="cpu")
    assert tree.tree.depth >= 3 and len(tree._dev["m2m_groups"]) >= 3
    assert max(int((pa[:, 0] < tree.tree.num_cells).sum())
               for _, pa in tree._dev["m2m_groups"]) == 8  # all eight octants in use
    w = torch.as_tensor(rng.standard_normal((pts.shape[0], 2)))
    fs = tree._floats64
    wt = tree._weight_tiles_of(w, torch.float64)
    got = tree._upward(wt, fs)
    want = _upward_one_add(tree, wt, fs)
    assert float((got - want).abs().max()) <= 1e-15 * float(want.abs().max())
    assert torch.equal(tree._upward(wt, fs), got)
