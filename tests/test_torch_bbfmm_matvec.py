"""Config 2's standalone multi-RHS matvec through the public
``bbfmm.FmmTree`` (LinearRbf, p = 5, 8 RHS, a uniform tree, ACA at 1e-5),
on the CPU at 3,000 uniform points with leaves of at most 32 points, so
that the tree has depth 3 and M2L levels; and on the card at config 2's
own size (the ``cuda`` test, which skips without a card).

The reference is the benchmark's ``reference/kernel_sum.py``, a dense
float64 sum that imports no kernel of the port. Tolerance: ``TOL`` of the
largest |sum| of all columns, for the FMM's order-5 Chebyshev truncation
(read here: 2.6e-05 at order 5, 1.0e-04 at order 4, 6.2e-04 at order 3, so
an order-3 tree fails it). Results of one tree and one block of weights are
compared bit for bit; a block of 8 columns against 8 calls of one column
within 1e-13 of the largest |value| (the same sums, batched); the port
against the JAX package's ``bbfmm.FmmTree`` on the same points, weights and
settings within 1e-12 relative, as ``test_torch_bbfmm.py`` holds its
adaptive trees (the same float64 arithmetic summed in other orders; ACA
picks the same pivots in both, so the cell's compression is compared as it
runs).
"""

import numpy as np
import pytest
import torch

from benchmark.reference.kernel_sum import kernel_sum
from ferreus_rbf_tpu import bbfmm as jbb
from ferreus_rbf_tpu_torch import bbfmm
from ferreus_rbf_tpu_torch.utils import timing

N, P, NRHS = 3000, 5, 8
TOL = 5e-5
LINEAR = {"type": "Linear"}


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


def _tree(pts, p=P, leaf=32, device="cpu", mod=bbfmm):
    params = mod.FmmParams(interpolation_order=p, max_points_per_cell=leaf,
                           compression_type=mod.M2LCompressionType.ACA, epsilon=1e-5)
    extra = {} if mod is jbb else {"device": device}  # the JAX package takes no device
    return mod.FmmTree(pts, p, mod.KernelParams(mod.FmmKernelType.LinearRbf),
                       adaptive_tree=False, sparse=True, params=params, **extra)


def _matvec(tree, w, targets):
    tree.set_weights(w)
    return tree.evaluate(w, targets)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(2)
    pts = rng.random((N, 3))
    blocks = [rng.standard_normal((N, NRHS)) for _ in range(2)]
    tree = _tree(pts)
    return {"pts": pts, "blocks": blocks, "tree": tree,
            "got": _matvec(tree, blocks[0], pts),
            "want": [kernel_sum(LINEAR, pts, w, pts) for w in blocks]}


def test_tree_is_uniform_with_m2l_levels(case):
    t = case["tree"]._tree
    assert t.tree.depth >= 3 and t.m2l_levels
    assert t.p2l_cells.size == 0 and t.m2p_cells == 0  # no x- or w-lists


@pytest.mark.parametrize("column", range(NRHS))
def test_matches_the_plain_sum(case, column):
    got, want = case["got"], case["want"][0]
    assert got.shape == (N, NRHS)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got[:, column] - want[:, column])) <= TOL * scale


def test_matches_the_jax_package(case):
    """The uniform tree's routes (no P2L, no M2P) and the 8-column passes,
    against the JAX package's tree on the same inputs."""
    pts, w = case["pts"], case["blocks"][0]
    want = _matvec(_tree(pts, mod=jbb), w, pts)
    got = case["got"]
    assert got.shape == want.shape == (N, NRHS)
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


def test_order_3_tree_exceeds_the_tolerance(case):
    pts, w, want = case["pts"], case["blocks"][0], case["want"][0]
    got = _matvec(_tree(pts, p=3), w, pts)
    assert np.max(np.abs(got - want)) > TOL * np.max(np.abs(want))


def test_eight_columns_equal_eight_single_column_calls(case):
    pts, w, got = case["pts"], case["blocks"][0], case["got"]
    tree = _tree(pts)
    scale = np.max(np.abs(got))
    for c in range(NRHS):
        one = _matvec(tree, w[:, c:c + 1], pts)
        assert one.shape == (N, 1)
        assert np.max(np.abs(one[:, 0] - got[:, c])) <= 1e-13 * scale


def test_alternating_blocks_keep_no_stale_multipoles(case):
    """The fixture's tree took block 1; now block 2, then block 1 again."""
    pts, (w1, w2), tree = case["pts"], case["blocks"], case["tree"]
    second, again = _matvec(tree, w2, pts), _matvec(tree, w1, pts)
    assert np.array_equal(again, case["got"]) and not np.array_equal(second, again)
    want = case["want"][1]
    assert np.max(np.abs(second - want)) <= TOL * np.max(np.abs(want))


def test_tracer_spans_and_counters_of_a_matvec(case):
    pts, w, tree = case["pts"], case["blocks"][0], case["tree"]
    tracer = timing.enable_global_tracer()
    got = _matvec(tree, w, pts)
    assert np.array_equal(got, case["got"])  # tracing changes no result
    names = {s[0]: s[2] for s in tracer.spans}
    parent = {s[2]: names.get(s[1]) for s in tracer.spans}
    assert parent["bbfmm_set_weights"] is None and parent["bbfmm_evaluate"] is None
    assert parent["fmm_upward"] == "bbfmm_set_weights"
    for stage in ("fmm_downward", "fmm_bin_targets", "fmm_leaf"):
        assert parent[stage] == "bbfmm_evaluate"
    events = [e for e in tracer.events if e["event"] == "counters"]
    assert [e["span"] for e in events] == ["bbfmm_set_weights", "bbfmm_evaluate"]
    assert events[0]["h2d_bytes"] == N * NRHS * 8  # the weights, float64
    assert "fmm_targets_binned" not in events[0]
    assert events[1]["fmm_targets_binned"] == N
    assert sum(e.get("h2d_bytes", 0) for e in events) == tracer.counters["h2d_bytes"]


@pytest.fixture(scope="module")
def small():
    """A quick tree for the span tests (1,000 points, p = 3, 2 RHS), its
    weights set and its locals made."""
    rng = np.random.default_rng(3)
    pts, w = rng.random((1000, 3)), rng.standard_normal((1000, 2))
    tree = _tree(pts, p=3)
    tree.set_weights(w)
    tree.set_local_coefficients(w)
    return pts, w, tree


@pytest.mark.parametrize("method", ["set_weights", "set_local_coefficients", "evaluate",
                                    "evaluate_with_gradients", "evaluate_leaves",
                                    "evaluate_leaves_with_gradients"])
def test_every_pass_is_one_outermost_span(small, method):
    pts, w, tree = small
    targets = pts[:200]
    tracer = timing.enable_global_tracer()
    args = (w,) if method.startswith("set_") else (w, targets)
    getattr(tree, method)(*args)
    if method == "set_weights":
        tree.set_local_coefficients(w)  # the leaf-only cases need the locals
    top = [s[2] for s in tracer.spans if s[1] is None]
    assert top[0] == f"bbfmm_{method}"
    event = [e for e in tracer.events if e["event"] == "counters"][0]
    assert event["span"] == f"bbfmm_{method}"
    binned = 0 if method.startswith("set_") else targets.shape[0]
    assert event.get("fmm_targets_binned", 0) == binned


def test_targets_taken_from_the_cache_are_not_counted(small):
    pts, w, tree = small
    inner = tree._tree  # the internal tree: its evaluate takes a reuse_key
    tracer = timing.enable_global_tracer()
    first = inner.evaluate(w, pts[:500], reuse_key="kept")
    again = inner.evaluate(w, pts[:500], reuse_key="kept")
    assert np.array_equal(first, again)
    assert tracer.counters["fmm_targets_binned"] == 500


PLAIN_KERNELS = [("LinearRbf", {"type": "Linear"}),
                 ("ThinPlateSplineRbf", {"type": "ThinPlateSpline"}),
                 ("CubicRbf", {"type": "Cubic"}),
                 ("Spheroidal5Rbf", {"type": "Spheroidal", "order": 5, "base_range": 0.7,
                                     "total_sill": 0.4}),
                 ("Laplacian", {"type": "Laplacian"}), ("OneOverR2", {"type": "OneOverR2"}),
                 ("OneOverR4", {"type": "OneOverR4"})]


@pytest.mark.parametrize("name,plain", PLAIN_KERNELS, ids=[k for k, _ in PLAIN_KERNELS])
def test_plain_sum_agrees_with_the_ports_kernel_definitions(name, plain):
    """Every kernel type of the standalone FMM, r = 0 included, against the
    port's own kernel matrix summed densely (the same float64 formula)."""
    from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType, make_kernel

    rng = np.random.default_rng(9)
    src, w = rng.random((200, 3)), rng.standard_normal((200, 3))
    tgt = np.concatenate([rng.random((30, 3)), src[:4]])
    kp = KernelParams(KernelType(name), plain.get("base_range", 1.0),
                      plain.get("total_sill", 1.0))
    want = make_kernel(kp, xp=np).pair(tgt, src) @ w
    np.testing.assert_allclose(kernel_sum(plain, src, w, tgt), want, rtol=1e-11,
                               atol=1e-11 * np.max(np.abs(want)))


@pytest.mark.cuda
def test_config2_on_the_card_matches_the_plain_sum():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(42)
    pts = rng.random((100_000, 3))
    w = rng.standard_normal((100_000, NRHS))
    got = _matvec(_tree(pts, leaf=256, device="cuda"), w, pts)
    rows = np.sort(rng.choice(pts.shape[0], 1024, replace=False))
    want = kernel_sum(LINEAR, pts, w, pts[rows], device="cuda")
    assert got.shape == (100_000, NRHS)
    assert np.max(np.abs(got[rows] - want)) <= TOL * np.max(np.abs(want))
