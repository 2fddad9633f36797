"""The memo of compressed M2L levels (``ops/fmm/m2l.py``) on the CPU.

A level's 16 (3-D) or 7 (2-D) compressed reference operators depend on the
kernel, the order, the dimension, the compression, epsilon and the level's
cell length only, never on a point. A second tree with the same key takes
them from the memo (the tracer's ``m2l_cache_hits``); a tree with any field
of the key changed compresses its own (``m2l_operators``). Warm and cold
results are compared bitwise.
"""

import numpy as np
import pytest
import torch

import ferreus_rbf_tpu_torch as prt
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops.fmm import m2l
from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree
from ferreus_rbf_tpu_torch.utils import timing


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU's cores, and a torch thread pool per worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _cold_memo():
    """Each test starts with the memo empty, whatever ran before it in the
    same process, and ends with the tracer off."""
    m2l.clear_cache()
    yield
    timing.disable_global_tracer()


SPHEROIDAL = tk.KernelParams(tk.KernelType("Spheroidal5Rbf"), base_range=2.0, total_sill=1.0)
KEY = dict(kernel_params=SPHEROIDAL, p=3, d=3, radius=2.001, depth=3, compression="ACA",
           epsilon=1e-3)


def _build(**changes):
    """(level operators, operators compressed, operators from the memo)."""
    kw = {**KEY, **changes}
    tracer = timing.enable_global_tracer()
    ops = m2l.build_level_operators(kw["kernel_params"], kw["p"], kw["d"], kw["radius"],
                                    kw["depth"], kw["compression"], kw["epsilon"])
    timing.disable_global_tracer()
    return ops, tracer.counters.get("m2l_operators", 0), tracer.counters.get("m2l_cache_hits", 0)


def _refs(d):
    return m2l.reference_m2l_vectors(d).shape[0]


def _assert_same_ops(got, want):
    assert sorted(got) == sorted(want)
    for level in want:
        assert len(got[level]) == len(want[level])
        for (u, vt), (u0, vt0) in zip(got[level], want[level]):
            assert np.array_equal(u, u0)
            assert (vt is None) == (vt0 is None)
            if vt is not None:
                assert np.array_equal(vt, vt0)


def _tree(pts, p=4, max_points=32):
    return FmmTree(pts, p, tk.KernelParams(tk.KernelType("ThinPlateSplineRbf")),
                   params=prt.FmmParams(interpolation_order=p, max_points_per_cell=max_points,
                                        epsilon=1e-4), device="cpu")


@pytest.mark.parametrize("d", [2, 3])
def test_permuted_rows_take_every_level_from_the_memo(d):
    rng = np.random.default_rng(40 + d)
    pts = rng.random((3000, d))
    perm = rng.permutation(pts.shape[0])
    _tree(pts)  # fills the memo
    tracer = timing.enable_global_tracer()
    warm = _tree(pts[perm])
    timing.disable_global_tracer()
    assert warm.tree.depth >= 3
    assert tracer.counters.get("m2l_operators", 0) == 0
    assert tracer.counters["m2l_cache_hits"] == (warm.tree.depth - 1) * _refs(d)

    m2l.clear_cache()
    cold = _tree(pts[perm])
    _assert_same_ops(warm.level_ops, cold.level_ops)
    weights = rng.standard_normal((pts.shape[0], 2))
    targets = rng.random((500, d))
    assert np.array_equal(warm.evaluate(weights, targets), cold.evaluate(weights, targets))


def _fit_case(kernel):
    rng = np.random.default_rng(22)
    pts = rng.random((1200, 3))
    vals = np.sin(4 * pts[:, 0]) * np.cos(3 * pts[:, 1]) + 0.5 * pts[:, 2]
    kw = ({"kernel_type": prt.RBFKernelType.Spheroidal, "base_range": 0.8, "total_sill": 0.8}
          if kernel == "Spheroidal" else {"kernel_type": prt.RBFKernelType.ThinPlateSpline})
    settings = prt.InterpolantSettings(
        fitting_accuracy=prt.FittingAccuracy(1e-6, prt.FittingAccuracyType.Relative), **kw)
    params = prt.Params(
        ddm_params=prt.DDMParams(leaf_threshold=128, coarse_ratio=0.5, coarse_threshold=400),
        fmm_params=prt.FmmParams(max_points_per_cell=64),
        naive_solve_threshold=0)
    return pts, vals, settings, params


@pytest.mark.parametrize("kernel", ["ThinPlateSpline", "Spheroidal"])
def test_warm_fit_is_bitwise_the_cold_fit(kernel):
    pts, vals, settings, params = _fit_case(kernel)
    targets = np.random.default_rng(5).random((200, 3))
    cold = prt.RBFInterpolator(pts, vals, settings, params, device="cpu")
    cold_values = cold.evaluate(targets)
    tracer = timing.enable_global_tracer()
    warm = prt.RBFInterpolator(pts, vals, settings, params, device="cpu")
    timing.disable_global_tracer()
    assert tracer.counters.get("m2l_operators", 0) == 0 < tracer.counters["m2l_cache_hits"]
    assert np.array_equal(warm.coefficients.point_coefficients,
                          cold.coefficients.point_coefficients)
    assert np.array_equal(warm.evaluate(targets), cold_values)


@pytest.mark.parametrize("changes", [
    {},
    {"kernel_params": tk.KernelParams(tk.KernelType("Spheroidal5Rbf"), base_range=3.0,
                                      total_sill=1.0)},
    {"kernel_params": tk.KernelParams(tk.KernelType("Spheroidal3Rbf"), base_range=2.0,
                                      total_sill=1.0)},
    {"epsilon": 1e-4},
    {"p": 4},
    {"compression": "SVD"},
    {"d": 2},
    {"radius": 3.001},
], ids=["same", "base_range", "kernel_type", "epsilon", "p", "compression", "d", "radius"])
def test_each_key_field_misses_on_its_own(changes):
    first, _, _ = _build()
    ops, built, hits = _build(**changes)
    levels = KEY["depth"] - 1
    if changes:
        assert (built, hits) == (levels * _refs(changes.get("d", KEY["d"])), 0)
        assert all(ops[lv] is not first[lv] for lv in ops)
    else:
        assert (built, hits) == (0, levels * _refs(KEY["d"]))
        assert all(ops[lv] is first[lv] for lv in ops)


@pytest.mark.parametrize("depths", [(3, 5), (5, 3)], ids=["deeper", "shallower"])
def test_trees_of_one_radius_share_their_common_levels(depths):
    first, second = depths
    _build(depth=first)
    ops, built, hits = _build(depth=second)
    shared = min(first, second) - 1
    assert hits == shared * _refs(3)
    assert built == max(second - first, 0) * _refs(3)
    assert sorted(ops) == list(range(2, second + 1))
    m2l.clear_cache()
    cold, _, _ = _build(depth=second)
    _assert_same_ops(ops, cold)


def test_deeper_tree_over_the_same_box_builds_only_its_new_levels():
    pts = np.random.default_rng(7).random((3000, 3))
    shallow = _tree(pts, max_points=128)
    tracer = timing.enable_global_tracer()
    deep = _tree(pts, max_points=16)
    timing.disable_global_tracer()
    assert deep.tree.radius == shallow.tree.radius and deep.tree.depth > shallow.tree.depth
    assert tracer.counters["m2l_cache_hits"] == (shallow.tree.depth - 1) * _refs(3)
    assert tracer.counters["m2l_operators"] == (deep.tree.depth - shallow.tree.depth) * _refs(3)
    for level in shallow.level_ops:
        assert deep.level_ops[level] is shallow.level_ops[level]


@pytest.mark.parametrize("compression", ["ACA", "SVD", "None"])
def test_kept_arrays_refuse_writes(compression):
    ops, _, _ = _build(compression=compression, depth=2)
    for u, vt in ops[2]:
        with pytest.raises(ValueError):
            u[0, 0] = 0.0
        assert (vt is None) == (compression == "None")
        if vt is not None:
            with pytest.raises(ValueError):
                vt[0, 0] = 0.0


def test_memo_keeps_its_cap_and_drops_the_least_recently_used():
    cap = m2l._level.cache_info().maxsize
    radii = [2.001 + k for k in range(cap + 1)]  # depth 2: one level each
    for r in radii[:cap]:
        assert _build(radius=r, depth=2)[1:] == (_refs(3), 0)
    assert _build(radius=radii[0], depth=2)[1:] == (0, _refs(3))  # now the newest
    assert _build(radius=radii[cap], depth=2)[1:] == (_refs(3), 0)  # drops radii[1]
    assert m2l._level.cache_info().currsize == cap
    assert _build(radius=radii[1], depth=2)[1:] == (_refs(3), 0)  # dropped: built again
    assert _build(radius=radii[cap], depth=2)[1:] == (0, _refs(3))
    assert m2l._level.cache_info().currsize == cap


def test_clear_cache_empties_the_memo():
    _build()
    assert m2l._level.cache_info().currsize == KEY["depth"] - 1
    m2l.clear_cache()
    assert m2l._level.cache_info().currsize == 0
    assert _build()[1:] == ((KEY["depth"] - 1) * _refs(3), 0)
