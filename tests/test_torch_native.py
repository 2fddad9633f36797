"""The port's native interaction-list builder (``csrc/treebuild.cpp``,
``ferreus_rbf_tpu_torch/native.py``), on the CPU with g++.

* Its lists against the port's numpy builder (u and w row for row, v as a
  set once the numpy list drops sources without points, as the plan does)
  and against the JAX package's native lists (v row for row), at d = 1, 2
  and 3, with empty leaves stored and not;
* the FMM plan and a target set's tables built over either builder, array
  for array equal, and a matvec (f64 and f32) bit for bit equal;
* ``FERREUS_RBF_TPU_NATIVE=0`` taking the numpy builder, and a broken
  compiler raising instead of falling back.
"""

import copy

import numpy as np
import pytest
import torch

from ferreus_rbf_tpu import native as jnative
from ferreus_rbf_tpu_torch import native
from ferreus_rbf_tpu_torch.config import FmmCompressionType, FmmParams
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops.fmm import tree as tree_mod
from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree

NATIVE = "FERREUS_RBF_TPU_NATIVE"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU's cores, and a torch thread pool per worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _native_default(monkeypatch):
    monkeypatch.delenv(NATIVE, raising=False)


def _clustered(d, n=1500, seed=5):
    """A dense blob in a sparse background: a deep adaptive tree with
    non-empty w-lists at every d."""
    rng = np.random.default_rng(seed)
    blob = rng.normal(scale=0.02, size=(n - n // 4, d)) + 0.3
    return np.clip(np.concatenate([blob, rng.random((n // 4, d))]), 0.0, 1.0)


def _octree(pts, store_empty):
    d = pts.shape[1]
    center, radius = tree_mod.calculate_tree_center_and_radius(
        np.concatenate([pts.min(0), pts.max(0)]))
    return tree_mod.build_tree(pts, center, radius, 24, store_empty_leaves=store_empty,
                               dimensions=d, adaptive=True)


def _rows(a):
    return set(map(tuple, np.asarray(a).tolist()))


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("store_empty", [False, True])
def test_native_lists_match_numpy_and_jax(d, store_empty):
    tree = _octree(_clustered(d), store_empty)
    ref = copy.copy(tree)
    tree_mod._build_interaction_lists_numpy(ref)
    assert tree.w_pairs.shape[0] > 0 and tree.u_pairs.shape[0] > 0
    np.testing.assert_array_equal(tree.u_pairs, ref.u_pairs)
    np.testing.assert_array_equal(tree.w_pairs, ref.w_pairs)
    np.testing.assert_array_equal(tree.x_pairs, ref.x_pairs)
    ref_v = ref.v_pairs[ref.has_points[ref.v_pairs[:, 1]]]
    assert tree.v_pairs.shape == ref_v.shape and _rows(tree.v_pairs) == _rows(ref_v)
    if store_empty and d > 1:
        assert ref_v.shape[0] < ref.v_pairs.shape[0]  # empty sources were dropped
    jv, ju, jw = jnative.build_interaction_lists(
        tree.anchors, tree.levels, tree.parent, tree.children, tree.is_leaf,
        tree.has_points, tree.depth)
    np.testing.assert_array_equal(tree.v_pairs, jv)
    np.testing.assert_array_equal(tree.u_pairs, np.unique(ju, axis=0))
    np.testing.assert_array_equal(tree.w_pairs, np.unique(jw, axis=0))


def _assert_same(a, b, path):
    """Array for array equality of two plans' attributes."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert a.shape == b.shape and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (bool, int, float, str)):
        assert a == b, path


def _tree(pts, sparse):
    params = FmmParams(interpolation_order=4, max_points_per_cell=24, epsilon=1e-4,
                       compression_type=FmmCompressionType.ACA)
    kp = tk.KernelParams(tk.KernelType.ThinPlateSplineRbf)
    tree = FmmTree(pts, 4, kp, adaptive_tree=True, sparse=sparse, params=params, device="cpu")
    tree.prepare_targets(pts, "src")
    return tree


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("sparse", [True, False])
def test_fmm_plan_is_the_same_from_both_builders(monkeypatch, d, sparse):
    pts = _clustered(d, n=800)
    got = _tree(pts, sparse)
    monkeypatch.setenv(NATIVE, "0")
    want = _tree(pts, sparse)
    assert got.m2p_cells > 0 and len(got.m2l_levels) > 0
    skip = {"tree", "kernel_np", "kernel_params", "params", "level_ops", "perm_tables", "mesh"}
    assert vars(got).keys() == vars(want).keys()
    for key in vars(got).keys() - skip:
        _assert_same(getattr(got, key), getattr(want, key), key)


def test_matvec_is_bitwise_equal_both_ways(monkeypatch):
    pts = _clustered(3, n=1200)
    w = torch.as_tensor(np.random.default_rng(9).standard_normal((pts.shape[0], 2)))
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv(NATIVE, flag)
        tree = _tree(pts, True)
        out[flag] = [tree.evaluate_device(w, "src", prec) for prec in ("f64", "f32")]
    assert all(torch.equal(a, b) for a, b in zip(out["1"], out["0"]))


def test_native_off_takes_the_numpy_builder(monkeypatch):
    calls = []
    numpy_builder = tree_mod._build_interaction_lists_numpy

    def boom(*args, **kw):
        raise AssertionError("the native builder ran under FERREUS_RBF_TPU_NATIVE=0")

    monkeypatch.setattr(native, "build_interaction_lists", boom)
    monkeypatch.setattr(tree_mod, "_build_interaction_lists_numpy",
                        lambda t: calls.append(1) or numpy_builder(t))
    monkeypatch.setenv(NATIVE, "0")
    assert not native.enabled()
    tree = _octree(_clustered(2), False)
    assert calls == [1] and tree.u_pairs.shape[0] > 0
    monkeypatch.setenv(NATIVE, "1")
    with pytest.raises(AssertionError, match="native builder ran"):
        _octree(_clustered(2), False)


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_a_broken_compiler_raises(monkeypatch, tmp_path, cxx):
    """No quiet fallback: a compiler that is missing or fails raises, and
    no tree is built."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_CXX", cxx)
    with pytest.raises(RuntimeError, match="treebuild.cpp"):
        _octree(_clustered(2), False)
    assert native._LIB is None
