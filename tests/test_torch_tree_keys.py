"""The port's octree build forms its cell sets and its u/w pair lists by
1-D sorts of packed int64 keys; the JAX package's ``build_tree`` keeps the
row-wise ``np.unique(axis=0)``.

* The port's ``Octree`` against the JAX package's, array for array in
  value and dtype, at d = 1, 2 and 3, sparse and not, adaptive and
  uniform, on clustered, uniform and level-15 data;
* the key helpers: the anchor pack/unpack round trip at the ends of an
  axis, the pair key sorting as ``np.unique(axis=0)``, and an anchor past
  its 16 bits raising.
"""

import numpy as np
import pytest

from ferreus_rbf_tpu.ops.fmm import tree as jtree_mod
from ferreus_rbf_tpu_torch.ops.fmm import tree as tree_mod

MAX_POINTS = 24
FIELDS = ("anchors", "levels", "parent", "children", "child_octant", "is_leaf",
          "has_points", "point_order", "point_leaf", "leaf_cells", "leaf_offsets",
          "u_pairs", "w_pairs", "x_pairs")


def _clustered(d, n=1500, seed=5):
    """A dense blob in a sparse background."""
    rng = np.random.default_rng(seed)
    blob = rng.normal(scale=0.02, size=(n - n // 4, d)) + 0.3
    return np.clip(np.concatenate([blob, rng.random((n // 4, d))]), 0.0, 1.0)


def _uniform(d, n=1500, seed=6):
    return np.random.default_rng(seed).random((n, d))


def _deepest(d, n=400, seed=7):
    """More than MAX_POINTS copies of the max corner, plus points on the
    max face of each axis: an adaptive tree splits down to level 15, with
    anchors near 2^15."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, d))
    for j in range(d):
        pts[j * 20:(j + 1) * 20, j] = 1.0
    return np.concatenate([pts, np.ones((MAX_POINTS + 6, d))])


def _build(mod, pts, sparse, adaptive):
    d = pts.shape[1]
    center, radius = mod.calculate_tree_center_and_radius(
        np.concatenate([pts.min(0), pts.max(0)]))
    return mod.build_tree(pts, center, radius, MAX_POINTS, store_empty_leaves=not sparse,
                          dimensions=d, adaptive=adaptive)


def _rows(a):
    return set(map(tuple, np.asarray(a).tolist()))


@pytest.mark.parametrize("data", [_clustered, _uniform, _deepest])
@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_octree_matches_the_jax_row_wise_build(d, sparse, adaptive, data):
    pts = data(d)
    got = _build(tree_mod, pts, sparse, adaptive)
    want = _build(jtree_mod, pts, sparse, adaptive)
    assert got.depth == want.depth and got.num_cells == want.num_cells
    if data is _deepest and adaptive:
        assert got.depth == tree_mod.MAXIMUM_LEVEL
        assert got.anchors.max() > (1 << tree_mod.MAXIMUM_LEVEL) - 64
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # v as the native-lists test holds it: the port keeps only sources with
    # points; the JAX list is the same rows, or a superset from its numpy builder
    want_v = want.v_pairs[want.has_points[want.v_pairs[:, 1]]]
    assert got.v_pairs.dtype == want.v_pairs.dtype
    assert got.v_pairs.shape == want_v.shape and _rows(got.v_pairs) == _rows(want_v)


def _check_round_trip(d):
    top = (1 << tree_mod.MAXIMUM_LEVEL) - 1
    corners = np.array([[(i >> j) & 1 for j in range(d)] for i in range(1 << d)]) * top
    anchors = np.concatenate([corners, np.arange(d)[None, :] + 1000]).astype(np.int64)
    keys = tree_mod._anchor_key(anchors)
    assert np.unique(keys).size == anchors.shape[0]
    np.testing.assert_array_equal(tree_mod._unpack_anchors(keys, d), anchors)
    np.testing.assert_array_equal(tree_mod._unique_anchors(np.repeat(anchors, 3, axis=0)),
                                  anchors[np.argsort(keys)])


def _check_pair_order(seed):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, 40, size=(3000, 2))
    pairs[:5] = [[0, 0], [2**31 - 1, 0], [0, 2**31 - 1], [2**31 - 1, 2**31 - 1], [1, 2**31 - 1]]
    got = tree_mod._unique_pairs(pairs)
    want = np.unique(pairs, axis=0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tree_mod._unique_pairs(np.zeros((0, 2), np.int64)).shape == (0, 2)


def _check_overflow(d):
    for bad in (1 << 16, -1):
        anchors = np.zeros((4, d), np.int64)
        anchors[2, d - 1] = bad
        with pytest.raises(ValueError, match="16 bits"):
            tree_mod._unique_anchors(anchors)


@pytest.mark.parametrize("check, arg", [
    (_check_round_trip, 1), (_check_round_trip, 2), (_check_round_trip, 3),
    (_check_pair_order, 0), (_check_pair_order, 1),
    (_check_overflow, 1), (_check_overflow, 3),
])
def test_key_helpers(check, arg):
    check(arg)
