"""Target binning (``FmmTree._bin_targets``), which the port runs with torch
ops on the tree's device, against the JAX package's host binning, on the
CPU.

Every table of a binned set is held element for element against the JAX
package's ``_bin_targets`` on the same points and settings, its rows cut to
the port's row count (the JAX package pads rows to a power of two): the
rows' leaves, live slots, u-list tiles, w-list tiles (cell ids on a gated
tree, read from the JAX package's gated M2P tables), the inverse
(row, slot) map and the tree-centred target rows. A target outside the
tree raises ``PointOutsideTreeError`` with the JAX package's first
offending index. One binning anew reads the device once
(``fmm_bin_host_syncs``); a set taken from the cache reads nothing and
bins nothing.
"""

import numpy as np
import pytest
import torch

from ferreus_rbf_tpu.config import FmmCompressionType as JFC
from ferreus_rbf_tpu.config import FmmParams as JFP
from ferreus_rbf_tpu.ops import kernels as jk
from ferreus_rbf_tpu.ops.fmm import api as japi
from ferreus_rbf_tpu.ops.fmm.tree import PointOutsideTreeError as JaxOutside
from ferreus_rbf_tpu_torch.config import FmmCompressionType, FmmParams
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops.fmm import api as tapi
from ferreus_rbf_tpu_torch.ops.fmm.api import PointOutsideTreeError
from ferreus_rbf_tpu_torch.utils import timing

P = 3
GATE = "FERREUS_RBF_TPU_NODETILE_BYTES"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU's cores, and a torch thread pool per worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_gate_env(monkeypatch):
    monkeypatch.delenv(GATE, raising=False)
    yield
    timing.disable_global_tracer()


def _trees(pts, adaptive=True, sparse=True, extents=None):
    """The JAX package's and the port's trees on the same points."""
    kw = dict(interpolation_order=P, max_points_per_cell=32, epsilon=1e-3)
    jt = japi.FmmTree(pts, P, jk.KernelParams(jk.KernelType.LinearRbf), adaptive_tree=adaptive,
                      sparse=sparse, extents=extents,
                      params=JFP(compression_type=JFC.ACA, **kw))
    tt = tapi.FmmTree(pts, P, tk.KernelParams(tk.KernelType.LinearRbf), adaptive_tree=adaptive,
                      sparse=sparse, extents=extents,
                      params=FmmParams(compression_type=FmmCompressionType.ACA, **kw),
                      device="cpu")
    return jt, tt


def _clustered(rng, d=3):
    """A dense cluster in a sparse background: adaptive trees get w-lists."""
    return np.concatenate([rng.random((1600, d)) * 0.12, rng.random((400, d))])


def _union_box(rng):
    """Sources in the unit cube, targets over a box twice its size around
    it, and the tree over the union of the two boxes (non-sparse, so that
    every target finds a leaf)."""
    pts = _clustered(rng)
    targets = rng.random((3000, 3)) * 2.0 - 0.5
    extents = np.concatenate([np.minimum(pts.min(0), targets.min(0)),
                              np.maximum(pts.max(0), targets.max(0))])
    return _trees(pts, sparse=False, extents=extents), targets


def _max_face(rng):
    """Targets that include points on the tree's max faces, which the
    binning keeps in the last cell of each axis."""
    pts = rng.random((1500, 3))
    jt, tt = _trees(pts, sparse=False)
    t = tt.tree
    side = 2.0 * t.radius / (1 << t.depth)
    lo = t.center - t.radius
    face = lo + side * (1 << t.depth)
    for _ in range(8):  # the first coordinates whose anchor is 2^depth
        face = np.where(np.floor((face - lo) / side) < 1 << t.depth,
                        np.nextafter(face, np.inf), face)
    on = np.array([[face[0], 0.5, 0.5], [0.5, face[1], face[2]], face])
    assert np.all(np.floor((on - lo) / side).max(1) == 1 << t.depth)
    return (jt, tt), np.concatenate([pts[:200], on, pts[200:400]])


def _spanning(rng):
    """A leaf holding more than T targets (its rows span three rows)."""
    pts = rng.random((2000, 3))
    jt, tt = _trees(pts)
    many = np.repeat(pts[5:6], 3 * tt._tmax + 5, axis=0)
    return (jt, tt), np.concatenate([pts[:100], many, pts[100:300]])


def _uniform(rng):
    """A uniform sparse tree binning its own sources, as config 2 does."""
    pts = rng.random((4000, 3))
    return _trees(pts, adaptive=False), rng.permutation(pts)


def _low_d(d):
    def case(rng):
        pts = _clustered(rng, d)
        return _trees(pts, sparse=False), rng.random((1500, d))
    return case


def _gated(rng):
    pts = _clustered(rng)
    return _trees(pts), pts


def _single(rng):
    pts = _clustered(rng)
    return _trees(pts), pts[17:18]


CASES = {
    "uniform_sparse": _uniform,
    "adaptive_union_box": _union_box,
    "gated": _gated,
    "one_d": _low_d(1),
    "two_d": _low_d(2),
    "max_face": _max_face,
    "single_target": _single,
    "rows_span_a_leaf": _spanning,
    "with_grads": _union_box,
    "cache_hit": _gated,
}


def _jax_w_rows(jt, jb, ntl):
    """Each of the first ``ntl`` rows' w-list cells in the JAX package's
    binning: from its Pallas tile table ((Uw, rows) tile ids, sentinel nw,
    and the rows' counts) on an ungated tree, from its gated M2P tables
    (node ids cell * p^d + k, one group per width class) on a gated one."""
    rows = [[] for _ in range(ntl)]
    if jt._m2p_tiles_gated:
        jt._ensure_scan_tables(jb)
        for rsel, tab, mask in jb["m2p_groups_host"]:
            for r, t, m in zip(rsel, tab, mask):
                if r < ntl:
                    rows[r] = list(t[m][:: jt.nnodes] // jt.nnodes)
        return rows
    if jb["wtab"] is None:
        return rows
    tiles, cnt = np.asarray(jb["wtab"][0]), np.asarray(jb["wtab"][1])
    for r in range(ntl):
        rows[r] = list(tiles[: cnt[r], r])
    return rows


@pytest.mark.parametrize("case", list(CASES))
def test_binned_tables_equal_the_jax_packages(monkeypatch, case):
    if case in ("gated", "cache_hit"):
        monkeypatch.setenv(GATE, "0")
    (jt, tt), targets = CASES[case](np.random.default_rng(11))
    assert jt._m2p_tiles_gated == tt._m2p_tiles_gated == (case in ("gated", "cache_hit"))
    with_grads = case == "with_grads"
    tracer = timing.enable_global_tracer()
    tb = tt._bin_targets(targets, "set", with_grads=with_grads)
    n = targets.shape[0]
    assert tracer.counters["fmm_targets_binned"] == n
    assert tracer.counters["fmm_bin_host_syncs"] == 1
    if case == "cache_hit":
        timing.disable_global_tracer()
        tracer = timing.enable_global_tracer()
        assert tt._bin_targets(targets, "set") is tb
        assert tracer.counters == {}  # nothing binned, nothing read back
    jb = jt._bin_targets(targets, "set")
    t = tt._tmax
    ntl = tb["tcells"].shape[0]
    assert jt._tmax == t and jb["ntargets"] == tb["ntargets"] == n
    assert ntl <= jb["tcells"].shape[0]

    np.testing.assert_array_equal(tb["tcells"].numpy(), np.asarray(jb["tcells"])[:ntl])
    mask = np.asarray(jb["tgt_mask"])
    assert not mask[ntl:].any()
    np.testing.assert_array_equal(tb["tcnt"].numpy(), mask[:ntl].sum(1))
    np.testing.assert_array_equal(tb["nbr"].numpy(), np.asarray(jb["nbr_tab"])[:, :ntl])
    inv = np.asarray(jb["inv_row"])[:n].astype(np.int64) * t + np.asarray(jb["inv_slot"])[:n]
    np.testing.assert_array_equal(tb["inv_flat"].numpy(), inv)
    tpts = np.asarray(jb["targets_pad"])[np.asarray(jb["tgt_idx"])[:ntl]]
    np.testing.assert_array_equal(tb[torch.float64]["tpts"].numpy(), tpts)
    assert tb["tcells"].dtype == tb["inv_flat"].dtype == torch.int64
    assert tb["tcnt"].dtype == tb["nbr"].dtype == torch.int32
    assert tb["nbr"].is_contiguous()

    want_w = _jax_w_rows(jt, jb, ntl)
    if not any(want_w):
        assert tb["wtab"] is None and tb["wcnt"] is None
    else:
        wtab, wcnt = tb["wtab"].numpy(), tb["wcnt"].numpy()
        assert wtab.dtype == wcnt.dtype == np.int32 and tb["wtab"].is_contiguous()
        assert wtab.shape == (max(len(w) for w in want_w), ntl)
        sentinel = tt.tree.num_cells if tt._m2p_tiles_gated else tt._m2p_nw
        for r, want in enumerate(want_w):
            assert wcnt[r] == len(want)
            np.testing.assert_array_equal(wtab[: wcnt[r], r], want)
            assert np.all(wtab[wcnt[r]:, r] == sentinel)
    assert case not in ("gated", "cache_hit", "adaptive_union_box") or tb["wtab"] is not None
    if case == "rows_span_a_leaf":
        assert np.bincount(tb["tcells"].numpy()).max() >= 4
    if with_grads:
        assert "l2p_dw" in tb and tb["l2p_resident"]


def _outside(tt, axis, high):
    """A target just outside the tree's low or high face on ``axis``: the
    binning keeps points up to one deepest-cell side past a max face in the
    last cell, so the first point outside lies a side further."""
    t = tt.tree
    side = 2.0 * t.radius / (1 << t.depth)
    lo = t.center - t.radius
    x = t.center.copy()
    x[axis] = lo[axis] + side * ((1 << t.depth) + 1) if high else np.nextafter(lo[axis], -np.inf)
    return x


@pytest.mark.parametrize("face", ["x_low", "x_high", "y_low", "y_high", "z_low", "z_high",
                                  "no_leaf"])
def test_outside_target_raises_at_the_jax_packages_index(face):
    """The first offending index, for a target just outside each face, and
    for one inside the box on no leaf of a sparse tree."""
    rng = np.random.default_rng(5)
    if face == "no_leaf":
        # two corner clusters: the sparse tree has no cell around the probe
        pts = np.concatenate([rng.random((800, 3)) * 0.2, 0.8 + rng.random((800, 3)) * 0.2])
        bad = np.array([0.25, 0.75, 0.25])
    else:
        pts = _clustered(rng)
    jt, tt = _trees(pts, sparse=face == "no_leaf")
    if face != "no_leaf":
        bad = _outside(tt, "xyz".index(face[0]), face.endswith("high"))
    targets = pts[:40].copy()
    targets[23] = bad
    targets[31] = bad
    with pytest.raises(JaxOutside) as jerr:
        jt._bin_targets(targets)
    with pytest.raises(PointOutsideTreeError) as terr:
        tt._bin_targets(targets)
    assert terr.value.point_index == jerr.value.point_index == 23


def test_one_host_read_per_binning_and_none_from_the_cache():
    """``fmm_bin_host_syncs``: one read per set binned anew, through the
    public entry points too; none for a set taken from the cache."""
    rng = np.random.default_rng(9)
    pts = _clustered(rng)
    _, tt = _trees(pts)
    w = rng.standard_normal((pts.shape[0], 2))
    tracer = timing.enable_global_tracer()
    tt.prepare_targets(pts, "src")
    tt.prepare_targets(pts, "src")
    tt.evaluate(w, pts[:500])
    tt.evaluate_with_gradients(w, pts[:300])
    assert tracer.counters["fmm_bin_host_syncs"] == 3
    assert tracer.counters["fmm_targets_binned"] == pts.shape[0] + 800
