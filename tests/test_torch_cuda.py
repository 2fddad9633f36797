"""The port on the CUDA card: kernels H1-H4, the device path and the fused
FGMRES (its cycle captured as a CUDA graph and replayed).

Every test here needs a CUDA card and skips without one. The file imports
no JAX (the machine with the card has none), so run it there without the
repository's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerances (max |diff| / max |reference|): 1e-5 in f32 (the f32 tier's
bound), 1e-12 in f64 (summation order only).
"""

import contextlib

import numpy as np
import pytest
import torch

import ferreus_rbf_tpu_torch as frt
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _params(name):
    kw = {"base_range": 1.1, "total_sill": 0.8} if "Spheroidal" in name else {}
    return tk.KernelParams(tk.KernelType(name), **kw)


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def _tile_operands(rng, cuda, dtype, d=3):
    """H1/H2 operands of ``d``-dimensional points: 40 rows of 100 targets
    over 9 of 30 tiles of 150 slots (120 live), sentinel entries and a
    count-0 row; returns (tgt, src, w, nbr), cnt."""
    rows, t, s, ntiles, u, nrhs = 40, 100, 150, 30, 9, 3
    src = np.zeros((ntiles + 1, d, s))
    src[:ntiles, :, :120] = rng.random((ntiles, d, 120)) - 0.5
    w = np.zeros((ntiles + 1, nrhs, s))
    w[:ntiles, :, :120] = rng.standard_normal((ntiles, nrhs, 120))
    nbr = rng.integers(0, ntiles, (u, rows)).astype(np.int32)
    nbr[u - 1, ::2] = ntiles  # sentinel entries
    cnt = rng.integers(0, u + 1, rows).astype(np.int32)
    cnt[0] = 0
    dev = lambda a, dt=dtype: torch.as_tensor(a).to(cuda, dt)  # noqa: E731
    args = (dev(rng.random((rows, t, d)) - 0.5), dev(src), dev(w), dev(nbr, torch.int32))
    return args, dev(cnt, torch.int32)


def _check_tiles(cuda, dtype, name, d):
    args, cnt = _tile_operands(np.random.default_rng(7), cuda, dtype, d)
    key = "near_field_f32" if dtype == torch.float32 else "near_field_f64"
    for c in (None, cnt):
        before = nf.LAUNCHES[key]
        got = nf.near_field(*args, c, kparams=_params(name))
        assert nf.LAUNCHES[key] == before + 1
        want = nf.near_field_plain(*args, c, kparams=_params(name))
        assert _rel(got, want) < TOL[dtype]
        if c is not None:
            assert float(got[0].abs().max()) == 0.0  # the count-0 row


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", [kt.value for kt in tk.KernelType])
def test_kernel_matches_plain(cuda, dtype, name):
    _check_tiles(cuda, dtype, name, 3)


def _skewed_operands(rng, cuda, dtype, nrhs):
    """H1/H2 operands with live counts: T = 200 (two target spans), one row
    listing 216 tiles and the rest at most 8, tcnt in {0, 1, 9, 128, T},
    scnt from 0 to S, sentinel entries, weights past scnt zero."""
    rows, t, s, ntiles, u = 40, 200, 96, 60, 216
    scnt = rng.integers(0, s + 1, ntiles + 1)
    scnt[:3] = (0, s, 1)
    scnt[ntiles] = 0
    src = rng.random((ntiles + 1, 3, s)) - 0.5
    w = rng.standard_normal((ntiles + 1, nrhs, s))
    w *= np.arange(s)[None, None, :] < scnt[:, None, None]
    nbr = rng.integers(0, ntiles, (u, rows))
    nbr[u - 1, ::2] = ntiles  # sentinel entries
    nbr[:, 1] = np.arange(u) % ntiles
    cnt = rng.integers(0, 9, rows)
    cnt[:2] = (0, u)
    tcnt = rng.integers(0, t + 1, rows)
    tcnt[1:6] = (t, 0, 1, 9, 128)
    tgt = rng.random((rows, t, 3)) - 0.5
    tgt[6, :10] = src[nbr[0, 6], :, :10].T  # exact copies of sources
    dev = lambda a, dt=dtype: torch.as_tensor(a).to(cuda, dt)  # noqa: E731
    i32 = lambda a: dev(a, torch.int32)  # noqa: E731
    return (dev(tgt), dev(src), dev(w), i32(nbr), i32(cnt)), i32(tcnt), i32(scnt)


@pytest.mark.parametrize("budget", [nf._ITEM_SOURCES, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", [kt.value for kt in tk.KernelType])
def test_kernel_with_live_counts_matches_plain(cuda, monkeypatch, name, dtype, budget):
    """H1/H2 with tcnt/scnt on a skewed list and sparse rows, nrhs {1, 2,
    8}: the plain version's values, 0 on dead slots and the count-0 row,
    and two launches bitwise equal (at 64 live sources per item most rows
    are cut into several items, added by the second pass)."""
    monkeypatch.setattr(nf, "_ITEM_SOURCES", budget)
    kp = _params(name)
    for nrhs in (1, 2, 8):
        args, tcnt, scnt = _skewed_operands(np.random.default_rng(11), cuda, dtype, nrhs)
        got = nf.near_field(*args, kparams=kp, tcnt=tcnt, scnt=scnt)
        again = nf.near_field(*args, kparams=kp, tcnt=tcnt, scnt=scnt)
        want = nf.near_field_plain(*args, kparams=kp, tcnt=tcnt, scnt=scnt)
        assert torch.isfinite(got).all()
        assert torch.equal(got, again)
        assert _rel(got, want) < TOL[dtype]
        dead = torch.arange(got.shape[1], device=cuda)[None, :] >= tcnt[:, None]
        assert float(got[dead].abs().max()) == 0.0
        assert float(got[0].abs().max()) == 0.0  # cnt 0


@pytest.mark.parametrize("budget", [nf._ITEM_SOURCES, 64])
def test_work_list_on_the_card_is_the_cpus(cuda, monkeypatch, budget):
    """The work list that ``near_field`` builds on the card equals the one
    the CPU builds from the same tables, bitwise."""
    monkeypatch.setattr(nf, "_ITEM_SOURCES", budget)
    (tgt, src, _, nbr, cnt), tcnt, scnt = _skewed_operands(
        np.random.default_rng(12), cuda, torch.float64, 1)
    dims = {"t": tgt.shape[1], "s": src.shape[2], "l1": src.shape[0]}
    on_card = nf.work_items(nbr, cnt, tcnt, scnt, **dims)
    on_cpu = nf.work_items(*(x.cpu() for x in (nbr, cnt, tcnt, scnt)), **dims)
    assert on_card.items.is_cuda and on_card.nparts == on_cpu.nparts
    for a, b in zip(on_card[:3], on_cpu[:3]):
        assert torch.equal(a.cpu(), b)


def _grad_operands(rng, cuda, d=3):
    rows, t, s, ntiles, u, nrhs = 40, 100, 150, 30, 9, 3
    src = np.zeros((ntiles + 1, d, s))
    src[:ntiles, :, :120] = rng.random((ntiles, d, 120)) - 0.5
    w = np.zeros((ntiles + 1, nrhs, s))
    w[:ntiles, :, :120] = rng.standard_normal((ntiles, nrhs, 120))
    nbr = rng.integers(0, ntiles, (u, rows)).astype(np.int32)
    nbr[u - 1, ::2] = ntiles  # sentinel entries
    cnt = rng.integers(0, u + 1, rows).astype(np.int32)
    cnt[0] = 0
    tgt = rng.random((rows, t, d)) - 0.5
    tgt[1, :10] = src[nbr[0, 1], :, :10].T  # exact copies of sources
    dev = lambda a: torch.as_tensor(a).to(cuda)  # noqa: E731
    return (dev(tgt), dev(src), dev(w), dev(nbr)), dev(cnt)


@pytest.mark.parametrize("name", [kt.value for kt in tk.KernelType])
def test_grad_kernel_matches_plain(cuda, name):
    """H3 against its plain version: values and gradients, with and without
    counts, a count-0 row, sentinel entries and coincident points."""
    _check_grad(cuda, name, 3)


def _check_grad(cuda, name, d):
    args, cnt = _grad_operands(np.random.default_rng(8), cuda, d)
    for c in (None, cnt):
        before = nf.LAUNCHES["near_field_grad_f64"]
        got_v, got_g = nf.near_field_grad(*args, c, kparams=_params(name))
        assert nf.LAUNCHES["near_field_grad_f64"] == before + 1
        want_v, want_g = nf.near_field_grad_plain(*args, c, kparams=_params(name))
        assert torch.isfinite(got_g).all()
        assert _rel(got_v, want_v) < 1e-12
        assert _rel(got_g, want_g) < 1e-12
        if c is not None:
            assert float(got_v[0].abs().max()) == 0.0 == float(got_g[0].abs().max())


@pytest.mark.parametrize("budget", [nf._ITEM_SOURCES, 64])
@pytest.mark.parametrize("name", [kt.value for kt in tk.KernelType])
def test_grad_kernel_with_live_counts_matches_plain(cuda, monkeypatch, name, budget):
    """H3 with tcnt/scnt on the skewed list (one row of 216 tiles), sparse
    rows and coincident targets, nrhs {1, 2, 8}: the plain version's
    values and gradients, 0 on dead slots and the count-0 row, and two
    launches bitwise equal (at 64 live sources per item most rows are cut
    into several items)."""
    monkeypatch.setattr(nf, "_ITEM_SOURCES", budget)
    kp = _params(name)
    for nrhs in (1, 2, 8):
        args, tcnt, scnt = _skewed_operands(np.random.default_rng(13), cuda, torch.float64,
                                            nrhs)
        got = nf.near_field_grad(*args, kparams=kp, tcnt=tcnt, scnt=scnt)
        again = nf.near_field_grad(*args, kparams=kp, tcnt=tcnt, scnt=scnt)
        want = nf.near_field_grad_plain(*args, kparams=kp, tcnt=tcnt, scnt=scnt)
        dead = torch.arange(got[0].shape[1], device=cuda)[None, :] >= tcnt[:, None]
        for g, a, w in zip(got, again, want):
            assert torch.isfinite(g).all()
            assert torch.equal(g, a)
            assert _rel(g, w) < 1e-12
            assert float(g[dead].abs().max()) == 0.0
            assert float(g[0].abs().max()) == 0.0  # cnt 0


def test_gradients_on_card_match_cpu(cuda):
    """evaluate_with_gradients on the clustered tree (P2P, M2P and P2L all
    present), on the card and on the CPU: the same function."""
    rng = np.random.default_rng(3)
    blob = rng.normal(scale=0.02, size=(2000, 3)) + 0.25
    pts = np.clip(np.concatenate([blob, rng.random((500, 3))]), 0, 1)
    params = frt.FmmParams(interpolation_order=4, max_points_per_cell=64, epsilon=1e-4)
    w = rng.standard_normal((pts.shape[0], 2))
    out = {}
    for dev in ("cpu", cuda):
        tree = FmmTree(pts, 4, _params("Spheroidal5Rbf"), adaptive_tree=True,
                       sparse=True, params=params, device=dev)
        assert tree._m2p_nw > 0 and tree.p2l_cells.size > 0
        before = nf.LAUNCHES["near_field_grad_f64"]
        out[str(dev)] = tree.evaluate_with_gradients(w, pts)
        launched = nf.LAUNCHES["near_field_grad_f64"] - before
        assert launched == (2 if dev == cuda else 0)  # P2P and M2P
    for got, want in zip(out["cuda"], out["cpu"]):
        assert _rel(torch.as_tensor(got), torch.as_tensor(want)) < 1e-12


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_fmm_matvec_on_card_matches_cpu(cuda, precision):
    """A clustered adaptive tree (P2P, M2P and P2L all present) evaluated
    on the card and on the CPU (plain near field): same function."""
    rng = np.random.default_rng(3)
    blob = rng.normal(scale=0.02, size=(2000, 3)) + 0.25
    pts = np.clip(np.concatenate([blob, rng.random((500, 3))]), 0, 1)
    params = frt.FmmParams(interpolation_order=4, max_points_per_cell=64, epsilon=1e-4)
    w = rng.standard_normal((pts.shape[0], 2))
    out = {}
    for dev in ("cpu", cuda):
        tree = FmmTree(pts, 4, _params("Spheroidal5Rbf"), adaptive_tree=True,
                       sparse=True, params=params, device=dev)
        assert tree._m2p_nw > 0 and tree.p2l_cells.size > 0
        tree.prepare_targets(pts, "src")
        out[str(dev)] = tree.evaluate_device(
            torch.as_tensor(w, device=dev), "src", precision).cpu()
    tol = 1e-12 if precision == "f64" else 1e-5
    assert _rel(out["cuda"], out["cpu"]) < tol


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_repeat_matvecs_on_card_are_bitwise(cuda, precision):
    """Two evaluate_device calls on one tree give the same bits: the M2M
    adds its octants in a fixed order (no racing atomics)."""
    rng = np.random.default_rng(4)
    blob = rng.normal(scale=0.02, size=(2000, 3)) + 0.25
    pts = np.clip(np.concatenate([blob, rng.random((500, 3))]), 0, 1)
    params = frt.FmmParams(interpolation_order=4, max_points_per_cell=32, epsilon=1e-4)
    tree = FmmTree(pts, 4, _params("LinearRbf"), adaptive_tree=True, sparse=True,
                   params=params, device=cuda)
    tree.prepare_targets(pts, "src")
    w = torch.as_tensor(rng.standard_normal((pts.shape[0], 2)), device=cuda)
    first = tree.evaluate_device(w, "src", precision)
    assert torch.equal(tree.evaluate_device(w, "src", precision), first)


def test_trend_fit_save_load_on_card_is_bitwise(cuda, tmp_path):
    """A fit under a trend on the iterative path, saved and loaded on the
    card: values and gradients bit for bit the fitted model's."""
    pts = frt.generate_random_points(2000, 3, seed=8)
    vals = frt.RBFTestFunctions.f1_3d(pts)
    params = frt.Params.builder(frt.RBFKernelType.Linear).naive_solve_threshold(1000).build()
    params.ddm_params = frt.DDMParams(leaf_threshold=300, overlap_quota=0.5,
                                      coarse_ratio=0.25, coarse_threshold=800)
    rbfi = (frt.RBFInterpolator.builder(pts, vals, frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.Linear), device="cuda")
        .params(params).global_trend(frt.GlobalTrend.three(30.0, 45.0, 0.0, 2.0, 1.5, 1.0))
        .build())
    assert np.max(np.abs(rbfi.evaluate_at_source(True) - vals)) < 5e-6
    rbfi.save_model(tmp_path / "m.json")
    loaded = frt.RBFInterpolator.load_model(tmp_path / "m.json", device="cuda")
    grid = frt.create_evaluation_grid([(0.1, 0.9)] * 3, [12, 12, 12])
    assert np.array_equal(loaded.evaluate(grid), rbfi.evaluate(grid))
    for got, want in zip(loaded.evaluate_with_gradients(grid),
                         rbfi.evaluate_with_gradients(grid)):
        assert np.array_equal(got, want)


def test_iterative_fit_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pts = frt.generate_random_points(5000, 3, seed=42)
    vals = frt.RBFTestFunctions.f1_3d(pts)
    params = frt.Params.builder(frt.RBFKernelType.Linear).naive_solve_threshold(1000).build()
    params.ddm_params = frt.DDMParams(leaf_threshold=300, overlap_quota=0.5,
                                      coarse_ratio=0.25, coarse_threshold=800)
    nf.reset_launches()
    rbfi = frt.RBFInterpolator(
        pts, vals, frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear),
        params=params, device="cuda")
    # the fit's kernels: H1 (f32 inner matvecs) and H2 (f64 refinement)
    assert nf.LAUNCHES["near_field_f32"] > 0 and nf.LAUNCHES["near_field_f64"] > 0
    resid = np.max(np.abs(rbfi.evaluate_at_source(True) - vals))
    assert resid < 5e-6, resid


def _cell_operands(rng, cuda, dtype, nrhs=3, d=3):
    """H4 operands: 40 rows of 100 targets over 9 listed cells of 50 (p = 7,
    7^d nodes), sentinel cells, a count-0 row and targets on cell nodes."""
    from ferreus_rbf_tpu_torch.ops.fmm import cheb

    rows, t, u, ncells = 40, 100, 9, 50
    nodes = cheb.nodes_tensor_product(cheb.chebyshev_nodes(7), d)
    centers = rng.random((ncells, d)) - 0.5
    lengths = 0.05 + 0.1 * rng.random(ncells)
    cells = rng.integers(0, ncells, (u, rows)).astype(np.int32)
    cells[u - 1, ::2] = ncells  # sentinel cells
    cnt = rng.integers(0, u + 1, rows).astype(np.int32)
    cnt[0] = 0
    tgt = rng.random((rows, t, d)) - 0.5
    c = cells[0, 1]
    k = min(10, nodes.shape[0])
    tgt[1, :k] = centers[c] + (lengths[c] * 0.5) * nodes[:k]  # on cell nodes
    mult = rng.standard_normal((ncells, nodes.shape[0], nrhs))
    dev = lambda a, dt=torch.float64: torch.as_tensor(a).to(cuda, dt)  # noqa: E731
    return (dev(tgt, dtype), dev(cells, torch.int32), dev(cnt, torch.int32), dev(centers),
            dev(lengths), dev(nodes), dev(mult, dtype))


@pytest.mark.parametrize("name", ["LinearRbf", "ThinPlateSplineRbf", "Spheroidal5Rbf"])
def test_cells_kernel_matches_plain(cuda, name):
    """H4 (f32, f64 and gradients) against its plain version."""
    _check_cells(cuda, name, 3)


def _check_cells(cuda, name, d):
    kp = _params(name)
    for dtype, grad in ((torch.float32, False), (torch.float64, False), (torch.float64, True)):
        ops = _cell_operands(np.random.default_rng(9), cuda, dtype, d=d)
        key = ("near_field_cells_grad_f64" if grad else
               "near_field_cells_f32" if dtype == torch.float32 else "near_field_cells_f64")
        before = nf.LAUNCHES[key]
        fn = nf.near_field_cells_grad if grad else nf.near_field_cells
        plain = nf.near_field_cells_grad_plain if grad else nf.near_field_cells_plain
        got, want = fn(*ops, kparams=kp), plain(*ops, kparams=kp)
        assert nf.LAUNCHES[key] == before + 1
        for g, w in zip(got, want) if grad else ((got, want),):
            assert torch.isfinite(g).all()
            assert _rel(g, w) < TOL[dtype]
            assert float(g[0].abs().max()) == 0.0  # the count-0 row


def test_cells_kernel_raises_on_bad_operands(cuda):
    """A bad operand raises; the wrapper never falls back to the plain
    version on a CUDA tensor."""
    tgt, cells, cnt, centers, lengths, nodes, mult = _cell_operands(
        np.random.default_rng(10), cuda, torch.float64)
    kp = _params("LinearRbf")
    before = dict(nf.LAUNCHES)
    with pytest.raises(ValueError):  # one operand on the CPU
        nf.near_field_cells(tgt, cells, cnt, centers, lengths, nodes, mult.cpu(), kparams=kp)
    with pytest.raises(TypeError):  # float32 geometry
        nf.near_field_cells(tgt, cells, cnt, centers.float(), lengths, nodes, mult,
                            kparams=kp)
    with pytest.raises(ValueError):  # mult rows do not match the cells
        nf.near_field_cells(tgt, cells, cnt, centers, lengths, nodes, mult[:-1], kparams=kp)
    assert nf.LAUNCHES == before


def test_gated_tree_matches_ungated_on_card(cuda, monkeypatch):
    """The clustered tree with the node-tile gate forced: its f32 and f64
    matvecs and gradients on the card equal the ungated tree's, and only
    the gated tree launches H4."""
    rng = np.random.default_rng(3)
    blob = rng.normal(scale=0.02, size=(2000, 3)) + 0.25
    pts = np.clip(np.concatenate([blob, rng.random((500, 3))]), 0, 1)
    params = frt.FmmParams(interpolation_order=4, max_points_per_cell=64, epsilon=1e-4)
    w = rng.standard_normal((pts.shape[0], 2))
    out = {}
    for gate in ("default", "0"):
        if gate == "0":
            monkeypatch.setenv("FERREUS_RBF_TPU_NODETILE_BYTES", "0")
        tree = FmmTree(pts, 4, _params("Spheroidal5Rbf"), adaptive_tree=True,
                       sparse=True, params=params, device=cuda)
        assert tree._m2p_tiles_gated == (gate == "0")
        tree.prepare_targets(pts, "src")
        nf.reset_launches()
        wd = torch.as_tensor(w, device=cuda)
        out[gate] = [tree.evaluate_device(wd, "src", prec).cpu() for prec in ("f32", "f64")]
        out[gate] += [torch.as_tensor(x) for x in tree.evaluate_with_gradients(w, pts[:300])]
        cells = sum(nf.LAUNCHES[k] for k in nf.LAUNCHES if k.startswith("near_field_cells"))
        assert cells == (3 if gate == "0" else 0)
    for (got, want), tol in zip(zip(out["0"], out["default"]), (1e-5, 1e-12, 1e-12, 1e-12)):
        assert _rel(got, want) < tol


@pytest.mark.parametrize("budget", [nf._ITEM_SOURCES, 64])
@pytest.mark.parametrize("name", [kt.value for kt in tk.KernelType])
def test_cells_kernel_with_tcnt_matches_plain(cuda, monkeypatch, name, budget):
    """H4's three forms with live target counts (rows of 0, 1, 9, 60 and
    100 live targets), sentinel cells and a count-0 row, nrhs {1, 2, 8}:
    the plain version's values, 0 on dead slots, two launches bitwise
    equal."""
    monkeypatch.setattr(nf, "_ITEM_SOURCES", budget)
    kp = _params(name)
    for nrhs in (1, 2, 8):
        for dtype, grad in ((torch.float32, False), (torch.float64, False),
                            (torch.float64, True)):
            rng = np.random.default_rng(14)
            ops = _cell_operands(rng, cuda, dtype, nrhs)
            tcnt = torch.as_tensor(rng.choice([0, 1, 9, 60, 100], ops[0].shape[0]),
                                   dtype=torch.int32, device=cuda)
            fn = nf.near_field_cells_grad if grad else nf.near_field_cells
            plain = nf.near_field_cells_grad_plain if grad else nf.near_field_cells_plain
            got, again = fn(*ops, kparams=kp, tcnt=tcnt), fn(*ops, kparams=kp, tcnt=tcnt)
            want = plain(*ops, kparams=kp, tcnt=tcnt)
            dead = torch.arange(ops[0].shape[1], device=cuda)[None, :] >= tcnt[:, None]
            for g, a, w in zip(got, again, want) if grad else ((got, again, want),):
                assert torch.isfinite(g).all()
                assert torch.equal(g, a)
                assert _rel(g, w) < TOL[dtype]
                assert float(g[dead].abs().max()) == 0.0
                assert float(g[0].abs().max()) == 0.0  # the count-0 row


# The fused FGMRES on the card (solver/fused.py): the system of
# tests/test_torch_fused.py, 1,500 random points, ThinPlateSpline, two fine
# Schwarz levels and an SPD coarse domain.

def _fused_case():
    rng = np.random.default_rng(21)
    pts = rng.random((1500, 3))
    vals = np.sin(4 * pts[:, 0]) * np.cos(3 * pts[:, 1]) + 0.5 * pts[:, 2]
    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.ThinPlateSpline,
        fitting_accuracy=frt.FittingAccuracy(1e-6, frt.FittingAccuracyType.Relative))
    params = frt.Params(ddm_params=frt.DDMParams(leaf_threshold=128, coarse_ratio=0.5,
                                                 coarse_threshold=400),
                        naive_solve_threshold=0)
    return pts, vals, settings, params


def _fused_fit(cuda, fused=True):
    """A fit on the card with the tracer's events: the fused path, or the
    host loop (FERREUS_RBF_TPU_FUSED=0)."""
    import os

    from ferreus_rbf_tpu_torch.utils import timing

    tracer = timing.enable_global_tracer()
    if not fused:
        os.environ["FERREUS_RBF_TPU_FUSED"] = "0"
    try:
        fit = frt.RBFInterpolator(*_fused_case(), device=cuda)
    finally:
        os.environ.pop("FERREUS_RBF_TPU_FUSED", None)
        timing.disable_global_tracer()
    return fit, {e["event"]: e for e in tracer.events}


def _fused_system(cuda):
    from ferreus_rbf_tpu_torch.solver.fused import FusedSystem
    from ferreus_rbf_tpu_torch.solver.iterative import DeviceSystem
    from ferreus_rbf_tpu_torch.utils.common import get_cheb_cube_scaling_factors

    rbfi = frt.RBFInterpolator(*_fused_case(), device=cuda, _skip_solve=True)
    rbfi.translation_factor, rbfi.scale_factor = get_cheb_cube_scaling_factors(rbfi.points)
    system = DeviceSystem(rbfi)
    fs = FusedSystem(system)
    assert fs.ok
    rhs = np.zeros((system.n + system.m, 1))
    rhs[: system.n, 0] = rbfi.point_values[:, 0]
    return fs, torch.as_tensor(rhs, device=cuda)


@pytest.mark.parametrize("tol", [1e-14, 1e-2])
def test_fused_cycle_replay_is_bitwise_the_eager_cycle(cuda, tol):
    """The first cycle of a key runs eagerly and is captured; a replay of
    the graph and an eager cycle from the same (x, r) give the same bits.
    tol 1e-2 stops the cycle early: the replay runs its last steps masked."""
    fs, b = _fused_system(cuda)
    beta = float(torch.linalg.norm(b))
    args = ("f32", False, 5, b, torch.zeros_like(b), b, beta, tol)
    first = fs.cycle(*args)
    replay = fs.cycle(*args)
    eager = fs.cycle(*args, eager=True)
    assert fs.stats["graphs"] == 1 and fs.stats["replays"] == 1
    for other in (first, eager):
        assert torch.equal(replay[0], other[0]) and torch.equal(replay[1], other[1])
        assert np.array_equal(replay[2], other[2])
    assert fs.stats["masked_steps"] == 5 - int(replay[2][2])
    assert (int(replay[2][2]) < 5) == (tol == 1e-2)


def test_two_fused_fits_on_card_are_bitwise(cuda):
    a, ev = _fused_fit(cuda)
    b, _ = _fused_fit(cuda)
    assert ev["fused_system"]["ok"] and ev["fused_solve"]["replays"] > 0
    assert np.array_equal(a.coefficients.point_coefficients, b.coefficients.point_coefficients)
    assert np.array_equal(a.coefficients.poly_coefficients, b.coefficients.poly_coefficients)


def test_fused_fit_on_card_matches_host_loop(cuda):
    """Both converge, honour the data within 1e-5 of max |values|, and
    agree within 1e-2 * (max |c| + 1) (the JAX package's fused test)."""
    vals = _fused_case()[1]
    fused, ev = _fused_fit(cuda)
    host, hev = _fused_fit(cuda, fused=False)
    assert ev["fused_system"]["ok"] and "fused_system" not in hev
    for fit, events in ((fused, ev), (host, hev)):
        assert events["solve_done"]["converged"]
        resid = np.max(np.abs(fit.evaluate_at_source(add_nugget=True) - vals))
        assert resid < 1e-5 * np.max(np.abs(vals))
    cf, ch = fused.coefficients.point_coefficients, host.coefficients.point_coefficients
    assert np.max(np.abs(cf - ch)) < 1e-2 * (np.max(np.abs(ch)) + 1)


def test_fused_fit_launches_match_the_profiler(cuda):
    """A replay runs no Python, so its launches are counted from the
    capture: ``LAUNCHES`` after a fused fit equals the work-item kernels
    (one per wrapper call) that the profiler saw run, replays included."""
    from torch.profiler import ProfilerActivity, profile

    nf.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, ev = _fused_fit(cuda)
        torch.cuda.synchronize()
    ran = sum(e.count for e in prof.key_averages() if "near_field_work_items_kernel" in e.key)
    assert ev["fused_solve"]["replays"] > 0
    assert sum(nf.LAUNCHES.values()) == ran > 0


def test_sync_inside_the_captured_cycle_raises(cuda):
    """The cycle is captured in the "global" error mode: a host sync inside
    it raises instead of passing quietly (the eager first cycle runs)."""
    fs, b = _fused_system(cuda)
    precon = fs.precon

    def synced(rg):
        float(rg.abs().max())
        return precon(rg)

    fs.precon = synced
    with pytest.raises(RuntimeError):
        fs.cycle("f32", False, 5, b, torch.zeros_like(b), b, float(torch.linalg.norm(b)), 1e-14)
    assert fs.stats["cycles"] == 1 and fs.stats["graphs"] == 0


def _two_rank_matvecs(rank, init_file, out_dir):
    """One of two gloo ranks sharing ``cuda:0``: the clustered tree's f32
    and f64 matvecs, default and with the gate forced, sharded and one
    rank of the same tree; writes ``rank<r>.npz``."""
    import datetime
    import os

    import torch.distributed as dist

    from ferreus_rbf_tpu_torch import parallel

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    mesh = parallel.make_mesh(2, backend="gloo")
    rng = np.random.default_rng(3)
    blob = rng.normal(scale=0.02, size=(2000, 3)) + 0.25
    pts = np.clip(np.concatenate([blob, rng.random((500, 3))]), 0, 1)
    params = frt.FmmParams(interpolation_order=4, max_points_per_cell=64, epsilon=1e-4)
    w = torch.as_tensor(rng.standard_normal((pts.shape[0], 2)), device=mesh.device)
    out = {"device": str(mesh.device)}
    for gate in ("default", "0"):
        if gate == "0":
            os.environ["FERREUS_RBF_TPU_NODETILE_BYTES"] = "0"
        trees = []
        for m in (None, mesh):
            with parallel.use_mesh(m) if m else contextlib.nullcontext():
                tree = FmmTree(pts, 4, _params("Spheroidal5Rbf"), adaptive_tree=True,
                               sparse=True, params=params)
            tree.prepare_targets(pts, "src")
            trees.append(tree)
        out[f"{gate}_gated"] = trees[1]._m2p_tiles_gated
        for prec in ("f32", "f64"):
            nf.reset_launches()
            got = trees[1].evaluate_device(w, "src", prec)
            out[f"{gate}_{prec}_h4"] = sum(v for k, v in nf.LAUNCHES.items()
                                           if k.startswith("near_field_cells"))
            out[f"{gate}_{prec}"] = torch.equal(got, trees[0].evaluate_device(w, "src", prec))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture
def two_ranks(cuda, tmp_path):
    import time

    import torch.multiprocessing as tmp

    ctx = tmp.start_processes(_two_rank_matvecs, args=(str(tmp_path / "init"), str(tmp_path)),
                              nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=1):  # raises when a rank fails
            assert time.monotonic() < deadline, "the ranks ran past 300 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]


def test_two_gloo_ranks_on_one_card_match_one_rank(two_ranks):
    """Two gloo ranks on ``cuda:0``: ``evaluate_device`` at f32 and f64,
    on the clustered tree and with the node-tile gate forced (M2P on H4,
    launched on each rank), bit for bit a one-rank matvec of the same
    tree."""
    for out in two_ranks:
        assert str(out["device"]) == "cuda:0"
        for gate in ("default", "0"):
            assert bool(out[f"{gate}_gated"]) == (gate == "0")
            for prec in ("f32", "f64"):
                assert bool(out[f"{gate}_{prec}"]), (gate, prec)
                assert (int(out[f"{gate}_{prec}_h4"]) > 0) == (gate == "0")


# ------------------------------------------------------- d = 1 and d = 2


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", [kt.value for kt in tk.KernelType])
def test_kernel_matches_plain_at_low_d(cuda, d, dtype, name):
    """H1/H2 on 1-D and 2-D points against the plain version."""
    _check_tiles(cuda, dtype, name, d)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("name", [kt.value for kt in tk.KernelType])
def test_grad_kernel_matches_plain_at_low_d(cuda, d, name):
    """H3 on 1-D and 2-D points: (R, T, nrhs, d) gradients."""
    _check_grad(cuda, name, d)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("name", ["LinearRbf", "ThinPlateSplineRbf", "Spheroidal5Rbf"])
def test_cells_kernel_matches_plain_at_low_d(cuda, d, name):
    """H4 on cells of p^d = 7 and 49 nodes."""
    _check_cells(cuda, name, d)


@pytest.mark.parametrize("d", [1, 2])
def test_low_d_fit_on_card_matches_cpu(cuda, d):
    """An iterative fit of 1-D or 2-D points on the card: H1 and H2 launched,
    converged, and its evaluation within 1e-5 of max |values| of the same
    fit on the CPU (both solved to the 1e-6 tolerance)."""
    if d == 1:
        pts = np.random.default_rng(5).random((6000, 1))
        vals = np.sin(12 * pts[:, 0]) + 0.3 * np.cos(31 * pts[:, 0])
        kernel = frt.RBFKernelType.Linear
    else:
        pts = frt.generate_random_points(6000, 2, seed=42)
        vals = frt.RBFTestFunctions.franke_2d(pts)
        kernel = frt.RBFKernelType.ThinPlateSpline
    settings = frt.InterpolantSettings(kernel_type=kernel)
    nf.reset_launches()
    card = frt.RBFInterpolator(pts, vals, settings, device=cuda)
    assert nf.LAUNCHES["near_field_f32"] > 0 and nf.LAUNCHES["near_field_f64"] > 0
    host = frt.RBFInterpolator(pts, vals, settings, device="cpu")
    targets = np.random.default_rng(3).random((500, d))
    got, want = card.evaluate(targets), host.evaluate(targets)
    assert got.shape == want.shape == (500,)
    assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(vals))
    assert np.max(np.abs(card.evaluate_at_source(True) - vals)) < 1e-4 * np.max(np.abs(vals))
