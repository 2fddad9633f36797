"""The port on the CUDA card: kernels H1-H4 and the device path.

Every test here needs a CUDA card and skips without one. The file imports
no JAX (the machine with the card has none), so run it there without the
repository's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerances (max |diff| / max |reference|): 1e-5 in f32 (the f32 tier's
bound), 1e-12 in f64 (summation order only).
"""

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", [kt.value for kt in tk.KernelType])
def test_kernel_matches_plain(cuda, dtype, name):
    rng = np.random.default_rng(7)
    rows, t, s, ntiles, u, nrhs = 40, 100, 150, 30, 9, 3
    src = np.zeros((ntiles + 1, 3, s))
    src[:ntiles, :, :120] = rng.random((ntiles, 3, 120)) - 0.5
    w = np.zeros((ntiles + 1, nrhs, s))
    w[:ntiles, :, :120] = rng.standard_normal((ntiles, nrhs, 120))
    nbr = rng.integers(0, ntiles, (u, rows)).astype(np.int32)
    nbr[u - 1, ::2] = ntiles  # sentinel entries
    cnt = rng.integers(0, u + 1, rows).astype(np.int32)
    cnt[0] = 0
    dev = lambda a, dt=dtype: torch.as_tensor(a).to(cuda, dt)  # noqa: E731
    args = (dev(rng.random((rows, t, 3)) - 0.5), dev(src), dev(w), dev(nbr, torch.int32))
    key = "near_field_f32" if dtype == torch.float32 else "near_field_f64"
    for c in (None, dev(cnt, torch.int32)):
        before = nf.LAUNCHES[key]
        got = nf.near_field(*args, c, kparams=_params(name))
        assert nf.LAUNCHES[key] == before + 1
        want = nf.near_field_plain(*args, c, kparams=_params(name))
        assert _rel(got, want) < TOL[dtype]
        if c is not None:
            assert float(got[0].abs().max()) == 0.0  # the count-0 row


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


def _grad_operands(rng, cuda):
    rows, t, s, ntiles, u, nrhs = 40, 100, 150, 30, 9, 3
    src = np.zeros((ntiles + 1, 3, s))
    src[:ntiles, :, :120] = rng.random((ntiles, 3, 120)) - 0.5
    w = np.zeros((ntiles + 1, nrhs, s))
    w[:ntiles, :, :120] = rng.standard_normal((ntiles, nrhs, 120))
    nbr = rng.integers(0, ntiles, (u, rows)).astype(np.int32)
    nbr[u - 1, ::2] = ntiles  # sentinel entries
    cnt = rng.integers(0, u + 1, rows).astype(np.int32)
    cnt[0] = 0
    tgt = rng.random((rows, t, 3)) - 0.5
    tgt[1, :10] = src[nbr[0, 1], :, :10].T  # exact copies of sources
    dev = lambda a: torch.as_tensor(a).to(cuda)  # noqa: E731
    return (dev(tgt), dev(src), dev(w), dev(nbr)), dev(cnt)


@pytest.mark.parametrize("name", [kt.value for kt in tk.KernelType])
def test_grad_kernel_matches_plain(cuda, name):
    """H3 against its plain version: values and gradients, with and without
    counts, a count-0 row, sentinel entries and coincident points."""
    args, cnt = _grad_operands(np.random.default_rng(8), cuda)
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


def _cell_operands(rng, cuda, dtype, nrhs=3):
    """H4 operands: 40 rows of 100 targets over 9 listed cells of 50 (p = 7,
    343 nodes), sentinel cells, a count-0 row and targets on cell nodes."""
    from ferreus_rbf_tpu_torch.ops.fmm import cheb

    rows, t, u, ncells = 40, 100, 9, 50
    nodes = cheb.nodes_tensor_product(cheb.chebyshev_nodes(7), 3)
    centers = rng.random((ncells, 3)) - 0.5
    lengths = 0.05 + 0.1 * rng.random(ncells)
    cells = rng.integers(0, ncells, (u, rows)).astype(np.int32)
    cells[u - 1, ::2] = ncells  # sentinel cells
    cnt = rng.integers(0, u + 1, rows).astype(np.int32)
    cnt[0] = 0
    tgt = rng.random((rows, t, 3)) - 0.5
    c = cells[0, 1]
    tgt[1, :10] = centers[c] + (lengths[c] * 0.5) * nodes[:10]  # on cell nodes
    mult = rng.standard_normal((ncells, nodes.shape[0], nrhs))
    dev = lambda a, dt=torch.float64: torch.as_tensor(a).to(cuda, dt)  # noqa: E731
    return (dev(tgt, dtype), dev(cells, torch.int32), dev(cnt, torch.int32), dev(centers),
            dev(lengths), dev(nodes), dev(mult, dtype))


@pytest.mark.parametrize("name", ["LinearRbf", "ThinPlateSplineRbf", "Spheroidal5Rbf"])
def test_cells_kernel_matches_plain(cuda, name):
    """H4 (f32, f64 and gradients) against its plain version."""
    kp = _params(name)
    for dtype, grad in ((torch.float32, False), (torch.float64, False), (torch.float64, True)):
        ops = _cell_operands(np.random.default_rng(9), cuda, dtype)
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
