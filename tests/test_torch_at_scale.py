"""The port's at-scale path against the JAX package's, on the CPU.

* The M2P node-tile gate (``FERREUS_RBF_TPU_NODETILE_BYTES``): a gated tree
  keeps no node tiles and runs the M2P over virtual cell nodes
  (``near_field_cells``, kernel H4 on the card, its plain version here).
  Its plain versions are held against ``p2p_rows`` (Pallas, interpret
  mode) and the JAX package's virtual-node scan (``_near_field_class``) on
  the JAX package's own gated row tables; the gated tree against the JAX
  package's gated tree and against the port's ungated one.
* The P2M and L2P weights computed per chunk above ``_WEIGHT_TABLE_BYTES``
  against the resident tables.
* The DDM's per-level leaf sizing (``FERREUS_RBF_TPU_DDM_MEM_GB``) and the
  recompute-from-points Schwarz solve (``FERREUS_RBF_TPU_DDM_RECOMPUTE``).

Tolerances (max |diff| / max |reference|): 1e-5 in f32 (the f32 tier's
bound), 1e-12 in f64 and for gradients (summation order only); chunked
weights 1e-13 (f64) and 1e-6 (f32); a recompute Schwarz application 1e-10.
"""

import functools
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ferreus_rbf_tpu as jrt
import ferreus_rbf_tpu_torch as prt
from ferreus_rbf_tpu.config import FmmCompressionType as JFC
from ferreus_rbf_tpu.config import FmmParams as JFP
from ferreus_rbf_tpu.ops import kernels as jk
from ferreus_rbf_tpu.ops.fmm import api as japi
from ferreus_rbf_tpu.ops.fmm import p2p_pallas as pp
from ferreus_rbf_tpu.solver.ddm import DDMTree as JaxDDM
from ferreus_rbf_tpu_torch.config import FmmCompressionType, FmmParams
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops.fmm import api as tapi
from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
from ferreus_rbf_tpu_torch.ops.polynomials import evaluate_monomials
from ferreus_rbf_tpu_torch.solver.ddm import DDMTree
from ferreus_rbf_tpu_torch.solver.schwarz import schwarz_preconditioner
from ferreus_rbf_tpu_torch.utils import timing

P_ORDER = 4
FMM = dict(interpolation_order=P_ORDER, max_points_per_cell=64, epsilon=1e-4)
GATE = "FERREUS_RBF_TPU_NODETILE_BYTES"


def _clustered():
    """The clustered fixture of ``tests/test_fmm.py`` (the JAX package's
    gate test): a dense cluster in a sparse background, so the adaptive
    tree has w-lists."""
    rng = np.random.default_rng(37)
    return np.concatenate([rng.random((2400, 3)) * 0.12, rng.random((600, 3))])


def _params(mod, name):
    kw = {"base_range": 1.1, "total_sill": 0.8} if "Spheroidal" in name else {}
    return mod.KernelParams(mod.KernelType(name), **kw)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(want)))


def _port_tree(pts, name, **kw):
    params = FmmParams(compression_type=FmmCompressionType.ACA, **{**FMM, **kw})
    return tapi.FmmTree(pts, P_ORDER, _params(tk, name), adaptive_tree=True, sparse=True,
                        params=params, device="cpu")


def _jax_tree(pts, name):
    return japi.FmmTree(pts, P_ORDER, _params(jk, name), adaptive_tree=True, sparse=True,
                        params=JFP(compression_type=JFC.ACA, **FMM))


@pytest.fixture(autouse=True)
def _no_gate_env(monkeypatch):
    monkeypatch.delenv(GATE, raising=False)


# ---------------------------------------------------------------- (a) H4 plain


@pytest.fixture(scope="module")
def gated_rows():
    """Both packages' gated trees on the clustered points, the JAX
    package's gated M2P row tables (``m2p_groups_host``) and random
    multipole coefficients (ncells, p^d, 2)."""
    pts = _clustered()
    mp = pytest.MonkeyPatch()
    mp.setenv(GATE, "0")
    try:
        jt = _jax_tree(pts, "LinearRbf")
        tt = _port_tree(pts, "LinearRbf")
    finally:
        mp.undo()
    jb = jt._bin_targets(pts, "src")
    jt._ensure_scan_tables(jb)
    tt.prepare_targets(pts, "src")
    tb = tt._target_cache["src"]
    ntl = tb["tcells"].shape[0]
    assert jt._m2p_tiles_gated and tt._m2p_tiles_gated and tt._m2p_nw == 0
    assert "node_tiles" not in tt._floats64 and "wtile_cells" not in tt._dev
    np.testing.assert_array_equal(np.asarray(jb["tcells"])[:ntl], tb["tcells"].numpy())
    mult = np.random.default_rng(3).standard_normal((tt.tree.num_cells, tt.nnodes, 2))
    return {"jax": jt, "port": tt, "jb": jb, "tb": tb, "ntl": ntl, "mult": mult}


def _virtual_nodes(jt, tab):
    """The JAX package's virtual nodes of a flat node-index table."""
    centers = np.asarray(jt._dev["cell_centers"])
    lengths = np.asarray(jt._dev["cell_lengths"])
    nodes = np.asarray(jt._dev["nodes_nd"])
    p = nodes.shape[0]
    c = tab // p
    return centers[c] + (lengths[c][..., None] * 0.5) * nodes[tab % p]


def _port_cells(g, name, dtype, grad=False):
    tt, tb = g["port"], g["tb"]
    fn = nf.near_field_cells_grad if grad else nf.near_field_cells
    return fn(tb[torch.float64]["tpts"].to(dtype), tb["wtab"], tb["wcnt"],
              *tt._cell_geometry(), torch.as_tensor(g["mult"]).to(dtype),
              kparams=_params(tk, name))


@pytest.mark.parametrize("name", ["LinearRbf", "ThinPlateSplineRbf", "Spheroidal5Rbf"])
def test_cells_plain_f32_matches_p2p_rows(gated_rows, name):
    """f32: each width class of the JAX package's gated M2P, gathered as
    ``_near_field_class`` gathers it, through ``p2p_rows`` in interpret
    mode, against the port's cell table over the same virtual nodes."""
    g = gated_rows
    got = _port_cells(g, name, torch.float32).numpy()
    tpts = np.asarray(g["jb"]["targets_pad"])[np.asarray(g["jb"]["tgt_idx"])]
    mult_flat = g["mult"].reshape(-1, 2)
    seen = np.zeros(g["ntl"], bool)
    for rows, tab, mask in g["jb"]["m2p_groups_host"]:
        live = rows < g["ntl"]
        rows, tab, mask = rows[live], tab[live], mask[live]
        sp = _virtual_nodes(g["jax"], tab).astype(np.float32)
        wv = np.where(mask[..., None], mult_flat[tab], 0.0).astype(np.float32)
        want = np.asarray(pp.p2p_rows(
            jnp.asarray(tpts[rows], jnp.float32), jnp.asarray(sp.transpose(0, 2, 1)),
            jnp.asarray(wv.transpose(0, 2, 1)), kparams=_params(jk, name), interpret=True))
        assert _rel(got[rows], want) < 1e-5
        seen[rows] = True
    assert seen.any() and not seen.all()
    assert np.all(got[~seen] == 0.0)  # rows with an empty w-list


@pytest.mark.parametrize("name", ["LinearRbf", "CubicRbf", "Spheroidal5Rbf"])
def test_cells_plain_f64_and_grad_match_virtual_node_scan(gated_rows, name):
    """f64 values and gradients: the JAX package's virtual-node scan
    (``_near_field_class``, the gated f64 and gradient M2P) against the
    port's plain H4 versions."""
    g = gated_rows
    got_v = _port_cells(g, name, torch.float64).numpy()
    got_gv, got_g = (x.numpy() for x in _port_cells(g, name, torch.float64, grad=True))
    np.testing.assert_array_equal(got_gv, got_v)
    jb, jdev = g["jb"], g["jax"]._dev
    tpts = jnp.asarray(np.asarray(jb["targets_pad"])[np.asarray(jb["tgt_idx"])])
    kernel = jk.make_kernel(_params(jk, name), dtype=jnp.float64)
    src = (jdev["cell_centers"], jdev["cell_lengths"], jdev["nodes_nd"])
    mult_flat = jnp.asarray(g["mult"].reshape(-1, 2))
    for (rows, tab, mask), (_w, c_scan, _c) in zip(jb["m2p_groups_host"], jb["m2p_meta"]):
        vals, grads = japi._near_field_class(
            kernel, _params(jk, name), False, True, jnp.float64, tpts, jb["tgt_mask"], src,
            mult_flat, jnp.asarray(rows), jnp.asarray(tab), jnp.asarray(mask), c_scan)
        live = rows < g["ntl"]
        assert _rel(got_v[rows[live]], np.asarray(vals)[live]) < 1e-12
        assert _rel(got_g[rows[live]], np.asarray(grads)[live]) < 1e-12


def test_cells_plain_equals_tile_plain_on_stored_nodes(gated_rows):
    """The virtual nodes are bitwise the ungated tree's stored node tiles:
    H4's plain version on the gated table equals H1's on the tiles."""
    g = gated_rows
    pts = _clustered()
    ut = _port_tree(pts, "LinearRbf")
    ut.prepare_targets(pts, "src")
    ub = ut._target_cache["src"]
    wc = ut._dev["wtile_cells"]
    for dtype in (torch.float32, torch.float64):
        node_tiles = ut._floats(dtype)["node_tiles"]
        mt = torch.zeros((ut._m2p_nw + 1, 2, ut.nnodes), dtype=dtype)
        mt[:-1] = torch.as_tensor(g["mult"]).to(dtype)[wc].transpose(1, 2)
        want = nf.near_field(ub[torch.float64]["tpts"].to(dtype), node_tiles, mt, ub["wtab"],
                             ub["wcnt"], kparams=_params(tk, "LinearRbf"))
        got = _port_cells(g, "LinearRbf", dtype)
        assert torch.equal(got, want)


def test_cells_wrapper_rejects_bad_operands(gated_rows):
    g = gated_rows
    tt, tb = g["port"], g["tb"]
    kp = _params(tk, "LinearRbf")
    tpts = tb[torch.float64]["tpts"]
    centers, lengths, nodes = tt._cell_geometry()
    mult = torch.as_tensor(g["mult"])
    with pytest.raises(TypeError):  # mult of another dtype than the targets
        nf.near_field_cells(tpts.float(), tb["wtab"], tb["wcnt"], centers, lengths, nodes,
                            mult, kparams=kp)
    with pytest.raises(TypeError):  # float32 geometry
        nf.near_field_cells(tpts, tb["wtab"], tb["wcnt"], centers.float(), lengths, nodes,
                            mult, kparams=kp)
    with pytest.raises(ValueError):  # mult rows do not match the cells
        nf.near_field_cells(tpts, tb["wtab"], tb["wcnt"], centers, lengths, nodes,
                            mult[:-1], kparams=kp)
    with pytest.raises(TypeError):  # the gradient form is float64 only
        nf.near_field_cells_grad(tpts.float(), tb["wtab"], tb["wcnt"], centers, lengths,
                                 nodes, mult.float(), kparams=kp)


# ------------------------------------------------------- (b) gated FmmTree


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


def test_gate_budget_reads_the_jax_variable(monkeypatch):
    """The gate compares the port's own node-tile bytes, f64 tiles plus the
    f32 copy, with the budget: it fires just below them and not at them."""
    pts = _clustered()
    tree = _port_tree(pts, "LinearRbf")
    assert not tree._m2p_tiles_gated and tree._m2p_nw == tree.m2p_cells > 0
    assert tree.nodetile_bytes == (tree.m2p_cells + 1) * 3 * tree.nnodes * 12
    monkeypatch.setenv(GATE, str(tree.nodetile_bytes))
    assert not _port_tree(pts, "LinearRbf")._m2p_tiles_gated
    monkeypatch.setenv(GATE, str(tree.nodetile_bytes - 1))
    assert _port_tree(pts, "LinearRbf")._m2p_tiles_gated


# ------------------------------------------------- (c) chunked P2M and L2P


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


# ----------------------------------------------- (d, e) DDM sizing, recompute


def _ddm_params(mod):
    return mod.DDMParams(leaf_threshold=256, overlap_quota=0.5, coarse_ratio=0.25,
                         coarse_threshold=200)


def test_ddm_level_sizes_match_jax(monkeypatch):
    """3,000 points, f64 factors, a 6 MB budget: level 0 (3,000 points) cannot
    fit even 128-point leaves and recomputes at the user's 256; level 1
    (750 points) shrinks its leaves to 128. Same leaves as the JAX package."""
    monkeypatch.setenv("FERREUS_RBF_TPU_DDM_MEM_GB", "0.006")
    pts = np.random.default_rng(21).random((3000, 3))
    jset = jrt.InterpolantSettings(kernel_type=jrt.RBFKernelType.Linear)
    jset.set_basis_size(3)
    tset = prt.InterpolantSettings(kernel_type=prt.RBFKernelType.Linear)
    tset.set_basis_size(3)
    jd = JaxDDM(pts, jset, _ddm_params(jrt), factor_dtype=jnp.float64)
    td = DDMTree(pts, tset, _ddm_params(prt), factor_dtype=torch.float64, device="cpu")
    assert [lv.recompute for lv in td.levels[:-1]] == [True, False]
    assert [lv.leaf_threshold for lv in td.levels[:-1]] == [256, 128]
    assert len(td.levels) == len(jd.levels) == 3
    for tl, jl in zip(td.levels, jd.levels):
        np.testing.assert_array_equal(tl.point_indices, jl.point_indices)
        assert tl.recompute == jl.recompute
        assert ([p.point_indices.size for p in tl.leaf_plans]
                == [p.point_indices.size for p in jl.leaf_plans])
    assert all("chol" not in b for b in td.levels[0].buckets)
    assert all("chol" in b for b in td.levels[1].buckets)


@pytest.mark.parametrize("factor_dtype", [torch.float64, torch.float32])
def test_ddm_leaf_threshold_rule(monkeypatch, factor_dtype):
    """The per-level rule at the sizes of the 1M fit: with f32 factors and
    the 5 GB default the finest level of 1M points gets 128-point leaves
    (cap ~222) and no recompute, 125k points keep 1024; recompute when even
    128 does not fit, or on request below the user's leaf."""
    stub = DDMTree.__new__(DDMTree)
    stub.params = prt.DDMParams()
    stub.factor_dtype = factor_dtype
    f32 = factor_dtype == torch.float32
    assert stub._leaf_threshold_for(1_000_000) == ((128, False) if f32 else (1024, True))
    assert stub._leaf_threshold_for(125_000) == ((1024, False) if f32 else (512, False))
    assert stub._leaf_threshold_for(3_000_000) == (1024, True)
    monkeypatch.setenv("FERREUS_RBF_TPU_DDM_RECOMPUTE", "0")
    assert stub._leaf_threshold_for(3_000_000) == (128, False)
    monkeypatch.setenv("FERREUS_RBF_TPU_DDM_RECOMPUTE", "1")
    assert stub._leaf_threshold_for(1_000_000) == (1024, True)
    assert stub._leaf_threshold_for(1000) == (1024, False)


def test_recompute_schwarz_matches_stored(monkeypatch):
    """One multilevel Schwarz application with every level in recompute
    mode equals the stored-factor one (same leaves, f64 factors)."""
    pts = np.random.default_rng(22).random((2000, 3))
    settings = prt.InterpolantSettings(kernel_type=prt.RBFKernelType.Linear)
    settings.set_basis_size(3)
    stored = DDMTree(pts, settings, _ddm_params(prt), factor_dtype=torch.float64, device="cpu")
    monkeypatch.setenv("FERREUS_RBF_TPU_DDM_RECOMPUTE", "1")
    monkeypatch.setenv("FERREUS_RBF_TPU_DDM_MEM_GB", "1e-6")
    recomp = DDMTree(pts, settings, _ddm_params(prt), factor_dtype=torch.float64, device="cpu")
    assert not any(lv.recompute for lv in stored.levels[:-1])
    assert all(lv.recompute for lv in recomp.levels[:-1]) and len(recomp.levels) > 2
    kernel = tk.make_kernel(settings.kernel_params())
    pts_t = torch.as_tensor(pts)
    a = kernel.pair(pts_t, pts_t) + settings.nugget * torch.eye(pts.shape[0])
    m = settings.basis_size
    mono = torch.as_tensor(evaluate_monomials(pts, settings.polynomial_degree, m,
                                              np.zeros(3), np.ones(3)))
    ortho = torch.linalg.qr(mono)[0]

    def matvec_partial(tree):
        def fn(w, level_key):
            lv = tree.levels[-1 if level_key == "coarse" else level_key]
            idx = torch.as_tensor(lv.point_indices)
            out = torch.zeros_like(w)
            out[idx] = a[idx] @ w[: pts.shape[0]] + mono[idx] @ w[pts.shape[0]:]
            return out
        return fn

    rg = torch.as_tensor(np.random.default_rng(23).standard_normal((pts.shape[0] + m, 1)))
    want = schwarz_preconditioner(rg, stored, matvec_partial(stored), settings, ortho)
    got = schwarz_preconditioner(rg, recomp, matvec_partial(recomp), settings, ortho)
    assert _rel(got.numpy(), want.numpy()) < 1e-10


# ------------------------------------------------------ (f) gated fit


def test_gated_recompute_fit_matches_jax_residual_class(monkeypatch):
    """A small iterative fit with the node-tile gate forced (every tree
    gated) and every Schwarz level in recompute mode converges like the
    JAX package's fit under the same settings: both reach the 1e-6 l2
    residual and honour the data to 5e-6."""
    monkeypatch.setenv(GATE, "0")
    monkeypatch.setenv("FERREUS_RBF_TPU_DDM_RECOMPUTE", "1")
    monkeypatch.setenv("FERREUS_RBF_TPU_DDM_MEM_GB", "1e-6")
    pts = _clustered()[::2]
    vals = jrt.RBFTestFunctions.f1_3d(pts)
    calls = {"cells": 0}
    real = tapi.near_field_cells

    def counted(*args, **kw):
        calls["cells"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(tapi, "near_field_cells", counted)

    def params(mod):
        p = mod.Params.builder(mod.RBFKernelType.Linear).naive_solve_threshold(1000).build()
        p.ddm_params = mod.DDMParams(leaf_threshold=300, overlap_quota=0.5, coarse_ratio=0.25,
                                     coarse_threshold=400)
        return p

    jfit = jrt.RBFInterpolator(pts, vals, jrt.InterpolantSettings(
        kernel_type=jrt.RBFKernelType.Linear), params=params(jrt))
    tracer = timing.enable_global_tracer()
    try:
        pfit = prt.RBFInterpolator(pts, vals, prt.InterpolantSettings(
            kernel_type=prt.RBFKernelType.Linear), params=params(prt), device="cpu")
    finally:
        timing.disable_global_tracer()
    assert calls["cells"] > 0
    done = [e for e in tracer.events if e["event"] == "solve_done"]
    assert done and done[-1]["converged"] and done[-1]["residual"] <= 1e-6
    for fit in (jfit, pfit):
        assert np.max(np.abs(fit.evaluate_at_source(True) - vals)) < 5e-6
