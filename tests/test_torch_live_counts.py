"""Live counts and work items of H3 and H4 on the CPU.

``near_field_grad`` (H3) and ``near_field_cells(_grad)`` (H4) take live
counts (``tcnt``: target slots per row; ``scnt``: source slots per tile)
and run, on the card, over the work list of ``near_field.work_items``. On
the CPU their plain versions honour the same counts. Here:

* ``near_field_grad_plain`` with counts against the Pallas kernel
  ``p2p_pairlist_df64_grad`` in interpret mode, fed the same sources with
  the slots past ``scnt`` zeroed: 1e-10 of max |reference| at the live
  target slots, the tolerance of ``tests/test_torch_gradients.py`` (the
  Pallas kernel's spheroidal values are held to 1e-7 there, for its df64
  phi); dead target slots exactly 0;
* ``near_field_cells(_grad)_plain`` with ``tcnt`` against the JAX
  package's gated M2P on its own row tables, at the live target slots:
  ``p2p_rows`` in interpret mode for f32, 1e-5 of the largest sum of
  |terms| (two f32 summation orders differ in proportion to it; the
  measure ``chip_smoke.py`` holds H4's f32 form to); the virtual-node scan
  ``_near_field_class`` for f64 values and gradients, 1e-12 of max
  |reference|, as in ``tests/test_torch_at_scale.py``; dead target slots
  exactly 0;
* the work list of a gated tree's cell table equals, entry for entry after
  mapping tile ids to cells, the ungated tree's list over its node tiles;
* ``work_items`` drops ids outside the table's range as it drops the
  sentinel;
* a plain-torch emulation of H3's items and second passes (values and
  gradients, split rows summed in item order) equals the plain version to
  1e-15 of max |out|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ferreus_rbf_tpu.config import FmmCompressionType as JFC
from ferreus_rbf_tpu.config import FmmParams as JFP
from ferreus_rbf_tpu.ops import df64 as jdf
from ferreus_rbf_tpu.ops import kernels as jk
from ferreus_rbf_tpu.ops.fmm import api as japi
from ferreus_rbf_tpu.ops.fmm import p2p_pallas as pp
from ferreus_rbf_tpu_torch.config import FmmCompressionType, FmmParams
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops.fmm import api as tapi
from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf

GATE = "FERREUS_RBF_TPU_NODETILE_BYTES"
P_ORDER = 4
FMM = dict(interpolation_order=P_ORDER, max_points_per_cell=64, epsilon=1e-4)


def _params(mod, name):
    kw = {"base_range": 1.1, "total_sill": 0.8} if "Spheroidal" in name else {}
    return mod.KernelParams(mod.KernelType(name), **kw)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / np.max(np.abs(want)))


def _dead(tcnt, t):
    return np.arange(t)[None, :] >= np.asarray(tcnt)[:, None]


# ------------------------------------------------------------------ H3
R, T, S, L, U, NRHS = 6, 16, 128, 5, 4, 2


@pytest.fixture(scope="module")
def tile_ops():
    """Tiles with random weights in every slot, live counts that cut them
    (scnt 0..S, the sentinel 0) and rows of 0 to T live targets."""
    rng = np.random.default_rng(17)
    tgt = rng.random((R, T, 3)) - 0.5
    src = rng.random((L + 1, 3, S)) - 0.5
    w = rng.standard_normal((L + 1, NRHS, S))
    w[L] = 0.0  # the sentinel tile
    nbr = rng.integers(0, L, (U, R)).astype(np.int32)
    nbr[U - 1, ::2] = L
    cnt = rng.integers(1, U + 1, R).astype(np.int32)
    cnt[0] = 0
    scnt = rng.integers(0, S + 1, L + 1).astype(np.int32)
    scnt[:2] = (S, 0)
    scnt[L] = 0
    tcnt = np.array([T, 0, 1, 9, T - 3, 12], np.int32)
    tgt[3, :4] = src[nbr[0, 3], :, :4].T  # exact copies of live sources
    return {"tgt": tgt, "src": src, "w": w, "nbr": nbr, "cnt": cnt, "scnt": scnt,
            "tcnt": tcnt}


def _pair_list(nbr):
    """Sorted (row, tile) pairs, one sentinel pair per row + the true pairs,
    ``first`` flagging each row's first pair (as the JAX package builds
    them)."""
    rows_true = np.nonzero(nbr.T != L)
    rows = np.concatenate([np.arange(R), rows_true[0]])
    tiles = np.concatenate([np.full(R, L), nbr.T[rows_true]])
    order = np.argsort(rows, kind="stable")
    rows, tiles = rows[order], tiles[order]
    first = np.zeros(rows.size, np.int32)
    first[0] = 1
    first[1:] = rows[1:] != rows[:-1]
    return (jnp.asarray(rows.astype(np.int32)), jnp.asarray(tiles.astype(np.int32)),
            jnp.asarray(first))


def _torch_tiles(o):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))  # noqa: E731
    return (t(o["tgt"]), t(o["src"]), t(o["w"]), t(o["nbr"])), t(o["tcnt"]), t(o["scnt"])


@pytest.mark.parametrize(
    "name", ["LinearRbf", "ThinPlateSplineRbf", "CubicRbf", "Spheroidal5Rbf", "OneOverR4"])
def test_grad_plain_with_counts_matches_p2p_pairlist_df64_grad(tile_ops, name):
    o = tile_ops
    w_live = o["w"] * (np.arange(S)[None, None, :] < o["scnt"][:, None, None])
    th, tl = jdf.from_f64(jnp.asarray(o["tgt"]))
    sh, sl = jdf.from_f64(jnp.asarray(o["src"]))
    planes, _ = jdf.slice_planes(*jdf.from_f64(jnp.asarray(w_live)), (2,), 6)
    oh, ol, gh, gl = pp.p2p_pairlist_df64_grad(
        th, tl, sh, sl, jnp.transpose(planes, (1, 0, 2, 3)), *_pair_list(o["nbr"]),
        kparams=_params(jk, name), nsl=L + 1, keep=L + 1, interpret=True)
    want_v = np.asarray(jdf.to_f64(oh, ol)).transpose(0, 2, 1)
    want_g = np.asarray(jdf.to_f64(gh, gl)).reshape(R, 3, NRHS, T).transpose(0, 3, 2, 1)
    args, tcnt, scnt = _torch_tiles(o)
    before = dict(nf.LAUNCHES)
    got_v, got_g = nf.near_field_grad(*args, kparams=_params(tk, name), tcnt=tcnt, scnt=scnt)
    assert nf.LAUNCHES == before  # CPU tensors run the plain version
    dead = _dead(o["tcnt"], T)
    assert np.all(got_v.numpy()[dead] == 0.0) and np.all(got_g.numpy()[dead] == 0.0)
    live = ~dead
    assert _rel(got_g.numpy()[live], want_g[live]) < 1e-10
    tol = 1e-7 if "Spheroidal" in name else 1e-10
    assert _rel(got_v.numpy()[live], want_v[live]) < tol
    # the counts change nothing at the live slots but drop the dead sources
    free_v, free_g = nf.near_field_grad_plain(*args[:2], torch.as_tensor(w_live), args[3],
                                              kparams=_params(tk, name))
    assert torch.equal(got_v[torch.as_tensor(live)], free_v[torch.as_tensor(live)])
    assert torch.equal(got_g[torch.as_tensor(live)], free_g[torch.as_tensor(live)])


def test_grad_counts_are_checked(tile_ops):
    args, tcnt, scnt = _torch_tiles(tile_ops)
    kp = _params(tk, "LinearRbf")
    with pytest.raises(TypeError):
        nf.near_field_grad(*args, kparams=kp, tcnt=tcnt.long())
    with pytest.raises(ValueError):
        nf.near_field_grad(*args, kparams=kp, scnt=scnt[:-1])


def _emulate_grad(args, tcnt, scnt, kparams):
    """H3's items and its two second passes in plain torch, with NaN
    wherever nothing wrote."""
    tgt, src, w, nbr = args
    wl = nf.work_items(nbr, None, tcnt, scnt, t=T, s=S, l1=L + 1)
    kernel = tk.make_kernel(kparams)
    nan = float("nan")
    out = torch.full((R, T, NRHS), nan, dtype=torch.float64)
    gout = torch.full((R, T, NRHS, 3), nan, dtype=torch.float64)
    part = torch.full((wl.nparts, nf._SPAN, NRHS), nan, dtype=torch.float64)
    gpart = torch.full((wl.nparts, nf._SPAN, NRHS, 3), nan, dtype=torch.float64)
    for row, t0, tlen, e0, e1, dst in wl.items.tolist():
        acc = torch.zeros((tlen, NRHS), dtype=torch.float64)
        gacc = torch.zeros((tlen, NRHS, 3), dtype=torch.float64)
        for tile, n in wl.entries[e0:e1].tolist():
            kmat, gmat = kernel.pair_with_grad(tgt[row, t0:t0 + tlen], src[tile, :, :n].T)
            acc += kmat @ w[tile, :, :n].T
            gacc += torch.einsum("tsd,ks->tkd", gmat, w[tile, :, :n])
        if dst < 0:
            out[row, t0:t0 + tlen], gout[row, t0:t0 + tlen] = acc, gacc
        else:
            part[dst, :tlen], gpart[dst, :tlen] = acc, gacc
    for row in range(R):
        for t in range(T):
            first, k = wl.segtab[row, t // nf._SPAN].tolist() if t < tcnt[row] else (0, 0)
            if k != 1:
                out[row, t] = sum((part[first + c, t] for c in range(k)),
                                  torch.zeros(NRHS, dtype=torch.float64))
                gout[row, t] = sum((gpart[first + c, t] for c in range(k)),
                                   torch.zeros((NRHS, 3), dtype=torch.float64))
    return out, gout, wl


@pytest.mark.parametrize("budget", [40, 256, 1 << 30])
@pytest.mark.parametrize("name", ["LinearRbf", "Spheroidal5Rbf"])
def test_emulated_grad_items_match_plain(tile_ops, monkeypatch, name, budget):
    monkeypatch.setattr(nf, "_ITEM_SOURCES", budget)
    args, tcnt, scnt = _torch_tiles(tile_ops)
    kp = _params(tk, name)
    got_v, got_g, wl = _emulate_grad(args, tcnt, scnt, kp)
    assert (wl.nparts > 0) == (budget < 1 << 30)  # only an unbounded item splits no row
    want_v, want_g = nf.near_field_grad_plain(*args, kparams=kp, tcnt=tcnt, scnt=scnt)
    for got, want in ((got_v, want_v), (got_g, want_g)):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-15 * float(want.abs().max())


# ------------------------------------------------------------------ H4
def _clustered():
    """The clustered points of ``tests/test_torch_at_scale.py``."""
    rng = np.random.default_rng(37)
    return np.concatenate([rng.random((2400, 3)) * 0.12, rng.random((600, 3))])


def _port_tree(pts, name):
    params = FmmParams(compression_type=FmmCompressionType.ACA, **FMM)
    return tapi.FmmTree(pts, P_ORDER, _params(tk, name), adaptive_tree=True, sparse=True,
                        params=params, device="cpu")


@pytest.fixture(scope="module")
def gated():
    """The JAX package's and the port's gated trees on the clustered
    points, the JAX package's gated row tables, random multipole
    coefficients and live target counts cut to ~half of each row's real
    targets (so that dead slots hold real targets)."""
    pts = _clustered()
    mp = pytest.MonkeyPatch()
    mp.setenv(GATE, "0")
    try:
        jt = japi.FmmTree(pts, P_ORDER, _params(jk, "LinearRbf"), adaptive_tree=True,
                          sparse=True, params=JFP(compression_type=JFC.ACA, **FMM))
        tt = _port_tree(pts, "LinearRbf")
    finally:
        mp.undo()
    jb = jt._bin_targets(pts, "src")
    jt._ensure_scan_tables(jb)
    tt.prepare_targets(pts, "src")
    tb = tt._target_cache["src"]
    assert jt._m2p_tiles_gated and tt._m2p_tiles_gated
    mult = np.random.default_rng(4).standard_normal((tt.tree.num_cells, tt.nnodes, 2))
    tcnt = (tb["tcnt"] + 1) // 2
    return {"jax": jt, "port": tt, "jb": jb, "tb": tb, "ntl": tb["tcells"].shape[0],
            "mult": mult, "tcnt": tcnt.int()}


def _cells(g, name, dtype, grad=False):
    tt, tb = g["port"], g["tb"]
    fn = nf.near_field_cells_grad if grad else nf.near_field_cells
    return fn(tb[torch.float64]["tpts"].to(dtype), tb["wtab"], tb["wcnt"], *tt._cell_geometry(),
              torch.as_tensor(g["mult"]).to(dtype), kparams=_params(tk, name), tcnt=g["tcnt"])


def _virtual_nodes(jt, tab):
    centers = np.asarray(jt._dev["cell_centers"])
    lengths = np.asarray(jt._dev["cell_lengths"])
    nodes = np.asarray(jt._dev["nodes_nd"])
    p = nodes.shape[0]
    c = tab // p
    return centers[c] + (lengths[c][..., None] * 0.5) * nodes[tab % p]


def _abs_sum(g, name):
    """The largest sum of |terms| over the gated M2P's rows, slots and
    right-hand sides, sum_s |phi| * |mult|, in f64: two f32 summation
    orders differ in proportion to it, not to |sum| (``chip_smoke.py``
    holds H4's f32 form against the same scale)."""
    tt, tb = g["port"], g["tb"]
    tgt = tb[torch.float64]["tpts"]
    n_src, gather = nf._cell_gather(tgt, tb["wtab"], tb["wcnt"], *tt._cell_geometry(),
                                    torch.as_tensor(g["mult"]).abs())
    kernel = tk.make_kernel(_params(tk, name))
    return max(float(torch.einsum("cts,crs->ctr", kernel.phi_r2(r2).abs(), wv).max())
               for _, r2, _, wv in nf._plain_chunks(tgt, n_src, gather))


@pytest.mark.parametrize("name", ["LinearRbf", "ThinPlateSplineRbf", "Spheroidal5Rbf"])
def test_cells_plain_with_tcnt_matches_p2p_rows(gated, name):
    g = gated
    got = _cells(g, name, torch.float32).numpy()
    t = got.shape[1]
    dead = _dead(g["tcnt"], t)
    assert dead.any() and np.all(got[dead] == 0.0)
    tpts = np.asarray(g["jb"]["targets_pad"])[np.asarray(g["jb"]["tgt_idx"])]
    mult_flat = g["mult"].reshape(-1, 2)
    scale = _abs_sum(g, name)
    checked = 0
    for rows, tab, mask in g["jb"]["m2p_groups_host"]:
        rows, tab, mask = (x[rows < g["ntl"]] for x in (rows, tab, mask))
        sp = _virtual_nodes(g["jax"], tab).astype(np.float32)
        wv = np.where(mask[..., None], mult_flat[tab], 0.0).astype(np.float32)
        want = np.asarray(pp.p2p_rows(
            jnp.asarray(tpts[rows], jnp.float32), jnp.asarray(sp.transpose(0, 2, 1)),
            jnp.asarray(wv.transpose(0, 2, 1)), kparams=_params(jk, name), interpret=True))
        live = ~dead[rows]
        assert np.max(np.abs(got[rows][live] - want[live])) < 1e-5 * scale
        checked += int(live.sum())
    assert checked > 0


@pytest.mark.parametrize("name", ["LinearRbf", "CubicRbf", "Spheroidal5Rbf"])
def test_cells_grad_plain_with_tcnt_matches_virtual_node_scan(gated, name):
    g = gated
    got_v = _cells(g, name, torch.float64).numpy()
    got_gv, got_g = (x.numpy() for x in _cells(g, name, torch.float64, grad=True))
    np.testing.assert_array_equal(got_gv, got_v)
    dead = _dead(g["tcnt"], got_v.shape[1])
    assert np.all(got_v[dead] == 0.0) and np.all(got_g[dead] == 0.0)
    jb, jdev = g["jb"], g["jax"]._dev
    tpts = jnp.asarray(np.asarray(jb["targets_pad"])[np.asarray(jb["tgt_idx"])])
    kernel = jk.make_kernel(_params(jk, name), dtype=jnp.float64)
    src = (jdev["cell_centers"], jdev["cell_lengths"], jdev["nodes_nd"])
    mult_flat = jnp.asarray(g["mult"].reshape(-1, 2))
    for (rows, tab, mask), (_w, c_scan, _c) in zip(jb["m2p_groups_host"], jb["m2p_meta"]):
        vals, grads = japi._near_field_class(
            kernel, _params(jk, name), False, True, jnp.float64, tpts, jb["tgt_mask"], src,
            mult_flat, jnp.asarray(rows), jnp.asarray(tab), jnp.asarray(mask), c_scan)
        keep = rows < g["ntl"]
        live = ~dead[rows[keep]]
        assert _rel(got_v[rows[keep]][live], np.asarray(vals)[keep][live]) < 1e-12
        assert _rel(got_g[rows[keep]][live], np.asarray(grads)[keep][live]) < 1e-12


def test_cells_tcnt_is_checked(gated):
    tt, tb = gated["port"], gated["tb"]
    ops = (tb[torch.float64]["tpts"], tb["wtab"], tb["wcnt"], *tt._cell_geometry(),
           torch.as_tensor(gated["mult"]))
    kp = _params(tk, "LinearRbf")
    with pytest.raises(TypeError):
        nf.near_field_cells(*ops, kparams=kp, tcnt=gated["tcnt"].long())
    with pytest.raises(ValueError):
        nf.near_field_cells_grad(*ops, kparams=kp, tcnt=gated["tcnt"][:-1])


def test_gated_work_list_is_the_ungated_one(monkeypatch):
    """The forced-gate tree's M2P list over global cell ids is, after
    mapping each node tile to its cell, the ungated tree's list over node
    tiles, item for item: H4 walks the ungated M2P's items in its order."""
    pts = _clustered()
    lists = {}
    for gate in ("default", "0"):
        if gate == "0":
            monkeypatch.setenv(GATE, "0")
        else:
            monkeypatch.delenv(GATE, raising=False)
        tree = _port_tree(pts, "LinearRbf")
        assert tree._m2p_tiles_gated == (gate == "0")
        tree.prepare_targets(pts, "src")
        b = tree._target_cache["src"]
        t = b[torch.float64]["tpts"].shape[1]
        l1 = tree.tree.num_cells + 1 if gate == "0" else tree._m2p_nw + 1
        lists[gate] = (nf.work_items(b["wtab"], b["wcnt"], b["tcnt"], None, t=t,
                                     s=tree.nnodes, l1=l1), tree)
    (ungated, ut), (gated_wl, _) = lists["default"], lists["0"]
    assert ungated.items.shape[0] > 0 and torch.equal(gated_wl.items, ungated.items)
    assert torch.equal(gated_wl.segtab, ungated.segtab) and gated_wl.nparts == ungated.nparts
    mapped = ungated.entries.clone()
    mapped[:, 0] = ut._dev["wtile_cells"][ungated.entries[:, 0].long()].int()
    assert torch.equal(gated_wl.entries, mapped)


def test_work_list_drops_ids_outside_the_table():
    """An id below 0 or past the sentinel is dropped like the sentinel, as
    the plain cell version drops it (``_cell_gather``)."""
    rng = np.random.default_rng(3)
    nbr = torch.as_tensor(rng.integers(0, L, (U, R)).astype(np.int32))
    tcnt = torch.full((R,), T, dtype=torch.int32)
    odd = nbr.clone()
    odd[1, ::2] = -1
    odd[2, 1::2] = L + 5
    clean = torch.where((odd >= 0) & (odd < L), odd, L)
    got, want = (nf.work_items(x, None, tcnt, None, t=T, s=S, l1=L + 1) for x in (odd, clean))
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    assert int((want.entries[:, 0] == L).sum()) == 0
