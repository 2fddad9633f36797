"""The H1/H2 work list (``ops/fmm/near_field.py`` ``work_items``) on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``). Here
``work_items``, which feeds them, is held to its contract on small operands with
a skewed neighbour list, sparse target rows (tcnt in {0, 1, 9, T}) and
tiles of 0 to S live sources: every (row, live target slot, live listed
tile) is covered once, nothing dead is covered, no item exceeds the budget,
the order is longest first and the same every build, and a plain-torch
emulation of the items and the second pass equals ``near_field_plain`` to
1e-15 of max |out| in float64. ``near_field_plain``'s live counts are held
against the uncounted sum. A few seconds in all.
"""

import numpy as np
import pytest
import torch

import ferreus_rbf_tpu_torch as frt
from ferreus_rbf_tpu_torch.ops import kernels as tk
from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree

R, T, S, NT, U, NRHS = 24, 200, 64, 30, 40, 2


def _params(name):
    kw = {"base_range": 1.1, "total_sill": 0.8} if "Spheroidal" in name else {}
    return tk.KernelParams(tk.KernelType(name), **kw)


def _operands(seed):
    """(tgt, src, w, nbr, cnt, tcnt, scnt) as float64/int32 CPU tensors.
    T = 200 > 128 gives rows two target spans. Row 1 lists all U = 40
    tiles (up to 2,560 live sources), the other rows at most 8; tcnt takes
    0, 1, 9 and T; scnt runs from 0 to S; the last tile is the sentinel and
    weights past scnt are zero, as ``FmmTree`` builds them."""
    rng = np.random.default_rng(seed)
    scnt = rng.integers(0, S + 1, NT + 1)
    scnt[:3] = (0, S, 1)
    scnt[NT] = 0
    src = rng.random((NT + 1, 3, S)) - 0.5
    w = rng.standard_normal((NT + 1, NRHS, S))
    w *= np.arange(S)[None, None, :] < scnt[:, None, None]
    nbr = rng.integers(0, NT, (U, R))
    nbr[U - 1, ::2] = NT  # sentinel entries
    nbr[:, 1] = np.arange(U) % NT
    cnt = rng.integers(0, 9, R)
    cnt[:2] = (0, U)
    tcnt = rng.integers(0, T + 1, R)
    tcnt[1:6] = (T, 0, 1, 9, 128)
    tgt = rng.random((R, T, 3)) - 0.5
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)  # noqa: E731
    return (torch.as_tensor(tgt), torch.as_tensor(src), torch.as_tensor(w), i32(nbr),
            i32(cnt), i32(tcnt), i32(scnt))


def _build(ops):
    _, _, _, nbr, cnt, tcnt, scnt = ops
    return nf.work_items(nbr, cnt, tcnt, scnt, t=T, s=S, l1=NT + 1)


def _live_entries(ops):
    """Each row's live (tile, live sources) in list order, and the row of
    each: the entries the items must cover."""
    _, _, _, nbr, cnt, _, scnt = ops
    tiles, rows = [], []
    for r in range(R):
        for u in range(int(cnt[r])):
            tile = int(nbr[u, r])
            if tile != NT and int(scnt[tile]) > 0:
                tiles.append((tile, int(scnt[tile])))
                rows.append(r)
    return torch.tensor(tiles, dtype=torch.int32).view(-1, 2), torch.tensor(rows)


BUDGETS = [40, 256, 2048]  # 40 < S: a tile above the budget is an item alone


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("seed", [0, 1])
def test_items_cover_each_live_pair_once(monkeypatch, seed, budget):
    monkeypatch.setattr(nf, "_ITEM_SOURCES", budget)
    ops = _operands(seed)
    wl = _build(ops)
    want, erow = _live_entries(ops)
    assert torch.equal(wl.entries, want)  # sentinels, dead tiles, entries past cnt dropped
    tl = ops[5].long()
    cover = torch.zeros((want.shape[0], T), dtype=torch.long)
    for row, t0, tlen, e0, e1, _ in wl.items.tolist():
        assert 1 <= tlen <= nf._SPAN and t0 % nf._SPAN == 0 and t0 + tlen <= tl[row]
        assert e0 < e1 and bool((erow[e0:e1] == row).all())
        cover[e0:e1, t0:t0 + tlen] += 1
    live = torch.arange(T)[None, :] < tl[erow][:, None]
    assert torch.equal(cover, live.long())


@pytest.mark.parametrize("budget", BUDGETS)
def test_items_keep_the_budget_and_run_longest_first(monkeypatch, budget):
    monkeypatch.setattr(nf, "_ITEM_SOURCES", budget)
    wl = _build(_operands(2))
    cost = []
    for _, _, tlen, e0, e1, _ in wl.items.tolist():
        sizes = wl.entries[e0:e1, 1]
        assert int(sizes.sum()) <= budget or e1 - e0 == 1
        cost.append(int(sizes.sum()) * tlen)
    assert cost == sorted(cost, reverse=True)
    assert bool((wl.items[:, 5] >= 0).any()) == (budget < 2048)  # the long row splits


@pytest.mark.parametrize("budget", BUDGETS)
def test_split_rows_write_partials_in_list_order(monkeypatch, budget):
    """A span cut into k >= 2 items owns partial blocks first .. first + k
    - 1 in list order; a span of one item writes the output itself."""
    monkeypatch.setattr(nf, "_ITEM_SOURCES", budget)
    wl = _build(_operands(3))
    seen = {}
    for row, t0, _, e0, _, dst in wl.items.tolist():
        seen.setdefault((row, t0 // nf._SPAN), []).append((e0, dst))
    nparts = 0
    for (row, span), its in seen.items():
        first, k = wl.segtab[row, span].tolist()
        assert k == len(its)
        dsts = [dst for _, dst in sorted(its)]
        assert dsts == ([-1] if k == 1 else list(range(first, first + k)))
        nparts += k if k >= 2 else 0
    assert nparts == wl.nparts
    assert int((wl.segtab[..., 1] > 0).sum()) == len(seen)


def _greedy_runs(ops, budget):
    """The reference cut, a loop over the live entries: [e0, e1) runs, a
    new one at each row's start and where the next entry would take the
    run past ``budget``; only rows with live targets get items."""
    entries, erow = _live_entries(ops)
    tl = ops[5]
    runs, cur = [], 0
    for i, size in enumerate(entries[:, 1].tolist()):
        if i == 0 or erow[i] != erow[i - 1] or cur + size > budget:
            runs.append([i, i + 1])
            cur = size
        else:
            runs[-1][1] = i + 1
            cur += size
    return sorted(tuple(run) for run in runs if tl[erow[run[0]]] > 0)


@pytest.mark.parametrize("budget", [1, 40, 100, 256, 2048])
@pytest.mark.parametrize("seed", [0, 10])
def test_cuts_match_a_loop_over_the_entries(monkeypatch, seed, budget):
    """``work_items`` finds its cuts for the whole list at once (binary
    lifting); they are the greedy cuts of a plain loop."""
    monkeypatch.setattr(nf, "_ITEM_SOURCES", budget)
    ops = _operands(seed)
    wl = _build(ops)
    got = sorted((e0, e1) for _, t0, _, e0, e1, _ in wl.items.tolist() if t0 == 0)
    assert got == _greedy_runs(ops, budget)


def test_work_list_is_deterministic():
    ops = _operands(4)
    a, b = _build(ops), _build(ops)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])) and a.nparts == b.nparts


def _emulate(ops, kparams):
    """The items and the second pass, in plain torch: what the kernel does,
    item by item, with NaN wherever nothing wrote."""
    tgt, src, w, _, _, tcnt, _ = ops
    wl = _build(ops)
    kernel = tk.make_kernel(kparams)
    out = torch.full((R, T, NRHS), float("nan"), dtype=torch.float64)
    part = torch.full((wl.nparts, nf._SPAN, NRHS), float("nan"), dtype=torch.float64)
    for row, t0, tlen, e0, e1, dst in wl.items.tolist():
        acc = torch.zeros((tlen, NRHS), dtype=torch.float64)
        for tile, n in wl.entries[e0:e1].tolist():
            acc += kernel.pair(tgt[row, t0:t0 + tlen], src[tile, :, :n].T) @ w[tile, :, :n].T
        if dst < 0:
            out[row, t0:t0 + tlen] = acc
        else:
            part[dst, :tlen] = acc
    for row in range(R):
        for t in range(T):
            first, k = wl.segtab[row, t // nf._SPAN].tolist() if t < tcnt[row] else (0, 0)
            if k != 1:
                s = torch.zeros(NRHS, dtype=torch.float64)
                for c in range(k):
                    s = s + part[first + c, t % nf._SPAN]
                out[row, t] = s
    return out


@pytest.mark.parametrize("budget", [40, 256])
@pytest.mark.parametrize("name", ["LinearRbf", "ThinPlateSplineRbf", "Spheroidal5Rbf"])
def test_emulated_items_match_plain(monkeypatch, name, budget):
    monkeypatch.setattr(nf, "_ITEM_SOURCES", budget)
    ops = _operands(5)
    kp = _params(name)
    got = _emulate(ops, kp)
    want = nf.near_field_plain(*ops[:5], kparams=kp, tcnt=ops[5], scnt=ops[6])
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-15 * float(want.abs().max())


@pytest.mark.parametrize("name", ["CubicRbf", "Spheroidal9Rbf"])
def test_plain_counts_mask_dead_slots(name):
    """With counts, the plain version equals the uncounted sum on live
    target slots and is 0 on dead ones; source slots past scnt weigh nothing
    whatever their weights hold."""
    tgt, src, w, nbr, cnt, tcnt, scnt = _operands(6)
    kp = _params(name)
    free = nf.near_field_plain(tgt, src, w, nbr, cnt, kparams=kp)
    noisy = torch.where(torch.arange(S)[None, None, :] < scnt.long()[:, None, None], w, 7.0)
    before = dict(nf.LAUNCHES)
    got = nf.near_field(tgt, src, noisy, nbr, cnt, kparams=kp, tcnt=tcnt, scnt=scnt)
    assert nf.LAUNCHES == before  # CPU tensors: the plain version
    live = torch.arange(T)[None, :] < tcnt.long()[:, None]
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    assert float((got[live] - free[live]).abs().max()) <= 1e-14 * float(free.abs().max())


def test_work_list_is_kept_on_its_table():
    """Built once per table and counts, rebuilt when they change."""
    _, _, _, nbr, cnt, tcnt, scnt = _operands(7)
    a = nf._work_items_on(nbr, cnt, tcnt, scnt, T, S, NT + 1)
    assert nf._work_items_on(nbr, cnt, tcnt, scnt, T, S, NT + 1) is a
    other = nf._work_items_on(nbr, cnt, tcnt.clone(), scnt, T, S, NT + 1)
    assert other is not a and torch.equal(other.items, a.items)


def test_counts_are_checked():
    tgt, src, w, nbr, cnt, tcnt, scnt = _operands(8)
    kp = _params("LinearRbf")
    with pytest.raises(TypeError):
        nf.near_field(tgt, src, w, nbr, cnt, kparams=kp, tcnt=tcnt.long())
    with pytest.raises(ValueError):
        nf.near_field(tgt, src, w, nbr, cnt, kparams=kp, scnt=scnt[:-1])


def test_tree_supplies_live_counts():
    """FmmTree's target rows and source tiles carry their live counts."""
    rng = np.random.default_rng(9)
    pts = rng.random((600, 3))
    params = frt.FmmParams(interpolation_order=3, max_points_per_cell=32, epsilon=1e-3)
    tree = FmmTree(pts, 3, _params("LinearRbf"), adaptive_tree=True, sparse=True,
                   params=params, device="cpu")
    tree.prepare_targets(pts[::3], "sub")
    binned = tree._target_cache["sub"]
    t = binned[torch.float64]["tpts"].shape[1]
    rows = binned["nbr"].shape[1]
    assert torch.equal(binned["tcnt"].long(),
                       torch.bincount(binned["inv_flat"] // t, minlength=rows))
    assert torch.equal(tree._dev["src_scnt"].long(), tree._dev["src_mask"].sum(1))
    assert int(tree._dev["src_scnt"][-1]) == 0
