"""The port's sharding (``ferreus_rbf_tpu_torch/parallel``) at eight ranks
on the CPU, the size of an eight-card H100 host, and the pieces of a pass
at any world size.

One group of eight gloo ranks per module (``ranks8``, started as
``tests/test_torch_sharding.py`` starts its four, one torch thread each)
runs on that module's data: the clustered adaptive tree (M2P and P2L; 189
leaves, 201 M2L slots and 189 target rows, none of which divides by 8),
its Schwarz points and its fit. Each rank computes what it owns of the
one-rank references (no mesh), then every check under an eight-rank mesh,
and writes its results; the JAX package's unsharded gated matvec runs in
the test process meanwhile. Checks, bit for bit one rank's on every rank:

1. ``make_mesh(8)`` on the CPU: one "sp" axis of eight ranks;
2. ``evaluate_device`` at f32 and f64, ungated and with the M2P node-tile
   gate forced (M2P on ``near_field_cells``), with the package's block
   minimums (this tree's P2M and L2P are one block each, on one rank, and
   the other ranks add zeros; the M2L, in chunks of a few slots, and the
   near field's rows split eight ways) and with every pass cut into
   ``parallel.BLOCKS`` blocks (minimums of 1, so every rank owns some of
   each pass);
3. the gated matvec within 1e-5 (f32) and 1e-12 (f64) of the JAX
   package's unsharded gated matvec;
4. the Schwarz fine-level solves, a level cut into blocks of one domain up;
5. one fit on the fused path, every pass cut into ``BLOCKS`` blocks.

The pieces of a pass are also checked without processes: at world sizes
1, 3, 5, 8 and 16 the ranks' pieces, in rank order, are one rank's.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from ferreus_rbf_tpu_torch import parallel
from test_torch_sharding import (  # noqa: F401 (an autouse fixture)
    TIMEOUT_S,
    _clustered,
    _ddm_params,
    _ddm_points,
    _fit,
    _fit_data,
    _jax_gated_matvec,
    _matvecs,
    _one_torch_thread,
    _port_tree,
    _same_on_every_rank,
    _tps_settings,
)

WORLD = 8
CUTS = ("package", "split")


def _run_rank(rank, init_file, out_dir):
    """One rank of the group: the one-rank references this rank owns (no
    mesh), then every sharded check under the mesh; writes
    ``rank<r>.npz``."""
    import datetime

    torch.set_num_threads(1)
    import ferreus_rbf_tpu_torch as prt
    from ferreus_rbf_tpu_torch.ops.fmm import api as fmm_api
    from ferreus_rbf_tpu_torch.solver import ddm as ddm_mod
    from ferreus_rbf_tpu_torch.solver.ddm import DDMTree

    # the Schwarz levels hold a few dozen domains: blocks of one domain up
    ddm_mod._MIN_BLOCK_DOMAINS = 1
    package = (fmm_api._MIN_BLOCK_LEAVES, fmm_api._MIN_BLOCK_ROWS)

    def cut_passes(cut):
        mins = package if cut == "package" else (1, 1)
        fmm_api._MIN_BLOCK_LEAVES, fmm_api._MIN_BLOCK_ROWS = mins

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    out = {}
    pts = _clustered()
    settings = _tps_settings(prt)
    settings.set_basis_size(3)
    residual = torch.as_tensor(
        np.random.default_rng(11).standard_normal((1100 + settings.basis_size, 2)))

    def ddm_solves(tree, tag):
        for lvl in range(len(tree.levels) - 1):
            out[f"{tag}_lvl{lvl}"] = tree.solve_fine_level(lvl, residual).numpy()

    def matvecs(tree, tag):
        for cut in CUTS:
            cut_passes(cut)
            _matvecs(tree, out, f"{tag}_{cut}")
            if parallel.active_mesh() is not None:
                out[f"{tag}_{cut}_shares"] = np.asarray(list(tree.shares("src").values()))

    # one-rank references, spread over the ranks
    if rank == 0:
        ddm_solves(DDMTree(_ddm_points(), settings, _ddm_params(prt),
                           factor_dtype=torch.float64, device="cpu"), "ref_ddm")
    elif rank in (1, 2):
        tag = "mv" if rank == 1 else "gated"
        matvecs(_port_tree(pts, gated=rank == 2), f"ref_{tag}")
    elif rank == 3:
        cut_passes("split")
        c = _fit(prt, fused=True).coefficients
        out["ref_fit"] = np.concatenate([c.point_coefficients, c.poly_coefficients])

    mesh = parallel.make_mesh(WORLD, device_type="cpu")
    out["mesh"] = np.asarray([mesh.size, parallel.shard_axis_size(mesh, "sp"), *mesh.shape,
                              *mesh.coords])
    with parallel.use_mesh(mesh):
        tree = DDMTree(_ddm_points(), settings, _ddm_params(prt), factor_dtype=torch.float64,
                       device="cpu")
        ddm_solves(tree, "ddm")
        out["ddm_domains"] = np.asarray([tree.domains_rank, tree.domains])
        for tag, gated in (("mv", False), ("gated", True)):
            tree = _port_tree(pts, gated)
            out[f"{tag}_is_gated"] = np.asarray(tree._m2p_tiles_gated)
            matvecs(tree, tag)
        cut_passes("split")
        fit = _fit(prt, True, mesh)
        c = fit.coefficients
        out["fit"] = np.concatenate([c.point_coefficients, c.poly_coefficients])
        resid = fit.evaluate_at_source() - _fit_data()[1]
        out["fit_resid"] = np.linalg.norm(resid) / np.linalg.norm(_fit_data()[1])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    """Run the group of eight ranks once; meanwhile, the JAX package's
    unsharded gated matvec in this process. Returns ([rank results], jax
    reference)."""
    d = tmp_path_factory.mktemp("ranks8")
    ctx = tmp.start_processes(_run_rank, args=(str(d / "init"), str(d)), nprocs=WORLD,
                              join=False, start_method="spawn")
    try:
        jax_ref = _jax_gated_matvec()
        deadline = time.monotonic() + 2 * TIMEOUT_S
        while not ctx.join(timeout=1):  # raises when a rank fails
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks did not finish in {2 * TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)], jax_ref


def test_make_mesh_takes_eight_ranks_on_the_cpu(ranks8):
    results, _ = ranks8
    assert [tuple(r["mesh"]) for r in results] == [(8, 8, 8, r) for r in range(WORLD)]


def test_ddm_bucket_solves_match_one_rank_at_eight(ranks8):
    results, _ = ranks8
    levels = sorted(k[len("ddm_"):] for k in results[0] if k.startswith("ddm_lvl"))
    assert levels
    for lvl in levels:
        assert _same_on_every_rank(results, f"ddm_{lvl}", 0) == [True] * WORLD, lvl
    owned = [int(r["ddm_domains"][0]) for r in results]
    assert all(n > 0 for n in owned) and sum(owned) == int(results[0]["ddm_domains"][1])


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("tag", ["mv", "gated"])
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_sharded_matvec_matches_one_rank_at_eight(ranks8, cut, tag, prec):
    results, _ = ranks8
    ref_rank = 1 if tag == "mv" else 2
    assert bool(results[0][f"{tag}_is_gated"]) == (tag == "gated")
    key = f"{tag}_{cut}_{prec}"
    assert _same_on_every_rank(results, key, ref_rank) == [True] * WORLD
    assert np.isfinite(results[0][key]).all()


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("tag", ["mv", "gated"])
def test_shares_cover_every_item_at_eight(ranks8, cut, tag):
    """(owned, total) per rank of the P2M leaves, M2L slots, L2P rows and
    near-field rows: they cover each pass; the M2L and the near field
    split eight ways; with the package's minimums this small tree's P2M
    and L2P fall to one rank each, split, every rank owns some of each."""
    results, _ = ranks8
    shares = np.stack([r[f"{tag}_{cut}_shares"] for r in results])  # (rank, item, 2)
    totals = shares[0, :, 1]
    assert all(t % WORLD for t in totals), totals
    assert (shares[:, :, 0].sum(0) == totals).all()
    assert (shares[:, [1, 3], 0] > 0).all()
    if cut == "split":
        assert (shares[:, :, 0] > 0).all()
    else:
        assert ((shares[:, [0, 2], 0] == totals[[0, 2]]).sum(0) == 1).all()


@pytest.mark.parametrize("prec,tol", [("f32", 1e-5), ("f64", 1e-12)])
@pytest.mark.parametrize("cut", CUTS)
def test_gated_matvec_at_eight_matches_jax_unsharded(ranks8, prec, tol, cut):
    results, jax_ref = ranks8
    got, want = results[0][f"gated_{cut}_{prec}"], jax_ref[prec]
    assert float(np.max(np.abs(got - want)) / np.max(np.abs(want))) < tol


def test_fused_fit_at_eight_matches_one_rank(ranks8):
    results, _ = ranks8
    want = results[3]["ref_fit"]
    assert [np.array_equal(r["fit"], want) for r in results] == [True] * WORLD
    assert all(float(r["fit_resid"]) < 1e-4 for r in results)


# ------------------------------------------------- pieces, in-process
PASSES = {
    # (group sizes, steps, minimum items per block)
    "clustered_leaves": ([189], None, 1),
    "config2_m2l": ([64, 512], [53, 53], 256),
    "albatite_m2l": ([30, 122, 331, 29], [7, 9, 11, 13], 1),
    "ddm_buckets": ([3000, 40, 40, 1020, 7], None, 2048),
    "fewer_items_than_blocks": ([5], None, 1),
    "empty_groups": ([0, 10, 0, 3], [4, None, 2, None], 1),
}


@pytest.mark.parametrize("world", [1, 3, 5, 8, 16])
@pytest.mark.parametrize("name", sorted(PASSES))
def test_pieces_are_one_ranks_at_any_world_size(name, world):
    """The ranks' pieces are disjoint, cover every item, and, laid in rank
    order, are exactly one rank's: the cuts do not depend on the world
    size."""
    sizes, steps, min_block = PASSES[name]
    blocks = parallel.pass_blocks(sum(sizes), min_block)
    assert 1 <= blocks <= parallel.BLOCKS
    one = parallel.pieces(sizes, None, steps, blocks)
    base = parallel.Mesh(None, 0, world, torch.device("cpu"), "gloo", ("sp",), (world,), (0,))
    per_rank = [parallel.pieces(sizes, dataclasses.replace(base, rank=r, coords=(r,)), steps,
                                blocks) for r in range(world)]
    assert [p for ps in per_rank for p in ps] == one
    covered = [np.zeros(s, int) for s in sizes]
    for g, lo, hi in one:
        assert 0 <= lo < hi <= sizes[g]
        covered[g][lo:hi] += 1
    assert all((c == 1).all() for c in covered)
    if world > blocks:  # a rank past the pass's blocks owns nothing of it
        assert sum(bool(ps) for ps in per_rank) <= blocks


@pytest.mark.parametrize("world", [1, 3, 5, 8, 16])
def test_rank_range_is_the_ranks_run_of_blocks(world):
    """``rank_range`` tiles the items in rank order, and for one group
    without a step it spans exactly the rank's pieces."""
    base = parallel.Mesh(None, 0, world, torch.device("cpu"), "gloo", ("sp",), (world,), (0,))
    for n, min_block in ((189, 1), (15001, 2048), (3, 1), (0, 1)):
        blocks = parallel.pass_blocks(n, min_block)
        spans = []
        for r in range(world):
            mesh = dataclasses.replace(base, rank=r, coords=(r,))
            lo, hi = parallel.rank_range(n, mesh, blocks)
            mine = parallel.pieces([n], mesh, None, blocks)
            assert (lo, hi) == ((mine[0][1], mine[-1][2]) if mine else (lo, lo))
            spans.append((lo, hi))
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
