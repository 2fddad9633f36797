"""The port's multi-rank sharding (``ferreus_rbf_tpu_torch/parallel``) on the
CPU: four gloo ranks, one process each, bit for bit against one rank.

One group of four ranks per module (the ``ranks`` fixture, started by
``torch.multiprocessing`` with the spawn method) runs every sharded check;
each rank writes what it computed, and the checks below read it. The
one-rank references are computed in the ranks too, with no mesh, each by
one rank. The ranks import torch and the port only: the JAX package's
reference (the unsharded gated matvec) runs in the test process while the
ranks work. Each rank pins torch to one thread, as the test process does.

Checks, as in ``tests/test_sharding.py`` for the JAX package:

1. the Schwarz fine-level solves (TPS, 1,100 points, that test's
   ``DDMParams``) under the mesh are bit for bit the one-rank solves, on
   every rank;
2. ``evaluate_device`` at f32 and f64 on a clustered adaptive tree with
   M2P and P2L, whose rows, leaves and M2L slots do not divide by 4: bit
   for bit the one-rank matvec, on every rank;
3. the same with the M2P node-tile gate forced (M2P on ``near_field_cells``),
   and within 1e-5 (f32) and 1e-12 (f64) of the JAX package's unsharded
   gated matvec (``tests/test_torch_at_scale.py``'s tolerances): the sharded
   leaf pass keeps the gated M2P;
4. a whole fit under ``use_mesh`` (1,000 points, p = 4, f64 factors) on the
   fused path and on the host loop: coefficients bit for bit the one-rank
   fit's, on every rank, and ``evaluate_at_source`` honours the values;
5. ``make_mesh``'s backend rules and its limit of ``BLOCKS`` ranks on the
   ``"sp"`` axis, ``Mesh.capturable``, ``active_mesh`` outside ``use_mesh``
   and a one-rank mesh, which is exactly the unsharded path.
"""

import dataclasses
import datetime
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from ferreus_rbf_tpu_torch import parallel

WORLD = 4
GATE = "FERREUS_RBF_TPU_NODETILE_BYTES"
FUSED = "FERREUS_RBF_TPU_FUSED"
# a rank that waits this long on a collective fails the group
TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs several workers on
    the CPU's cores, and a torch thread pool per worker oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------- data
def _ddm_points():
    return np.random.default_rng(7).random((1100, 3))


def _tps_settings(prt):
    return prt.InterpolantSettings(
        kernel_type=prt.RBFKernelType.ThinPlateSpline,
        fitting_accuracy=prt.FittingAccuracy(1e-5, prt.FittingAccuracyType.Relative))


def _ddm_params(prt):
    return prt.DDMParams(leaf_threshold=128, overlap_quota=0.5, coarse_ratio=0.5,
                         coarse_threshold=300)


def _clustered():
    """A dense flat cluster in a sparse background: the adaptive tree has
    w-lists (M2P) and x-lists (P2L), and 189 leaves, 201 M2L slots and 189
    target rows, none of which divides by 4."""
    rng = np.random.default_rng(37)
    return np.concatenate([rng.random((2400, 3)) * [0.12, 0.12, 0.02], rng.random((600, 3))])


FMM = dict(interpolation_order=4, max_points_per_cell=64, epsilon=1e-4)
# the port's trees take the M2L in chunks of a few target slots (its blocks
# are cut at its chunks' bounds), so that every rank owns some of it
M2L_CHUNK = 8


def _fmm_weights(n):
    return np.random.default_rng(5).standard_normal((n, 2))


def _fit_data():
    pts = np.random.default_rng(9).random((1000, 3))
    return pts, np.sin(3 * pts[:, 0]) * np.cos(2 * pts[:, 1]) + pts[:, 2] ** 2


def _fit_params(prt):
    return prt.Params(
        ddm_params=_ddm_params(prt),
        fmm_params=prt.FmmParams(interpolation_order=4, max_points_per_cell=96,
                                 compression_type=prt.FmmCompressionType.ACA, epsilon=1e-5),
        naive_solve_threshold=0, test_unique=False, mixed_precision=False,
        precond_factor_dtype="f64")


# ----------------------------------------------------------------- ranks
def _port_tree(pts, gated):
    from ferreus_rbf_tpu_torch.config import FmmCompressionType, FmmParams
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree
    from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType

    if gated:
        os.environ[GATE] = "0"
    try:
        tree = FmmTree(pts, FMM["interpolation_order"],
                       KernelParams(KernelType.Spheroidal5Rbf, base_range=1.1, total_sill=0.8),
                       adaptive_tree=True, sparse=True,
                       params=FmmParams(compression_type=FmmCompressionType.ACA,
                                        eval_chunk_size=M2L_CHUNK, **FMM),
                       device=None if parallel.active_mesh() else "cpu")
    finally:
        os.environ.pop(GATE, None)
    tree.prepare_targets(pts, "src")
    return tree


def _matvecs(tree, out, tag):
    w = torch.as_tensor(_fmm_weights(tree.source_points.shape[0]))
    for prec in ("f32", "f64"):
        out[f"{tag}_{prec}"] = tree.evaluate_device(w, "src", prec).numpy()


def _fit(prt, fused, mesh=None):
    pts, vals = _fit_data()
    if not fused:
        os.environ[FUSED] = "0"
    try:
        rbfi = prt.RBFInterpolator(pts, vals, _tps_settings(prt), _fit_params(prt),
                                   device=None if mesh else "cpu")
    finally:
        os.environ.pop(FUSED, None)
    return rbfi


def _run_rank(rank, init_file, out_dir):
    """One rank of the group: the one-rank references this rank owns (no
    mesh), then every sharded check under the mesh; writes
    ``rank<r>.npz``."""
    torch.set_num_threads(1)
    import ferreus_rbf_tpu_torch as prt
    from ferreus_rbf_tpu_torch.ops.fmm import api as fmm_api
    from ferreus_rbf_tpu_torch.solver import ddm as ddm_mod
    from ferreus_rbf_tpu_torch.solver import fused as fused_mod
    from ferreus_rbf_tpu_torch.solver.ddm import DDMTree
    from ferreus_rbf_tpu_torch.utils import timing

    # these levels hold a few dozen domains and the tree a few hundred
    # leaves, slots and rows, which the package keeps as one block per pass;
    # cut them into blocks all the same, so that every rank owns some
    ddm_mod._MIN_BLOCK_DOMAINS = 1
    fmm_api._MIN_BLOCK_LEAVES = fmm_api._MIN_BLOCK_ROWS = 1
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

    # one-rank references, spread over the ranks
    if rank == 0:
        ddm_solves(DDMTree(_ddm_points(), settings, _ddm_params(prt),
                           factor_dtype=torch.float64, device="cpu"), "ref_ddm")
        _matvecs(_port_tree(pts, gated=False), out, "ref_mv")
        _matvecs(_port_tree(pts, gated=True), out, "ref_gated")
    elif rank in (1, 2):
        fit = _fit(prt, fused=rank == 1)
        c = fit.coefficients
        out["ref_fit"] = np.concatenate([c.point_coefficients, c.poly_coefficients])

    mesh = parallel.make_mesh(WORLD, device_type="cpu")
    out["coords"] = np.asarray(mesh.coords)
    with parallel.use_mesh(mesh):
        tree = DDMTree(_ddm_points(), settings, _ddm_params(prt), factor_dtype=torch.float64,
                       device="cpu")
        ddm_solves(tree, "ddm")
        out["ddm_domains"] = np.asarray([tree.domains_rank, tree.domains])
        out["ddm_factor_bytes"] = np.asarray([tree.factor_bytes_rank, tree.factor_bytes])
    # the JAX test's mesh shape: "sp" x "rhs" = 2 x 2, only "sp" shards
    mesh2 = parallel.make_mesh(WORLD, ("sp", "rhs"), device_type="cpu")
    out["mesh2"] = np.asarray([parallel.shard_axis_size(mesh2, "sp"),
                               parallel.shard_axis_size(mesh2, "rhs"), *mesh2.coords])
    with parallel.use_mesh(mesh2):
        tree = DDMTree(_ddm_points(), settings, _ddm_params(prt), factor_dtype=torch.float64,
                       device="cpu")
        ddm_solves(tree, "ddm2")
        out["ddm2_domains"] = np.asarray([tree.domains_rank, tree.domains])
    with parallel.use_mesh(mesh):
        for tag, gated in (("mv", False), ("gated", True)):
            tree = _port_tree(pts, gated)
            out[f"{tag}_is_gated"] = np.asarray(tree._m2p_tiles_gated)
            out[f"{tag}_m2p_p2l"] = np.asarray([tree._target_cache["src"]["wtab"] is not None,
                                                tree._dev["p2l_cells"].numel()])
            _matvecs(tree, out, tag)
            out[f"{tag}_shares"] = np.asarray(list(tree.shares("src").values()))
        for tag, fused in (("fused", True), ("host", False)):
            tracer = timing.enable_global_tracer()
            built = []
            init = fused_mod.FusedSystem.__init__

            def keep(self, system, _init=init):
                _init(self, system)
                built.append(self)

            fused_mod.FusedSystem.__init__ = keep
            try:
                fit = _fit(prt, fused, mesh)
            finally:
                fused_mod.FusedSystem.__init__ = init
                timing.disable_global_tracer()
            c = fit.coefficients
            out[f"fit_{tag}"] = np.concatenate([c.point_coefficients, c.poly_coefficients])
            resid = fit.evaluate_at_source() - _fit_data()[1]
            out[f"fit_{tag}_resid"] = np.linalg.norm(resid) / np.linalg.norm(_fit_data()[1])
            out[f"fit_{tag}_events"] = np.asarray(len(tracer.events))
            if built:
                out[f"fit_{tag}_graph_gate"] = np.asarray(str(built[0].stats["graph_gate"]))
                out[f"fit_{tag}_ok"] = np.asarray(built[0].ok)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the group of four ranks once; meanwhile, the JAX package's
    unsharded gated matvec in this process. Returns ([rank results], jax
    reference)."""
    d = tmp_path_factory.mktemp("ranks")
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
    results = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return results, jax_ref


def _jax_gated_matvec():
    import jax.numpy as jnp

    from ferreus_rbf_tpu.config import FmmCompressionType, FmmParams
    from ferreus_rbf_tpu.ops.fmm.api import FmmTree
    from ferreus_rbf_tpu.ops.kernels import KernelParams, KernelType

    pts = _clustered()
    mp = pytest.MonkeyPatch()
    mp.setenv(GATE, "0")
    try:
        tree = FmmTree(pts, FMM["interpolation_order"],
                       KernelParams(KernelType.Spheroidal5Rbf, base_range=1.1, total_sill=0.8),
                       adaptive_tree=True, sparse=True,
                       params=FmmParams(compression_type=FmmCompressionType.ACA, **FMM))
    finally:
        mp.undo()
    assert tree._m2p_tiles_gated
    tree.prepare_targets(pts, "src")
    w = jnp.asarray(_fmm_weights(pts.shape[0]))
    return {prec: np.asarray(tree.evaluate_device(w, "src", prec)) for prec in ("f32", "f64")}


def _same_on_every_rank(results, key, ref_rank):
    ref = results[ref_rank]
    want = ref[f"ref_{key}"] if f"ref_{key}" in ref else ref[key]
    return [np.array_equal(r[key], want) for r in results]


# ----------------------------------------------------------------- checks
@pytest.mark.parametrize("tag", ["ddm", "ddm2"])
def test_ddm_bucket_solves_match_one_rank(ranks, tag):
    """On the one-axis mesh and on the JAX test's 2 x 2 ("sp", "rhs") mesh,
    where ranks that differ only in "rhs" own the same domains."""
    results, _ = ranks
    levels = sorted(k[len("ddm_"):] for k in results[0] if k.startswith("ddm_lvl"))
    assert levels
    for lvl in levels:
        assert _same_on_every_rank(results, f"{tag}_{lvl}", 0) == [True] * WORLD, lvl
    if tag == "ddm2":
        assert [tuple(r["mesh2"]) for r in results] == [(2, 2, 0, 0), (2, 2, 0, 1),
                                                        (2, 2, 1, 0), (2, 2, 1, 1)]
        owned = [int(r["ddm2_domains"][0]) for r in results]
        assert owned[0] == owned[1] > 0 and owned[2] == owned[3] > 0
        assert owned[0] + owned[2] == int(results[0]["ddm2_domains"][1])
        return
    owned = [int(r["ddm_domains"][0]) for r in results]
    assert all(n > 0 for n in owned) and sum(owned) == int(results[0]["ddm_domains"][1])
    # the factors split across the ranks: together they are one rank's
    fb = [int(r["ddm_factor_bytes"][0]) for r in results]
    assert all(0 < b < int(results[0]["ddm_factor_bytes"][1]) for b in fb)
    assert sum(fb) == int(results[0]["ddm_factor_bytes"][1])


@pytest.mark.parametrize("tag", ["mv", "gated"])
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_sharded_matvec_matches_one_rank(ranks, tag, prec):
    results, _ = ranks
    assert bool(results[0][f"{tag}_is_gated"]) == (tag == "gated")
    assert _same_on_every_rank(results, f"{tag}_{prec}", 0) == [True] * WORLD
    assert np.isfinite(results[0][f"{tag}_{prec}"]).all()


@pytest.mark.parametrize("tag", ["mv", "gated"])
def test_matvec_shares_are_uneven_and_cover_every_item(ranks, tag):
    """The tree has M2P and P2L, its leaves, M2L slots and rows do not
    divide by 4, and every rank owns some of each (P2M leaves, M2L slots,
    L2P rows, near-field rows)."""
    results, _ = ranks
    has_m2p, n_p2l = results[0][f"{tag}_m2p_p2l"]
    assert has_m2p and n_p2l > 0
    shares = np.stack([r[f"{tag}_shares"] for r in results])  # (rank, item, (owned, total))
    totals = shares[0, :, 1]
    assert all(t % WORLD for t in totals), totals
    assert (shares[:, :, 0] > 0).all()
    assert (shares[:, :, 0].sum(0) == totals).all()


@pytest.mark.parametrize("prec,tol", [("f32", 1e-5), ("f64", 1e-12)])
def test_sharded_gated_matvec_matches_jax_unsharded(ranks, prec, tol):
    """The gated tree's M2P survives the row-sharded leaf pass: the JAX
    package's unsharded gated matvec (which its own sharded leaf pass
    would drop, ROADMAP C1) agrees."""
    results, jax_ref = ranks
    got, want = results[0][f"gated_{prec}"], jax_ref[prec]
    assert float(np.max(np.abs(got - want)) / np.max(np.abs(want))) < tol


@pytest.mark.parametrize("path", ["fused", "host"])
def test_sharded_fit_matches_one_rank(ranks, path):
    results, _ = ranks
    ref_rank = 1 if path == "fused" else 2
    got = [r[f"fit_{path}"] for r in results]
    want = results[ref_rank]["ref_fit"]
    assert [np.array_equal(g, want) for g in got] == [True] * WORLD
    assert all(float(r[f"fit_{path}_resid"]) < 1e-4 for r in results)
    if path == "fused":
        # on the CPU nothing is captured: the gloo gate is for the card
        assert all(bool(r["fit_fused_ok"]) for r in results)
        assert str(results[0]["fit_fused_graph_gate"]) == "None"


def test_events_come_from_rank0_only(ranks):
    results, _ = ranks
    counts = [int(r["fit_fused_events"]) for r in results]
    assert counts[0] > 0 and counts[1:] == [0] * (WORLD - 1)


# ------------------------------------------------------ mesh, in-process
def test_a_small_level_is_one_block():
    """Below twice ``_MIN_BLOCK_DOMAINS`` domains a level is one block: each
    bucket is solved in one piece, by one rank."""
    import ferreus_rbf_tpu_torch as prt
    from ferreus_rbf_tpu_torch.solver import ddm as ddm_mod

    settings = _tps_settings(prt)
    settings.set_basis_size(3)
    tree = ddm_mod.DDMTree(_ddm_points(), settings, _ddm_params(prt),
                           factor_dtype=torch.float64, device="cpu")
    assert 1 < tree.domains < 2 * ddm_mod._MIN_BLOCK_DOMAINS
    buckets = [b for level in tree.levels[:-1] for b in level.buckets]
    assert buckets and all(b["pieces"] == [(0, b["pts_idx"].shape[0])] for b in buckets)
    mesh = parallel.Mesh(None, 0, 4, torch.device("cpu"), "gloo", ("sp",), (4,), (0,))
    for rank, owned in ((0, []), (3, [(0, 0, tree.domains)])):
        mesh = dataclasses.replace(mesh, rank=rank, coords=(rank,))
        assert parallel.pieces([tree.domains], mesh, blocks=1) == owned


def test_make_mesh_refuses_what_it_cannot_run(monkeypatch):
    assert parallel.active_mesh() is None
    assert parallel.shard_axis_size(None, "sp") == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        parallel.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL needs one card per rank"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="NCCL needs one card per rank"):
        parallel.make_mesh(backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        parallel.make_mesh(device_type="cpu", backend="nccl")
    assert not dist.is_initialized()


@pytest.mark.parametrize("axis_names, world", [
    (("sp",), parallel.BLOCKS + 1),
    (("sp",), 2 * parallel.BLOCKS),  # four eight-card hosts
    (("rhs", "sp"), 2 * (parallel.BLOCKS + 1)),  # "sp" takes BLOCKS + 1 of them
])
def test_make_mesh_refuses_an_sp_axis_past_the_blocks(monkeypatch, axis_names, world):
    # no pass is cut into more than BLOCKS blocks: a further rank would own
    # no leaf, slot, row or domain (eight ranks pass:
    # tests/test_torch_sharding_eight.py)
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match=f"exceeds {parallel.BLOCKS} ranks"):
        parallel.make_mesh(axis_names=axis_names, device_type="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("backend, device, shape, capturable", [
    ("nccl", "cuda", (4,), True),
    ("gloo", "cuda", (2,), False),
    ("gloo", "cuda", (1,), True),  # one "sp" rank: no all-reduce to capture
    ("gloo", "cpu", (4,), True),  # nothing is captured on the CPU
])
def test_mesh_capturable(backend, device, shape, capturable):
    mesh = parallel.Mesh(None, 0, shape[0], torch.device(device), backend, ("sp",), shape,
                         (0,))
    assert mesh.capturable is capturable


def test_one_rank_mesh_is_the_unsharded_path(monkeypatch):
    from ferreus_rbf_tpu_torch.ops.fmm.api import resolve_device

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, val in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                     ("RANK", "0"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(key, val)
    pts = _clustered()
    want = {}
    _matvecs(_port_tree(pts, gated=False), want, "mv")
    mesh = parallel.make_mesh(device_type="cpu")
    try:
        assert (mesh.size, mesh.rank, mesh.backend, mesh.device) == (1, 0, "gloo",
                                                                    torch.device("cpu"))
        got = {}
        with parallel.use_mesh(mesh):
            assert parallel.active_mesh() is mesh and not parallel.sharded(mesh)
            assert resolve_device(None) == torch.device("cpu")
            with pytest.raises(ValueError, match="mesh device"):
                resolve_device("meta")
            _matvecs(_port_tree(pts, gated=False), got, "mv")
        assert parallel.active_mesh() is None
    finally:
        dist.destroy_process_group()
    assert all(np.array_equal(got[k], want[k]) for k in want)
