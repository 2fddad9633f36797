#!/usr/bin/env python3
"""The sharded path across several CUDA cards, one NCCL rank per card.

    python3 sharded_fit.py

Needs two or more cards; it uses min(8, cards) ranks. The ranks share the
host's cores (``chip_smoke.run_ranks``), and a host plan's BLAS rounds by
its thread count, so every one-card reference is made inside a rank of
the same group, never in this process.

1. Config 4, the 1M fit (``chip_smoke.py`` phase 7's data and settings):
   once on one card by rank 0 (without a mesh; its seconds, stages, peak
   memory and residual are printed), then under a mesh of the ranks. Each
   rank prints its fit seconds, its stages, its Schwarz domains and factor
   bytes, its launches and its card's peak device memory; rank 0 the
   solver's residual and path. The ranks' coefficients are held bit for
   bit against the one-card fit, and rank 0 evaluates the fit at the
   sources against the values (``evaluate_at_source``, replicated, outside
   the mesh).
2. ``chip_smoke.py``'s phase 10 with a rank on each card: config 2's
   matvec, the albatite fit (fused, its cycles captured with their NCCL
   all-reduces, and host loop) and the gated albatite tree under
   ``parallel.use_mesh``, bit for bit one rank.
3. The scaling line, the counterpart of the JAX package's
   ``_scaling_curve``: config 2's sharded f32 matvec (``chip_smoke.py``
   phase 3's tree, 8 RHS) on meshes of 1, 2, 4 and 8 ranks, as many as the
   cards allow, bit for bit a one-rank tree's in every rank; per mesh, each
   rank's share of leaves, M2L slots, L2P rows and near-field rows, its
   share of the Schwarz domains of a ``DDMTree`` over the same points
   (LinearRbf, default ``DDMParams``, f32 factors) and its median
   milliseconds of 11 calls, and the slowest rank's median.
"""

import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import chip_smoke as smoke  # noqa: E402

N = 1_000_000
OUT = os.path.join(HERE, "build", "sharded_fit")


def timed_fit(frt, timing, pts, sd, settings, dev, mesh=None):
    """The 1M fit under the stage tracer, on ``mesh`` when given: (fit,
    seconds, tracer)."""
    from ferreus_rbf_tpu_torch import parallel

    tracer = timing.enable_global_tracer()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        if mesh is None:
            rbfi = frt.RBFInterpolator(pts, sd, settings, device=dev)
        else:
            with parallel.use_mesh(mesh):
                rbfi = frt.RBFInterpolator(pts, sd, settings)
        torch.cuda.synchronize(dev)
    finally:
        timing.disable_global_tracer()
    return rbfi, time.perf_counter() - t0, tracer


def fit_rank(rank, world):
    """One rank of the 1M fit: rank 0 fits on one card first, then every
    rank under the mesh; writes ``rank<r>.json`` (rank 0 also
    ``one_card.json``)."""
    import torch.distributed as dist

    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch import parallel
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
    from ferreus_rbf_tpu_torch.scripts.fit_at_scale import synthetic_sd
    from ferreus_rbf_tpu_torch.solver import ddm as ddm_mod
    from ferreus_rbf_tpu_torch.utils import timing

    dist.init_process_group("nccl", init_method=f"file://{OUT}/init", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    mesh = parallel.make_mesh(world)
    dev = mesh.device
    pts, sd = synthetic_sd(N, seed=11)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    refs_path = os.path.join(OUT, "refs.npz")
    if rank == 0:
        rbfi, fit_s, tracer = timed_fit(frt, timing, pts, sd, settings, dev)
        one = {"fit_s": round(fit_s, 3),
               "stages_s": {k: round(v, 3) for k, v in tracer.totals.items()},
               "peak_gb": round(torch.cuda.max_memory_allocated(dev) / 1e9, 3),
               "residual": [e for e in tracer.events
                            if e["event"] == "solve_done"][-1]["residual"]}
        with open(os.path.join(OUT, "one_card.json"), "w") as fh:
            json.dump(one, fh)
        np.savez(refs_path, **{part: smoke.coefficient_array(rbfi.coefficients, part)
                               for part in ("point", "poly")})
        del rbfi
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    dist.barrier(device_ids=[dev.index])

    kept = []
    init = ddm_mod.DDMTree.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        kept.append(self)

    ddm_mod.DDMTree.__init__ = keep
    nf.reset_launches()
    try:
        rbfi, fit_s, tracer = timed_fit(frt, timing, pts, sd, settings, dev, mesh)
    finally:
        ddm_mod.DDMTree.__init__ = init
    tree = kept.pop()
    refs = np.load(refs_path)
    c = rbfi.coefficients
    ev = {e["event"]: e for e in tracer.events}  # rank 0 only
    rec = {
        "rank": rank, "device": str(dev), "fit_s": round(fit_s, 3),
        "stages_s": {k: round(v, 3) for k, v in tracer.totals.items()},
        "domains": [tree.domains_rank, tree.domains],
        "factor_mb": [round(tree.factor_bytes_rank / 2**20, 3),
                      round(tree.factor_bytes / 2**20, 3)],
        "launches": {k: v for k, v in nf.LAUNCHES.items() if v},
        "peak_gb": round(torch.cuda.max_memory_allocated(dev) / 1e9, 3),
        "one_card": [bool(np.array_equal(smoke.coefficient_array(c, part), refs[part]))
                     for part in ("point", "poly")],
        "solve_done": ev.get("solve_done"), "fused_system": ev.get("fused_system"),
    }
    del tree
    if rank == 0:
        t0 = time.perf_counter()
        pred = rbfi.evaluate_at_source(add_nugget=True)
        rec["evaluate_at_source_s"] = round(time.perf_counter() - t0, 3)
        rec["source_residual"] = float(np.max(np.abs(pred - sd)) / np.max(np.abs(sd)))
    with open(os.path.join(OUT, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)
    dist.barrier(device_ids=[dev.index])
    dist.destroy_process_group()


def scale_rank(rank, world):
    """One rank of the scaling line on a mesh of ``world`` NCCL ranks;
    writes ``scale<world>_rank<r>.json``."""
    import torch.distributed as dist

    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch import parallel
    from ferreus_rbf_tpu_torch.solver.ddm import DDMTree

    dist.init_process_group("nccl", init_method=f"file://{OUT}/init_scale{world}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    mesh = parallel.make_mesh(world)
    dev = mesh.device
    pts, w, _ = smoke.config2_data(dev)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    settings.set_basis_size(pts.shape[1])
    want = smoke.config2_tree(frt, pts, dev).evaluate_device(w, "src", "f32")
    with parallel.use_mesh(mesh):
        tree = smoke.config2_tree(frt, pts, dev)
        ddm = DDMTree(pts, settings, frt.DDMParams(), factor_dtype=torch.float32, device=dev)
    got = tree.evaluate_device(w, "src", "f32")
    times = []
    for _ in range(11):
        torch.cuda.synchronize(dev)
        dist.barrier(device_ids=[dev.index])  # the ranks start each call together
        t0 = time.perf_counter()
        tree.evaluate_device(w, "src", "f32")
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    rec = {"rank": rank, "device": str(dev), "median_ms": sorted(times)[5] * 1e3,
           "one_rank": bool(torch.equal(got, want)),
           "shares": tree.shares("src", w.shape[1]),
           "domains": [ddm.domains_rank, ddm.domains]}
    with open(os.path.join(OUT, f"scale{world}_rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)
    dist.barrier(device_ids=[dev.index])
    dist.destroy_process_group()


def scaling_line(cards):
    """Part 3: config 2's sharded f32 matvec on 1, 2, 4 and 8 ranks (as
    many as ``cards``); returns what failed."""
    failed = []
    for world in (1, 2, 4, 8):
        if world > cards:
            smoke.log(f"scaling line, {world} ranks: not measured ({cards} cards)")
            continue
        smoke.run_ranks(scale_rank, world, (), 600)
        recs = []
        for r in range(world):
            with open(os.path.join(OUT, f"scale{world}_rank{r}.json")) as fh:
                recs.append(json.load(fh))
        smoke.log(f"scaling line, config-2 sharded f32 matvec on {world} NCCL rank(s): slowest "
                  f"rank's median {max(rec['median_ms'] for rec in recs):.4f} ms; per rank "
                  + json.dumps([{k: rec[k] for k in ("rank", "median_ms", "one_rank", "shares",
                                                      "domains")} for rec in recs]))
        if not all(rec["one_rank"] for rec in recs):
            failed.append(f"the {world}-rank config-2 matvec is not bit for bit one rank's")
    return failed


def main():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        raise SystemExit(f"sharded_fit.py needs two or more CUDA cards, found {cards}")
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    nf.build()
    world = min(8, cards)
    t_start = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(OUT):
        os.remove(os.path.join(OUT, name))

    # 1. config 4 on one card, then under the mesh
    smoke.run_ranks(fit_rank, world, (), 1800)
    with open(os.path.join(OUT, "one_card.json")) as fh:
        smoke.log(f"config 4 on one card (rank 0, no mesh): {fh.read()}")
    recs = []
    for r in range(world):
        with open(os.path.join(OUT, f"rank{r}.json")) as fh:
            recs.append(json.load(fh))
        smoke.log(f"config 4 under a {world}-rank NCCL mesh, rank {r}: {json.dumps(recs[-1])}")
    lead = recs[0]
    failed = []  # raised after parts 2 and 3, which run all the same
    if not all(all(rec["one_card"]) for rec in recs):
        failed.append("the sharded 1M fit is not bit for bit the one-card fit")
    if not (lead["solve_done"]["residual"] <= 1e-6 and lead["source_residual"] < smoke.CONFIG4_BOUND):
        failed.append(f"the sharded 1M fit: {lead['solve_done']}, source residual "
                      f"{lead['source_residual']:.3e}")

    # 2. phase 10 across the cards
    smoke.phase_sharded()

    # 3. the scaling line
    failed += scaling_line(cards)
    smoke.log(f"sharded_fit.py: {time.perf_counter() - t_start:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))


if __name__ == "__main__":
    main()
