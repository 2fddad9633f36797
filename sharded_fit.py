#!/usr/bin/env python3
"""The sharded path across several CUDA cards, one NCCL rank per card.

    python3 sharded_fit.py

Needs two or more cards; it uses min(4, cards) ranks.

1. Config 4, the 1M fit (``chip_smoke.py`` phase 7's data and settings):
   once on one card in this process, then under a mesh of the ranks. Each
   rank prints its fit seconds, its stages, its Schwarz domains and factor
   bytes, its launches and its card's peak device memory; rank 0 the
   solver's residual and path. The ranks' coefficients are held bit for
   bit against the one-card fit, and rank 0 evaluates the fit at the
   sources against the values (``evaluate_at_source``, replicated, outside
   the mesh).
2. ``chip_smoke.py``'s phase 10 with a rank on each card: config 2's
   matvec, the albatite fit (fused, its cycles captured with their NCCL
   all-reduces, and host loop) and the gated albatite tree under
   ``parallel.use_mesh``, bit for bit one rank (the one-rank albatite fits
   are made first, in this process, on ``cuda:0``).
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


def fit_rank(rank, world, refs_path):
    """One rank of the 1M fit under the mesh; writes ``rank<r>.json``."""
    import torch.distributed as dist

    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch import parallel
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
    from ferreus_rbf_tpu_torch.solver import ddm as ddm_mod
    from ferreus_rbf_tpu_torch.utils import timing

    dist.init_process_group("nccl", init_method=f"file://{OUT}/init", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    mesh = parallel.make_mesh(world)
    dev = mesh.device
    pts, sd = smoke.synthetic_sd(N, seed=11)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    kept = []
    init = ddm_mod.DDMTree.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        kept.append(self)

    tracer = timing.enable_global_tracer()
    ddm_mod.DDMTree.__init__ = keep
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    nf.reset_launches()
    t0 = time.perf_counter()
    try:
        with parallel.use_mesh(mesh):
            rbfi = frt.RBFInterpolator(pts, sd, settings)
        torch.cuda.synchronize(dev)
    finally:
        ddm_mod.DDMTree.__init__ = init
        timing.disable_global_tracer()
    fit_s = time.perf_counter() - t0
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


def main():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        raise SystemExit(f"sharded_fit.py needs two or more CUDA cards, found {cards}")
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
    from ferreus_rbf_tpu_torch.utils import timing

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.init()  # the allocator's peak counters exist after this
    nf.build()
    world = min(4, cards)
    t_start = time.perf_counter()

    # 1. config 4 on one card, then under the mesh
    pts, sd = smoke.synthetic_sd(N, seed=11)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    tracer = timing.enable_global_tracer()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rbfi = frt.RBFInterpolator(pts, sd, settings, device=dev)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    one = {"fit_s": round(one_s, 3),
           "stages_s": {k: round(v, 3) for k, v in tracer.totals.items()},
           "peak_gb": round(torch.cuda.max_memory_allocated(dev) / 1e9, 3),
           "residual": [e for e in tracer.events if e["event"] == "solve_done"][-1]["residual"]}
    smoke.log(f"config 4 on one card: {json.dumps(one)}")
    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(OUT):
        os.remove(os.path.join(OUT, name))
    refs_path = os.path.join(OUT, "refs.npz")
    np.savez(refs_path, **{part: smoke.coefficient_array(rbfi.coefficients, part)
                           for part in ("point", "poly")})
    del rbfi
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    smoke.run_ranks(fit_rank, world, (refs_path,), 1200)
    recs = []
    for r in range(world):
        with open(os.path.join(OUT, f"rank{r}.json")) as fh:
            recs.append(json.load(fh))
        smoke.log(f"config 4 under a {world}-rank NCCL mesh, rank {r}: {json.dumps(recs[-1])}")
    lead = recs[0]
    failed = []  # raised after part 2, which runs all the same
    if not all(all(rec["one_card"]) for rec in recs):
        failed.append("the sharded 1M fit is not bit for bit the one-card fit")
    if not (lead["solve_done"]["residual"] <= 1e-6 and lead["source_residual"] < smoke.CONFIG4_BOUND):
        failed.append(f"the sharded 1M fit: {lead['solve_done']}, source residual "
                      f"{lead['source_residual']:.3e}")

    # 2. phase 10 across the cards, against one-card albatite fits
    pts, vals, _, settings = smoke.albatite_data(frt)
    refs = {}
    for path in ("fused", "host"):
        if path == "host":
            os.environ[smoke.FUSED_ENV] = "0"
        try:
            refs[path] = frt.RBFInterpolator(pts, vals, settings, device=dev).coefficients
        finally:
            os.environ.pop(smoke.FUSED_ENV, None)
    smoke.phase_sharded(dev, refs)
    smoke.log(f"sharded_fit.py: {time.perf_counter() - t_start:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))


if __name__ == "__main__":
    main()
