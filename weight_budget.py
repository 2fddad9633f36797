#!/usr/bin/env python3
"""Time the port's fits with the P2M/L2P weight tables resident and made per chunk.

    python3 weight_budget.py

``ferreus_rbf_tpu_torch.ops.fmm.api._WEIGHT_TABLE_BYTES`` decides whether a
tree's P2M table and each target set's L2P table are kept on the card or
computed per chunk inside every pass. This script, on one CUDA card:

1. fits the albatite dataset (``chip_smoke.py``'s phase 4 settings) with
   the constant at infinity (every table resident) and at 0 (every table
   per chunk), alternating, three fits each after one warm-up fit;
2. fits config 4 (1,000,000 points, ``chip_smoke.py``'s phase 7) the same
   two ways, in the order per chunk, resident, resident, per chunk;
3. builds config 4's tree and its source target set at 125k to 2M points
   and prints the P2M and L2P tables' bytes, so that the N at which each
   crosses the committed constant can be read off.

Each fit prints its seconds, its stage timers, the solver's residual,
peak device memory and which tables stayed resident. A fit that runs out
of device memory is reported as such.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def fit(frt, api, timing, dev, pts, vals, settings, budget, label):
    api._WEIGHT_TABLE_BYTES = budget
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tracer = timing.enable_global_tracer()
    t0 = time.perf_counter()
    try:
        rbfi = frt.RBFInterpolator(pts, vals, settings, device=dev)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as exc:
        timing.disable_global_tracer()
        print(f"{label}: budget {budget:.3g}: out of device memory after "
              f"{time.perf_counter() - t0:.3f} s ({str(exc).splitlines()[0]})", flush=True)
        return None
    fit_s = time.perf_counter() - t0
    timing.disable_global_tracer()
    events = tracer.events
    done = [e for e in events if e["event"] == "solve_done"][-1]
    strip = lambda e: {k: v for k, v in e.items() if k != "event"}  # noqa: E731
    row = {"label": label, "budget": budget, "fit_s": fit_s,
           "residual": done["residual"],
           "rounds": sum(e["event"] == "refine_round" for e in events),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "stages": {k: round(v, 3) for k, v in tracer.totals.items()},
           "trees": [strip(e) for e in events if e["event"] == "fmm_tree"],
           "targets": [strip(e) for e in events if e["event"] == "fmm_targets"]}
    print(json.dumps(row), flush=True)
    del rbfi
    return row


def summary(rows, label):
    rows = [r for r in rows if r is not None]
    for budget in sorted({r["budget"] for r in rows}):
        sel = [r for r in rows if r["budget"] == budget]
        fits = [r["fit_s"] for r in sel]
        solve = [r["stages"].get("solve_column", 0.0) for r in sel]
        print(f"{label}: budget {budget:.3g}: fit s {fits} (median {np.median(fits):.3f}), "
              f"solve_column s {solve}, peak GB {max(r['peak_gb'] for r in sel):.3f}",
              flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("weight_budget.py needs a CUDA card (torch.cuda.is_available() is false)")
    sys.path.insert(0, HERE)
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.ops.fmm import api
    from ferreus_rbf_tpu_torch.scripts.fit_at_scale import synthetic_sd
    from ferreus_rbf_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    committed = api._WEIGHT_TABLE_BYTES
    print(f"{card}; torch {torch.__version__}; committed _WEIGHT_TABLE_BYTES {committed:.3g}",
          flush=True)

    pts, vals = frt.csv_to_point_arrays(
        os.path.join(HERE, "datasets", "albatite_SD_points.csv"), has_headers=True)
    vals = vals.reshape(-1)
    span = float(np.max(pts.max(axis=0) - pts.min(axis=0)))
    settings = frt.InterpolantSettings(
        kernel_type=frt.RBFKernelType.Spheroidal, spheroidal_order=frt.SpheroidalOrder.Five,
        base_range=span / 4.0, total_sill=span / 4.0)
    resident, chunked = float("inf"), 0.0
    fit(frt, api, timing, dev, pts, vals, settings, resident, "albatite warm-up")
    rows = [fit(frt, api, timing, dev, pts, vals, settings, b, "albatite")
            for b in (resident, chunked) * 3]
    summary(rows, "albatite")

    pts4, sd4 = synthetic_sd(1_000_000, seed=11)
    linear = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    rows = [fit(frt, api, timing, dev, pts4, sd4, linear, b, "config 4")
            for b in (chunked, resident, resident, chunked)]
    summary(rows, "config 4")

    api._WEIGHT_TABLE_BYTES = committed
    fp = frt.Params.new_defaults(linear.kernel_type).fmm_params
    kp = linear.kernel_params()
    for n in (125_000, 250_000, 500_000, 1_000_000, 2_000_000):
        p, _ = synthetic_sd(n, seed=11)
        tree = api.FmmTree(p, fp.interpolation_order, kp, adaptive_tree=True, sparse=True,
                           params=fp, device=dev)
        tree.prepare_targets(p, "src")
        rows_src = tree._target_cache["src"]["nbr"].shape[1]
        l2p = rows_src * tree._tmax * tree.nnodes * 8
        print(f"config-4 tree at N {n}: leaves {tree.nsl}, smax {tree.smax}, P2M table "
              f"{tree.p2m_bytes / 1e9:.3f} GB, source-set L2P table {l2p / 1e9:.3f} GB "
              f"({rows_src} rows); resident under {committed:.3g}: P2M "
              f"{tree.p2m_bytes <= committed}, L2P {l2p <= committed}", flush=True)
        del tree
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
