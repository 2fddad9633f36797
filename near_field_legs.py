#!/usr/bin/env python3
"""Time H1/H2 (``near_field_f32``/``_f64``) on the legs chip_smoke.py reports.

    python3 near_field_legs.py                  # the package beside this script
    cd <other tree> && python3 <this script>    # the package of the working directory

On one CUDA card, for the ``ferreus_rbf_tpu_torch`` package found in the
working directory, it builds the trees ``chip_smoke.py`` builds and times,
with CUDA events (mean of 10 launches after one), ``near_field`` on their
own near-field operands with random weights (``chip_smoke.py``'s
``tree_legs``):

* the albatite dataset's "__all__" set (phase 4): P2P, M2P and P2L, 1 RHS,
  f32 (H1) and f64 (H2);
* config 2 (phase 3): P2P, 8 RHS, f32 and f64;
* config 4 at 1,000,000 points (phase 7's points, without the fit): P2P
  and M2P, 1 RHS, f32, at "__all__" and at a random eighth of the points,
  a target set as sparse in its rows as the DDM's level sets.

The live counts (target slots per row, source slots per tile) are passed
where ``near_field`` takes them. Where the
package cuts rows into work items (``near_field._ITEM_SOURCES``), every leg
is timed at each of ``BUDGETS`` (the work lists carry the budget in their
key, so each is rebuilt), with its items and partial blocks, and the
fastest budget is named. Run it on two trees in one call to compare them
on one card.
"""

import inspect
import os
import subprocess
import sys
import time

import numpy as np
import torch

# imported before the working directory goes first on sys.path: this
# script's chip_smoke.py, whichever tree's package it times
from chip_smoke import cuda_ms, synthetic_sd, tree_legs

HERE = os.path.dirname(os.path.abspath(__file__))
BUDGETS = [128, 256, 512, 1024, 2048, 8192, 1 << 30]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("near_field_legs.py needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree
    from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(f"package {os.path.dirname(os.path.abspath(frt.__file__))}", flush=True)
    t0 = time.perf_counter()
    nf.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    takes_counts = "tcnt" in inspect.signature(nf.near_field).parameters
    budgets = BUDGETS if hasattr(nf, "_ITEM_SOURCES") else [None]
    g = torch.Generator(device="cpu").manual_seed(2)
    cases = []  # (label, kparams, operands, counts)

    pts, _ = frt.csv_to_point_arrays(os.path.join(HERE, "datasets", "albatite_SD_points.csv"),
                                     has_headers=True)
    span = float(np.max(pts.max(axis=0) - pts.min(axis=0)))
    kp = KernelParams(KernelType.Spheroidal5Rbf, base_range=span / 4, total_sill=span / 4)
    fp = frt.FmmParams.new_defaults(frt.RBFKernelType.Spheroidal)
    tree = FmmTree(pts, fp.interpolation_order, kp, adaptive_tree=True, sparse=True, params=fp,
                   device=dev)
    tree.prepare_targets(pts, "__all__")
    for dtype in (torch.float32, torch.float64):
        cases += [(f"albatite {leg} {dtype}", kp, *leg_ops)
                  for leg, leg_ops in tree_legs(tree, "__all__", dtype, 1, g).items()]

    rng = np.random.default_rng(42)
    pts = rng.random((100_000, 3))
    kp = KernelParams(KernelType.LinearRbf)
    fp = frt.FmmParams(interpolation_order=5, max_points_per_cell=256,
                       compression_type=frt.FmmCompressionType.ACA, epsilon=1e-5)
    tree = FmmTree(pts, 5, kp, adaptive_tree=False, sparse=True, params=fp, device=dev)
    tree.prepare_targets(pts, "src")
    for dtype in (torch.float32, torch.float64):
        cases.append((f"config-2 p2p {dtype}", kp, *tree_legs(tree, "src", dtype, 8, g)["p2p"]))

    pts, _ = synthetic_sd(1_000_000)
    fp = frt.FmmParams.new_defaults(frt.RBFKernelType.Linear)
    tree = FmmTree(pts, fp.interpolation_order, kp, adaptive_tree=True, sparse=True, params=fp,
                   device=dev)
    tree.prepare_targets(pts, "__all__")
    tree.prepare_targets(pts[np.random.default_rng(8).random(pts.shape[0]) < 0.125], "eighth")
    for key in ("__all__", "eighth"):
        cases += [(f"1M {key} {leg} torch.float32", kp, *leg_ops)
                  for leg, leg_ops in tree_legs(tree, key, torch.float32, 1, g, False).items()]

    for label, kparams, ops, counts in cases:
        counts = counts if takes_counts else {}
        tgt, src, _, nbr, cnt = ops
        best = None
        for budget in budgets:
            line = f"{label} rows {tgt.shape[0]}:"
            if budget is not None:
                nf._ITEM_SOURCES = budget
                nf.near_field(*ops, kparams=kparams, **counts)  # builds the work list
                wl = nf._work_items_on(nbr, cnt, counts.get("tcnt"), counts.get("scnt"),
                                       tgt.shape[1], src.shape[2], src.shape[0])
                line += (f" budget {budget}: items {wl.items.shape[0]}, partial blocks "
                         f"{wl.nparts},")
            out = nf.near_field(*ops, kparams=kparams, **counts)
            if not torch.isfinite(out).all():
                raise AssertionError(f"{label}: not finite")
            ms = cuda_ms(lambda: nf.near_field(*ops, kparams=kparams, **counts))
            print(f"{line} kernel {ms:.4f} ms", flush=True)
            if best is None or ms < best[1]:
                best = (budget, ms)
        if budget is not None:
            print(f"{label}: fastest budget {best[0]} ({best[1]:.4f} ms)", flush=True)


if __name__ == "__main__":
    main()
