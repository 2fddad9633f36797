#!/usr/bin/env python3
"""Time the near-field kernels H1-H4 on the legs chip_smoke.py reports.

    python3 near_field_legs.py [BUDGET ...]     # the package beside this script
    cd <other tree> && python3 <this script>    # the package of the working directory

On one CUDA card, for the ``ferreus_rbf_tpu_torch`` package found in the
working directory, it builds the trees ``chip_smoke.py`` builds and times,
with CUDA events (mean of 10 launches after one), each kernel on their own
near-field operands with random weights (``chip_smoke.py``'s
``tree_legs``):

* the albatite dataset's "__all__" set (phase 4): P2P, M2P and P2L, 1 RHS,
  f32 (H1) and f64 (H2); P2P and M2P with gradients (H3);
* config 2 (phase 3): P2P, 8 RHS, f32 and f64;
* config-2 gradients (phase 5: 100k uniform points, Spheroidal5, p = 5,
  adaptive tree): P2P with gradients, 2 RHS (H3);
* config 4 at 1,000,000 points (phase 7's points, without the fit): P2P
  and M2P, 1 RHS, f32, at "__all__" and at a random eighth of the points,
  a target set as sparse in its rows as the DDM's level sets;
* the same points on a tree with the node-tile gate forced
  (``FERREUS_RBF_TPU_NODETILE_BYTES=0``, phase 8): the gated M2P over
  virtual cell nodes with random multipole coefficients, 1 RHS, f32, f64
  and gradients (H4).

The live counts (target slots per row, source slots per tile) are passed
where a kernel's wrapper takes them. Where a kernel runs on work items
(its wrapper takes live counts and the package has
``near_field._ITEM_SOURCES``), its leg is timed at each of ``BUDGETS``
(the work lists carry the budget in their key, so each is rebuilt), with
its items and partial blocks, and the fastest budget is named; budgets
given as arguments replace ``BUDGETS``. Run it on two trees in one call
to compare them on one card.
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
BUDGETS = [64, 128, 256, 512, 1024, 2048, 1 << 30]
GATE_ENV = "FERREUS_RBF_TPU_NODETILE_BYTES"


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
    g = torch.Generator(device="cpu").manual_seed(2)
    cases = []  # (label, wrapper, kparams, operands, counts, table)

    def add_legs(prefix, fn, kparams, legs):
        for leg, (ops, counts) in legs.items():
            cases.append((f"{prefix} {leg}", fn, kparams, ops, counts, ops[3]))

    pts, _ = frt.csv_to_point_arrays(os.path.join(HERE, "datasets", "albatite_SD_points.csv"),
                                     has_headers=True)
    span = float(np.max(pts.max(axis=0) - pts.min(axis=0)))
    kp = KernelParams(KernelType.Spheroidal5Rbf, base_range=span / 4, total_sill=span / 4)
    fp = frt.FmmParams.new_defaults(frt.RBFKernelType.Spheroidal)
    tree = FmmTree(pts, fp.interpolation_order, kp, adaptive_tree=True, sparse=True, params=fp,
                   device=dev)
    tree.prepare_targets(pts, "__all__")
    for dtype in (torch.float32, torch.float64):
        add_legs(f"albatite {dtype}", "near_field", kp, tree_legs(tree, "__all__", dtype, 1, g))
    add_legs("albatite grad", "near_field_grad", kp,
             tree_legs(tree, "__all__", torch.float64, 1, g, False))

    rng = np.random.default_rng(42)
    pts = rng.random((100_000, 3))
    kp = KernelParams(KernelType.LinearRbf)
    fp = frt.FmmParams(interpolation_order=5, max_points_per_cell=256,
                       compression_type=frt.FmmCompressionType.ACA, epsilon=1e-5)
    tree = FmmTree(pts, 5, kp, adaptive_tree=False, sparse=True, params=fp, device=dev)
    tree.prepare_targets(pts, "src")
    for dtype in (torch.float32, torch.float64):
        add_legs(f"config-2 {dtype}", "near_field", kp,
                 {"p2p": tree_legs(tree, "src", dtype, 8, g)["p2p"]})

    pts = np.random.default_rng(7).random((100_000, 3))
    kp_g = KernelParams(KernelType.Spheroidal5Rbf, base_range=1.2, total_sill=0.9)
    tree = FmmTree(pts, 5, kp_g, adaptive_tree=True, sparse=True, device=dev)
    tree.prepare_targets(pts, "src")
    add_legs("config-2 grad, 2 RHS,", "near_field_grad", kp_g,
             {"p2p": tree_legs(tree, "src", torch.float64, 2, g, False)["p2p"]})

    pts, _ = synthetic_sd(1_000_000)
    kp = KernelParams(KernelType.LinearRbf)
    fp = frt.FmmParams.new_defaults(frt.RBFKernelType.Linear)
    tree = FmmTree(pts, fp.interpolation_order, kp, adaptive_tree=True, sparse=True, params=fp,
                   device=dev)
    tree.prepare_targets(pts, "__all__")
    tree.prepare_targets(pts[np.random.default_rng(8).random(pts.shape[0]) < 0.125], "eighth")
    for key in ("__all__", "eighth"):
        add_legs(f"1M {key} torch.float32", "near_field", kp,
                 tree_legs(tree, key, torch.float32, 1, g, False))
    del tree
    os.environ[GATE_ENV] = "0"
    try:
        gated = FmmTree(pts, fp.interpolation_order, kp, adaptive_tree=True, sparse=True,
                        params=fp, device=dev)
    finally:
        del os.environ[GATE_ENV]
    if not gated._m2p_tiles_gated:
        raise AssertionError("the gate did not fire at 0 bytes")
    gated.prepare_targets(pts, "src")
    binned = gated._target_cache["src"]
    mult = torch.randn((gated.tree.num_cells, gated.nnodes, 1), generator=g,
                       dtype=torch.float64).to(dev)
    for dtype, fn in ((torch.float32, "near_field_cells"), (torch.float64, "near_field_cells"),
                      (torch.float64, "near_field_cells_grad")):
        ops = (gated._binned_floats(binned, dtype)["tpts"], binned["wtab"], binned["wcnt"],
               *gated._cell_geometry(), mult.to(dtype))
        cases.append((f"1M gated m2p {dtype}", fn, kp, ops, {"tcnt": binned["tcnt"]},
                      binned["wtab"]))

    for label, fn_name, kparams, ops, counts, table in cases:
        fn = getattr(nf, fn_name)
        takes = inspect.signature(fn).parameters
        counts = {k: v for k, v in counts.items() if k in takes}
        items = hasattr(nf, "_ITEM_SOURCES") and "tcnt" in takes
        budgets = ([int(b) for b in sys.argv[1:]] or BUDGETS) if items else [None]
        call = lambda: fn(*ops, kparams=kparams, **counts)  # noqa: E731
        kept_budget = getattr(nf, "_ITEM_SOURCES", None)
        best = None
        for budget in budgets:
            line = f"{label} {fn_name} rows {ops[0].shape[0]}:"
            if budget is not None:
                nf._ITEM_SOURCES = budget
                call()  # builds the work list, kept on the table
                wl = table._work_items[2]
                line += (f" budget {budget}: items {wl.items.shape[0]}, partial blocks "
                         f"{wl.nparts},")
            outs = call()
            if not all(torch.isfinite(o).all() for o in (outs if isinstance(outs, tuple)
                                                          else (outs,))):
                raise AssertionError(f"{label}: not finite")
            ms = cuda_ms(call)
            print(f"{line} kernel {ms:.4f} ms", flush=True)
            if best is None or ms < best[1]:
                best = (budget, ms)
        if budget is not None:
            nf._ITEM_SOURCES = kept_budget
            print(f"{label} {fn_name}: fastest budget {best[0]} ({best[1]:.4f} ms)", flush=True)


if __name__ == "__main__":
    main()
