#!/usr/bin/env python3
"""Time the config-2 FMM matvec and check that repeats are bitwise equal.

    python3 config2_matvec.py                      # the package beside this script
    cd <other tree> && python3 <this script>       # the package of the working directory

On one CUDA card, for the ``ferreus_rbf_tpu_torch`` package found in the
working directory, it builds ``chip_smoke.py``'s phase-3 tree (config 2:
100,000 uniform 3-D points, LinearRbf, p = 5, 8 RHS, uniform tree, ACA at
1e-5) and times ``evaluate_device`` at f32 and f64 after one warm-up: the
median and least host milliseconds of 21 calls, each ended by
``torch.cuda.synchronize()`` (as phase 3 times it), and the mean of 20
calls back to back between two CUDA events. It prints whether two calls
give the same bits and how far apart they are. Run it on two trees in one
call (parent, change, change, parent) to compare them on one card.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def main():
    if not torch.cuda.is_available():
        raise SystemExit("config2_matvec.py needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
    from ferreus_rbf_tpu_torch.ops.fmm.api import FmmTree
    from ferreus_rbf_tpu_torch.ops.kernels import KernelParams, KernelType

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    package = os.path.dirname(os.path.abspath(frt.__file__))
    nf.build()
    dev = torch.device("cuda", 0)
    n, nrhs, p = 100_000, 8, 5
    rng = np.random.default_rng(42)
    pts = rng.random((n, 3))
    w = torch.as_tensor(rng.standard_normal((n, nrhs)), device=dev)
    params = frt.FmmParams(interpolation_order=p, max_points_per_cell=256,
                           compression_type=frt.FmmCompressionType.ACA, epsilon=10.0**-p)
    tree = FmmTree(pts, p, KernelParams(KernelType.LinearRbf), adaptive_tree=False,
                   sparse=True, params=params, device=dev)
    tree.prepare_targets(pts, "src")
    out = {"card": card, "package": package}
    for prec in ("f32", "f64"):
        first = tree.evaluate_device(w, "src", prec)
        torch.cuda.synchronize()
        times = []
        for _ in range(21):
            t0 = time.perf_counter()
            again = tree.evaluate_device(w, "src", prec)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            tree.evaluate_device(w, "src", prec)
        stop.record()
        stop.synchronize()
        out[prec] = {"median_ms": sorted(times)[10] * 1e3, "min_ms": min(times) * 1e3,
                     "back_to_back_ms": start.elapsed_time(stop) / 20,
                     "repeat_bitwise": bool(torch.equal(first, again)),
                     "repeat_max_abs_diff": float((first - again).abs().max())}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
