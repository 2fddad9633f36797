#!/usr/bin/env python3
"""Time the config-4 fit (1,000,000 points) on one card.

    python3 config4_fit.py                         # the package beside this script
    cd <other tree> && python3 <this script>       # the package of the working directory
    python3 config4_fit.py albatite                # phase 4's albatite fit instead

On one CUDA card, for the ``ferreus_rbf_tpu_torch`` package found in the
working directory, it fits ``chip_smoke.py``'s phase-7 data (config 4: the
1M-point LinearRbf signed-distance samples, seed 11, default ``Params``) as
phase 7 does, under the stage tracer, and prints one JSON line: the fit's
host seconds, its stages (``solve_column`` among them), the solver's
residual and refinement rounds, the kernels' launches, the peak device
memory and a SHA-256 of the point and polynomial coefficients, so that two
trees that should give the same bits can be held against each other.
Then, on the fit's own operator (``solver.iterative.DeviceSystem``), it
times the parts of one solver iteration: the f32 and f64 matvecs, and per
Schwarz level the restricted f32 matvec and the level's domain solves
(``DDMTree.solve_fine_level``), each the median host milliseconds of 11
calls ended by ``torch.cuda.synchronize()``, and profiles one call of each
level's solves (``torch.profiler``: the ops with the most device time,
with their counts). Run it on two trees in one
call (parent, change, change, parent) to compare them on one card. With
the argument ``albatite`` it fits ``chip_smoke.py``'s phase-4 data (the
35,801 albatite points, Spheroidal5, default ``Params``) the same way.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("config4_fit.py needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.ops.fmm import near_field as nf
    from ferreus_rbf_tpu_torch.scripts.fit_at_scale import synthetic_sd
    from ferreus_rbf_tpu_torch.solver import iterative
    from ferreus_rbf_tpu_torch.utils import timing

    # the albatite data of this script's own chip_smoke.py, whichever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke_data",
                                                  os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    package = os.path.dirname(os.path.abspath(frt.__file__))
    nf.build()
    dev = torch.device("cuda", 0)
    torch.cuda.init()  # the allocator's peak counters exist after this
    data = sys.argv[1] if len(sys.argv) > 1 else "config4"
    if data == "albatite":
        pts, sd, _, settings = smoke.albatite_data(frt)
    elif data == "config4":
        pts, sd = synthetic_sd(1_000_000, seed=11)
        settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    else:
        raise SystemExit(f"config4_fit.py takes no argument or 'albatite', got {data!r}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tracer = timing.enable_global_tracer()
    nf.reset_launches()
    kept = []
    init = iterative.DeviceSystem.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        kept.append(self)

    iterative.DeviceSystem.__init__ = keep
    t0 = time.perf_counter()
    try:
        rbfi = frt.RBFInterpolator(pts, sd, settings, device=dev)
        torch.cuda.synchronize()
    finally:
        timing.disable_global_tracer()
        iterative.DeviceSystem.__init__ = init
    fit_s = time.perf_counter() - t0
    launches = {k: v for k, v in nf.LAUNCHES.items() if v}
    done = [e for e in tracer.events if e["event"] == "solve_done"][-1]
    c = rbfi.coefficients
    digest = hashlib.sha256(np.ascontiguousarray(c.point_coefficients).tobytes()
                            + np.ascontiguousarray(c.poly_coefficients).tobytes()).hexdigest()
    system = kept[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn((system.n + system.m, 1), generator=gen, device=dev, dtype=torch.float64)

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(11):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return sorted(times)[5] * 1e3

    parts = {"matvec_f32": median_ms(lambda: system.matvec_f32(w)),
             "matvec_f64": median_ms(lambda: system.matvec(w))}
    for i in range(len(system.ddm_tree.levels) - 1):
        parts[f"level{i}_matvec_f32"] = median_ms(lambda: system.matvec_partial(w, i))
        parts[f"level{i}_solves"] = median_ms(lambda: system.ddm_tree.solve_fine_level(i, w))
    parts["coarse_matvec_f32"] = median_ms(lambda: system.matvec_partial(w, "coarse"))
    # where each level's solves spend the card's time: one profiled call
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    solves = {}
    for i in range(len(system.ddm_tree.levels) - 1):
        with torch.profiler.profile(activities=act) as prof:
            system.ddm_tree.solve_fine_level(i, w)
            torch.cuda.synchronize()
        rows = [(e.key, e.count, getattr(e, "device_time_total", 0.0), e.cpu_time_total)
                for e in prof.key_averages()]
        rows.sort(key=lambda r: -r[2])
        solves[f"level{i}"] = {
            "buckets": len(system.ddm_tree.levels[i].buckets),
            "domains": sum(b["pts_idx"].shape[0] for b in system.ddm_tree.levels[i].buckets),
            "top_device_us": rows[:8]}
    print(json.dumps({
        "card": card, "package": package, "data": data, "fit_s": fit_s,
        "solve_column_s": tracer.totals.get("solve_column"),
        "stages_s": tracer.totals,
        "residual": done["residual"], "converged": done["converged"],
        "refine_rounds": sum(e["event"] == "refine_round" for e in tracer.events),
        "launches": launches,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "coefficients_sha256": digest, "parts_ms": parts, "solves_profile": solves,
    }), flush=True)


if __name__ == "__main__":
    main()
