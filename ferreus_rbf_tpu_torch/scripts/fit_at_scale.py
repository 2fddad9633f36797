"""At-scale fit: one N-point fit with its stage split, residual, peak
device memory and a true-f64 dense-oracle residual.

The port of ``scripts/fit_at_scale.py``, on the same synthetic data
(signed-distance samples in a shell around a bumpy sphere, LinearRbf):

    python3 -m ferreus_rbf_tpu_torch.scripts.fit_at_scale 3000000
    python3 -m ferreus_rbf_tpu_torch.scripts.fit_at_scale 1000000 --order 9
    python3 -m ferreus_rbf_tpu_torch.scripts.fit_at_scale 20000 --device cpu

It prints one JSON line at the end: the card's name and power limit, the
fit's seconds and stages, the solver's residual and refinement rounds, the
peak device memory (``torch.cuda.max_memory_allocated``) as
``peak_device_gb``, whether the P2M/L2P anterpolation weights were made
per chunk (above ``ops/fmm/api.py`` ``_WEIGHT_TABLE_BYTES``), and the
residual of a dense f64 oracle (numpy on the host: kernel sum, nugget and
drift of the fitted coefficients) at ``--oracle-sample`` sources, free of
the FMM's truncation.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def synthetic_sd(n, seed=11):
    """Signed-distance samples in a volumetric shell around a bumpy unit
    sphere (zero level = the bumpy sphere), radii continuous in [0.7, 1.3]:
    the port's copy of ``bench.py`` ``_synthetic_sd`` (config 4's data)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bump = 1.0 + 0.15 * np.sin(4 * dirs[:, 0]) * np.cos(3 * dirs[:, 1])
    radii = 0.7 + 0.6 * rng.random(n)
    pts = dirs * (bump * radii)[:, None]
    sd = (radii - 1.0) * bump
    return pts, sd


def dense_oracle_residual(rbfi, vals, n_sample=512, seed=3):
    """The fit's true residual at ``n_sample`` sources: dense numpy kernel
    rows in f64, nugget and drift, against the input values, relative to
    max |values|. No FMM and no device."""
    from ferreus_rbf_tpu_torch.ops.kernels import make_kernel
    from ferreus_rbf_tpu_torch.ops.polynomials import evaluate_monomials

    src = np.asarray(rbfi.points, np.float64)
    w = rbfi.coefficients.point_coefficients
    n = src.shape[0]
    idx = np.sort(np.random.default_rng(seed).choice(n, size=min(n_sample, n), replace=False))
    kernel = make_kernel(rbfi.interpolant_settings.kernel_params(), xp=np)
    chunk = max(1, int(2e7 // n))
    oracle = np.concatenate([kernel.pair(src[idx[s : s + chunk]], src) @ w
                             for s in range(0, idx.size, chunk)])
    oracle = oracle + rbfi.interpolant_settings.nugget * w[idx]
    pc = rbfi.coefficients.poly_coefficients
    if pc is not None and pc.size:
        oracle = oracle + evaluate_monomials(
            src[idx], rbfi.interpolant_settings.polynomial_degree, pc.shape[0],
            rbfi.translation_factor, rbfi.scale_factor) @ pc
    vals = np.asarray(vals, np.float64).reshape(-1)
    res = np.max(np.abs(oracle.reshape(-1) - vals[idx])) / np.max(np.abs(vals))
    return float(res), int(idx.size)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="number of points")
    ap.add_argument("--order", type=int, default=None,
                    help="FMM interpolation order (default: the kernel's, 7 for LinearRbf)")
    ap.add_argument("--seed", type=int, default=11, help="seed of the synthetic data")
    ap.add_argument("--oracle-sample", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.config import FmmCompressionType, FmmParams, Params
    from ferreus_rbf_tpu_torch.utils import timing

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    out = {"n": args.n, "order": args.order or "default", "seed": args.seed,
           "kernel": "Linear (biharmonic)", "device": str(dev)}
    if on_card:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    print(f"[fit_at_scale] generating {args.n:,} synthetic SD points (seed {args.seed})",
          flush=True)
    pts, sd = synthetic_sd(args.n, args.seed)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)
    params = None
    if args.order is not None:
        params = Params(fmm_params=FmmParams(
            interpolation_order=args.order, max_points_per_cell=256,
            compression_type=FmmCompressionType.ACA, epsilon=10.0 ** -args.order))

    tracer = timing.enable_global_tracer()
    t0 = time.perf_counter()
    try:
        rbfi = frt.RBFInterpolator(pts, sd, settings, params, device=dev)
        if on_card:
            torch.cuda.synchronize()
        out["fit_s"] = round(time.perf_counter() - t0, 3)
    finally:
        timing.disable_global_tracer()
    out["fit_stages_s"] = {k: round(v, 3) for k, v in tracer.totals.items()}
    events = tracer.events
    done = [e for e in events if e["event"] == "solve_done"]  # none for a direct solve
    if done:
        out["solver_residual_rel"] = done[-1]["residual"]
        out["solver_converged"] = done[-1]["converged"]
    out["refinement_rounds"] = sum(e["event"] == "refine_round" for e in events)
    trees = [e for e in events if e["event"] == "fmm_tree"]
    targets = [e for e in events if e["event"] == "fmm_targets"]
    out["p2m_bytes"] = max((e["p2m_bytes"] for e in trees), default=0)
    out["weights_per_chunk"] = {"p2m": any(not e["p2m_resident"] for e in trees),
                                "l2p": any(not e["l2p_resident"] for e in targets)}
    if on_card:
        out["peak_device_gb"] = round(torch.cuda.max_memory_allocated(dev) / 1e9, 3)
    print(f"[fit_at_scale] fit done in {out['fit_s']} s; solver residual "
          f"{out.get('solver_residual_rel')}", flush=True)

    t0 = time.perf_counter()
    out["true_residual_rel_max"], out["oracle_n_sample"] = dense_oracle_residual(
        rbfi, sd, args.oracle_sample)
    out["oracle_s"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
