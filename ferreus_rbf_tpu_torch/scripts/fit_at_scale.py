"""At-scale fit: one N-point fit with its stage split, residual, peak
device memory and a true-f64 dense-oracle residual.

The port of ``scripts/fit_at_scale.py``, on the same synthetic data
(signed-distance samples in a shell around a bumpy sphere, LinearRbf):

    python3 -m ferreus_rbf_tpu_torch.scripts.fit_at_scale 3000000
    python3 -m ferreus_rbf_tpu_torch.scripts.fit_at_scale 1000000 --order 9
    python3 -m ferreus_rbf_tpu_torch.scripts.fit_at_scale 20000 --device cpu

It prints one JSON line at the end (:func:`fit_and_report`, which
``config5_isosurface.py`` shares): the card's name and power limit, the
fit's seconds and stages, the solver's residual, refinement rounds and
path, the peak device memory (``torch.cuda.max_memory_allocated``) as
``peak_device_gb``, whether the P2M/L2P anterpolation weights were made
per chunk (above ``ops/fmm/api.py`` ``_WEIGHT_TABLE_BYTES``), and the
residual of a dense f64 oracle (kernel sum, nugget and drift of the fitted
coefficients, summed in f64 on the fit's device) at ``--oracle-sample``
sources, free of the FMM's truncation.
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


def dense_field(rbfi, targets, chunk=16):
    """The fitted field at ``targets`` as a dense f64 sum over every source
    (kernel sum and drift, no FMM) on the fit's device: a host array."""
    from ferreus_rbf_tpu_torch.ops import polynomials
    from ferreus_rbf_tpu_torch.ops.dense import dense_matvec
    from ferreus_rbf_tpu_torch.ops.kernels import make_kernel

    settings = rbfi.interpolant_settings
    dev = rbfi.device
    out = dense_matvec(make_kernel(settings.kernel_params()), torch.as_tensor(targets, device=dev),
                       torch.as_tensor(rbfi.points, device=dev),
                       torch.as_tensor(rbfi.coefficients.point_coefficients, device=dev),
                       chunk=chunk).cpu().numpy()
    pc = rbfi.coefficients.poly_coefficients
    if pc is not None and pc.size:
        out = out + polynomials.evaluate_monomials(
            targets, settings.polynomial_degree, pc.shape[0], rbfi.translation_factor,
            rbfi.scale_factor) @ pc
    return out.reshape(-1)


def dense_oracle_residual(rbfi, vals, n_sample=512, seed=3):
    """The fit's true residual at ``n_sample`` sources: the dense f64 field
    (:func:`dense_field`) plus the nugget term against the input values,
    relative to max |values|. Returns (residual, sources)."""
    vals = np.asarray(vals, np.float64).reshape(-1)
    idx = np.sort(np.random.default_rng(seed).choice(
        vals.size, size=min(n_sample, vals.size), replace=False))
    w = rbfi.coefficients.point_coefficients[idx, 0]
    oracle = dense_field(rbfi, rbfi.points[idx]) + rbfi.interpolant_settings.nugget * w
    return float(np.max(np.abs(oracle - vals[idx])) / np.max(np.abs(vals))), int(idx.size)


def fit_and_report(n, seed=11, device="cuda", params=None, oracle_sample=512,
                   tag="fit_at_scale"):
    """Fit ``n`` points of :func:`synthetic_sd` with LinearRbf on ``device``
    under ``params`` (None: the defaults) and report it. Returns
    ``(rbfi, values, out)``; ``out`` holds the card's name and power limit
    (``card``, on the card), ``fit_s``, ``fit_stages_s``, the solver's
    ``solver_residual_rel`` and ``solver_converged`` (absent for a direct
    solve), ``refinement_rounds``, ``solver_path`` ("direct", or whether
    the fused FGMRES ran and the gate that chose the host loop),
    ``p2m_bytes``, ``weights_per_chunk`` (P2M/L2P weights made per chunk,
    above ``ops/fmm/api.py`` ``_WEIGHT_TABLE_BYTES``), the fit's peak and
    live device memory (``peak_device_gb``, ``live_after_fit_gb``, on the
    card) and the dense f64 oracle (``true_residual_rel_max`` at
    ``oracle_n_sample`` sources, ``oracle_s``)."""
    import ferreus_rbf_tpu_torch as frt
    from ferreus_rbf_tpu_torch.utils import timing

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out = {}
    if on_card:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    print(f"[{tag}] generating {n:,} synthetic SD points (seed {seed})", flush=True)
    pts, sd = synthetic_sd(n, seed)
    settings = frt.InterpolantSettings(kernel_type=frt.RBFKernelType.Linear)

    tracer = timing.enable_global_tracer()
    t0 = time.perf_counter()
    try:
        rbfi = frt.RBFInterpolator(pts, sd, settings, params, device=dev)
        if on_card:
            torch.cuda.synchronize(dev)
        out["fit_s"] = time.perf_counter() - t0
    finally:
        timing.disable_global_tracer()
    out["fit_stages_s"] = tracer.totals
    events = {}
    for e in tracer.events:
        events.setdefault(e["event"], []).append(e)
    done = events.get("solve_done")  # none for a direct solve
    if done:
        out["solver_residual_rel"] = done[-1]["residual"]
        out["solver_converged"] = done[-1]["converged"]
    out["refinement_rounds"] = len(events.get("refine_round", []))
    fused = events.get("fused_system")
    out["solver_path"] = ("direct" if not done else
                          {"fused": bool(fused and fused[-1]["ok"]),
                           "gate": "FERREUS_RBF_TPU_FUSED=0" if not fused else fused[-1]["gate"]})
    trees, targets = events.get("fmm_tree", []), events.get("fmm_targets", [])
    out["p2m_bytes"] = max((e["p2m_bytes"] for e in trees), default=0)
    out["weights_per_chunk"] = {"p2m": any(not e["p2m_resident"] for e in trees),
                                "l2p": any(not e["l2p_resident"] for e in targets)}
    if on_card:
        out["peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["live_after_fit_gb"] = torch.cuda.memory_allocated(dev) / 1e9
    print(f"[{tag}] fit done in {out['fit_s']:.3f} s; solver residual "
          f"{out.get('solver_residual_rel')}", flush=True)

    t0 = time.perf_counter()
    out["true_residual_rel_max"], out["oracle_n_sample"] = dense_oracle_residual(
        rbfi, sd, oracle_sample)
    out["oracle_s"] = time.perf_counter() - t0
    print(f"[{tag}] dense f64 oracle at {out['oracle_n_sample']} sources: "
          f"{out['true_residual_rel_max']:.3e} of max |values|", flush=True)
    return rbfi, sd, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="number of points")
    ap.add_argument("--order", type=int, default=None,
                    help="FMM interpolation order (default: the kernel's, 7 for LinearRbf)")
    ap.add_argument("--seed", type=int, default=11, help="seed of the synthetic data")
    ap.add_argument("--oracle-sample", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ferreus_rbf_tpu_torch.config import FmmCompressionType, FmmParams, Params

    params = None
    if args.order is not None:
        params = Params(fmm_params=FmmParams(
            interpolation_order=args.order, max_points_per_cell=256,
            compression_type=FmmCompressionType.ACA, epsilon=10.0 ** -args.order))
    out = {"n": args.n, "order": args.order or "default", "seed": args.seed,
           "kernel": "Linear (biharmonic)", "device": args.device}
    out.update(fit_and_report(args.n, args.seed, args.device, params, args.oracle_sample)[2])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
