"""FMM evaluator error budget: truncation against precision.

Port of ``ferreus_rbf_tpu/ops/fmm/diagnostics.py``. When an interpolant's
values differ from a dense f64 oracle at scale, is the error Chebyshev/ACA
truncation of the far field (which the reference shares: its f64
arithmetic reproduces only the truncated value), or the arithmetic of the
evaluator itself?

The sweep holds the points and weights fixed and varies one axis at a time:

- ``interpolation_order`` p: truncation scales ~10^-p; anything that does
  not move with p is not truncation.
- the precision tier at fixed p: ``"f64"`` against ``"f32"``.

The JAX package sweeps three tiers (the epsilon-dialed df64 far field, the
full df64 dial and f32) because a TPU has no f64. The port's f64 tier is
plain f64 with no dial, so its sweep has two tiers, and its verdicts are
two: ``cheb_truncation`` when the f64 error tracks p, else ``f64_floor``
(the JAX package's ``far_dial`` cannot arise).

Every variant is compared with the same dense numpy-f64 oracle (exact
kernel sums, no FMM) on a sampled subset of the points.
"""

from __future__ import annotations

import numpy as np

from ...config import FmmCompressionType, FmmParams
from ...utils.timing import to_device
from ..kernels import make_kernel
from .api import FmmTree


def dense_oracle(pts, weights, kparams, sample_idx, chunk_bytes=2e9):
    """Dense numpy-f64 kernel sum at ``pts[sample_idx]``: the exact value."""
    pts = np.asarray(pts, np.float64)
    w = np.asarray(weights, np.float64)
    if w.ndim == 1:
        w = w[:, None]
    targets = pts[sample_idx]
    kernel = make_kernel(kparams, xp=np)
    chunk = max(1, int(chunk_bytes // (pts.shape[0] * 8)))
    return np.concatenate([
        kernel.pair(targets[s : s + chunk], pts) @ w
        for s in range(0, targets.shape[0], chunk)
    ])


def fmm_error_budget(
    pts,
    weights,
    kparams,
    orders=(5, 7, 9),
    n_sample=256,
    seed=3,
    adaptive_tree=True,
    max_points_per_cell=256,
    device=None,
):
    """Max relative FMM-vs-dense error per (order, precision tier).

    Returns ``{"n", "n_sample", "entries": [{"p", "prec", "err"}...],
    "tracks_p", "verdict"}``; ``verdict`` is ``"cheb_truncation"`` when the
    f64 error at the highest order is below a tenth of that at the lowest,
    else ``"f64_floor"``. ``device`` defaults to the CUDA card.
    """
    pts = np.asarray(pts, np.float64)
    w = np.asarray(weights, np.float64)
    if w.ndim == 1:
        w = w[:, None]
    n = pts.shape[0]
    rng = np.random.default_rng(seed)
    sample_idx = np.sort(rng.choice(n, size=min(n_sample, n), replace=False))
    oracle = dense_oracle(pts, w, kparams, sample_idx)
    scale = max(float(np.max(np.abs(oracle))), 1e-300)

    entries, by_key = [], {}
    for p in orders:
        params = FmmParams(
            interpolation_order=int(p),
            max_points_per_cell=max_points_per_cell,
            compression_type=FmmCompressionType.ACA,
            epsilon=10.0 ** (-int(p)),
        )
        tree = FmmTree(pts, int(p), kparams, adaptive_tree=adaptive_tree, sparse=True,
                       params=params, device=device)
        tree.prepare_targets(pts[sample_idx], "sample")
        w_dev = to_device(w, tree.device)
        for prec in ("f64", "f32"):
            vals = tree.evaluate_device(w_dev, "sample", precision=prec).cpu().numpy()
            err = float(np.max(np.abs(vals - oracle)) / scale)
            entries.append({"p": int(p), "prec": prec, "err": err})
            by_key[(int(p), prec)] = err
        del tree

    ps = sorted({e["p"] for e in entries})
    f64 = [by_key[(p, "f64")] for p in ps]
    tracks_p = len(ps) >= 2 and f64[-1] < 0.1 * f64[0]
    return {
        "n": int(n),
        "n_sample": int(sample_idx.size),
        "entries": entries,
        "tracks_p": bool(tracks_p),
        "verdict": "cheb_truncation" if tracks_p else "f64_floor",
        "note": "err = max rel FMM-vs-dense-f64 at the sample, each plan at "
                "epsilon = 1e-p",
    }
