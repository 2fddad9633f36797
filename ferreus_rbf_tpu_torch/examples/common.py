"""Shared helpers for the example scripts (the port's copy of
``examples/common.py``, importing only the port)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ferreus_rbf_tpu_torch import csv_to_point_arrays

# The real-geology signed-distance dataset (35,801 points: X, Y, Z,
# SignedDistance) under datasets/ at the repository root. Falls back to a
# synthetic signed-distance cloud if the file is missing, so the examples
# always run.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ALBATITE_CSV = os.environ.get(
    "ALBATITE_CSV", os.path.join(_REPO_ROOT, "datasets", "albatite_SD_points.csv"))


def parse_args(description: str, argv=None) -> argparse.Namespace:
    """``--device`` (default ``cuda``): where the fits and evaluations run."""
    ap = argparse.ArgumentParser(description=description.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fits and evaluations (default: cuda)")
    return ap.parse_args(argv)


def load_albatite():
    """The albatite points and values; ``FERREUS_EXAMPLES_MAX_POINTS`` > 0
    subsamples them (seed 0) to that many points."""
    if os.path.exists(ALBATITE_CSV):
        pts, vals = csv_to_point_arrays(ALBATITE_CSV, has_headers=True)
        cap = int(os.environ.get("FERREUS_EXAMPLES_MAX_POINTS", "0"))
        if 0 < cap < pts.shape[0]:
            sel = np.random.default_rng(0).choice(pts.shape[0], cap, replace=False)
            pts, vals = pts[sel], vals[sel]
        return pts, vals
    # fallback: signed distances to a lumpy closed surface
    rng = np.random.default_rng(42)
    n = 35_801
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bump = 1.0 + 0.15 * np.sin(4 * dirs[:, 0]) * np.cos(3 * dirs[:, 1])
    radii = rng.choice([0.75, 1.0, 1.25], size=n)
    pts = dirs * (bump * radii)[:, None] * 100.0
    sd = (radii - 1.0) * 100.0
    return pts, sd[:, None]


def sphere_sdf(pts):
    """The unit sphere's signed distance, (n, 1)."""
    return np.linalg.norm(pts, axis=1, keepdims=True) - 1.0


def sphere_grad(pts):
    """The unit sphere's signed distance and its gradient."""
    n = np.linalg.norm(pts, axis=1, keepdims=True)
    return n - 1.0, pts / np.maximum(n, 1e-12)
