"""Inputs both sides are handed: the frozen signed-distance generator, the
CSV reader and the seed streams."""

from __future__ import annotations

import numpy as np


def stream(seed: int, *keys) -> np.random.Generator:
    """A generator for one input of a run: the run's ``--seed`` and a key
    path such as ("fit", 3). Any whole seed works, negative or past 64 bits."""
    words = [int(seed) % 2**64] + [k if isinstance(k, int) else _word(k) for k in keys]
    return np.random.default_rng(np.random.SeedSequence(words))


def _word(key: str) -> int:
    return int.from_bytes(key.encode()[:8].ljust(8, b"\0"), "little")


def synthetic_sd(n, seed=11):
    """Signed-distance samples in a volumetric shell around a bumpy unit
    sphere (zero level = the bumpy sphere), radii continuous in [0.7, 1.3].

    Frozen copy of ``synthetic_sd`` in
    ``ferreus_rbf_tpu_torch/scripts/fit_at_scale.py`` at commit 581daba
    (config 4's data)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    bump = 1.0 + 0.15 * np.sin(4 * dirs[:, 0]) * np.cos(3 * dirs[:, 1])
    radii = 0.7 + 0.6 * rng.random(n)
    pts = dirs * (bump * radii)[:, None]
    sd = (radii - 1.0) * bump
    return pts, sd


def read_points_csv(path):
    """(points (n, 3), values (n,)) of a CSV with a header row and the
    columns X, Y, Z, value."""
    table = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2)
    return np.ascontiguousarray(table[:, :3]), np.ascontiguousarray(table[:, 3])
