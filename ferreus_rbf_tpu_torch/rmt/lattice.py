"""Tetrahedral sampling lattice, indexed on the two-plane fine grid.

Maps ``ferreus_rmt/src/lattice.rs``: the lattice is a skewed fine grid with
spacing ``[res/2, res*sqrt(2)/2, res/sqrt(2)]``; ijk <-> world conversion is
vectorised numpy, and world -> owning-cell uses the U/V/W basis inverse.
"""

from __future__ import annotations

import numpy as np

from .constants import U, V, W

OPEN_CLIP_IJK_PADDING = 2


class SampleLattice:
    def __init__(self, resolution: float, extents):
        extents = np.asarray(extents, np.float64)
        self.min_corner = extents[:3].copy()
        self.max_corner = extents[3:].copy()
        sqrt2 = np.sqrt(2.0)
        self.spacing = np.array(
            [resolution / 2.0, resolution * sqrt2 / 2.0, resolution / sqrt2]
        )
        self.max_ijk = np.ceil((self.max_corner - self.min_corner) / self.spacing).astype(
            np.int64
        )
        self.max_ijk[0] += 1
        basis = np.stack([U, V, W], axis=1).astype(np.float64)
        self._basis_inv = np.linalg.inv(basis)

    def ijk_to_world(self, ijk) -> np.ndarray:
        """(N, 3) int ijk -> (N, 3) world coordinates (vectorised)."""
        ijk = np.asarray(ijk, np.float64)
        return self.min_corner + ijk * self.spacing

    def world_to_ijk(self, world) -> np.ndarray:
        """(N, 3) world -> owning-cell origin ijk (vectorised)."""
        eps = 1e-9
        p = (np.atleast_2d(np.asarray(world, np.float64)) - self.min_corner) / self.spacing
        q = p @ self._basis_inv.T
        abc = np.floor(q + eps).astype(np.int64)
        uvw = np.stack([U, V, W], axis=0).astype(np.int64)  # rows
        return abc @ uvw

    def extraction_ijk_inbounds(self, ijk) -> np.ndarray:
        """Vectorised bounds test with the open-clip padding."""
        ijk = np.atleast_2d(np.asarray(ijk, np.int64))
        lo = -OPEN_CLIP_IJK_PADDING
        hi = self.max_ijk + OPEN_CLIP_IJK_PADDING
        return np.all((ijk >= lo) & (ijk <= hi), axis=1)
