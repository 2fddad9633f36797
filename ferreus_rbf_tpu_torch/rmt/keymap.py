"""Packed integer lattice keys + sorted-array maps for the RMT driver.

The reference's extraction driver is compiled Rust over hashmaps
(``ferreus_rmt/src/isosurface.rs:489-1047``). The TPU-framework analogue is
batched numpy over int64-packed (i, j, k) keys — the same sort/unique/
searchsorted idiom ``ops/fmm/tree.py`` uses for the octree — so every
wavefront generation, marching sweep and topology pass is a handful of
vectorised array ops rather than per-cell Python.

Packing: 20 bits per axis with a +2^19 offset (|index| < 524288 per axis),
60 bits total, leaving 3 low bits for the owned-edge label in edge keys.
"""

from __future__ import annotations

import numpy as np

_BIAS = 1 << 19
_AXIS_BITS = 20
_AXIS_MASK = (1 << _AXIS_BITS) - 1
MAX_ABS_INDEX = _BIAS - 1


def pack_ijk(ijk) -> np.ndarray:
    """(..., 3) integer lattice coordinates -> (...,) int64 keys."""
    ijk = np.asarray(ijk, np.int64)
    return (
        ((ijk[..., 0] + _BIAS) << (2 * _AXIS_BITS))
        | ((ijk[..., 1] + _BIAS) << _AXIS_BITS)
        | (ijk[..., 2] + _BIAS)
    )


def unpack_ijk(keys) -> np.ndarray:
    """(...,) int64 keys -> (..., 3) integer lattice coordinates."""
    keys = np.asarray(keys, np.int64)
    i = (keys >> (2 * _AXIS_BITS)) - _BIAS
    j = ((keys >> _AXIS_BITS) & _AXIS_MASK) - _BIAS
    k = (keys & _AXIS_MASK) - _BIAS
    return np.stack([i, j, k], axis=-1)


def edge_key(owner_keys, labels) -> np.ndarray:
    """Packed (owner sample, owned-edge label 0-6) -> int64 edge keys."""
    return (np.asarray(owner_keys, np.int64) << 3) | np.asarray(labels, np.int64)


def in_sorted(sorted_keys: np.ndarray, queries) -> np.ndarray:
    """Membership of ``queries`` in an ascending key array."""
    q = np.asarray(queries, np.int64)
    pos = np.searchsorted(sorted_keys, q)
    pos = np.minimum(pos, max(sorted_keys.size - 1, 0))
    if sorted_keys.size == 0:
        return np.zeros(q.shape, bool)
    return sorted_keys[pos] == q


def merge_sorted(sorted_keys: np.ndarray, new_keys: np.ndarray) -> np.ndarray:
    """Union of an ascending key array with (unique, disjoint) new keys."""
    if new_keys.size == 0:
        return sorted_keys
    merged = np.concatenate([sorted_keys, new_keys])
    merged.sort(kind="stable")
    return merged


class KeyedValues:
    """A sorted int64-key -> value-row map with batched lookup/insert."""

    def __init__(self, value_shape=(), dtype=np.float64, fill=np.nan):
        self._keys = np.zeros(0, np.int64)
        self._vals = np.zeros((0,) + tuple(value_shape), dtype)
        self._fill = fill

    @property
    def keys(self) -> np.ndarray:
        return self._keys

    @property
    def values(self) -> np.ndarray:
        return self._vals

    def contains(self, queries) -> np.ndarray:
        return in_sorted(self._keys, queries)

    def insert(self, keys, vals) -> None:
        """Insert unique keys not already present (caller guarantees both)."""
        keys = np.asarray(keys, np.int64)
        if keys.size == 0:
            return
        vals = np.asarray(vals, self._vals.dtype)
        merged = np.concatenate([self._keys, keys])
        order = np.argsort(merged, kind="stable")
        self._keys = merged[order]
        self._vals = np.concatenate([self._vals, vals])[order]

    def update(self, keys, vals) -> None:
        """Set values for keys; existing keys are overwritten in place."""
        keys = np.asarray(keys, np.int64)
        if keys.size == 0:
            return
        vals = np.asarray(vals, self._vals.dtype)
        pos = np.searchsorted(self._keys, keys)
        pos0 = np.minimum(pos, max(self._keys.size - 1, 0))
        exists = (self._keys.size > 0) & (self._keys[pos0] == keys)
        self._vals[pos0[exists]] = vals[exists]
        if (~exists).any():
            self.insert(keys[~exists], vals[~exists])

    def lookup(self, queries):
        """(values, found): missing entries get the fill value."""
        q = np.asarray(queries, np.int64)
        flat = q.reshape(-1)
        pos = np.searchsorted(self._keys, flat)
        if self._keys.size == 0:
            found = np.zeros(flat.shape, bool)
            pos0 = np.zeros(flat.shape, np.int64)
        else:
            pos0 = np.minimum(pos, self._keys.size - 1)
            found = self._keys[pos0] == flat
        out = np.full(flat.shape + self._vals.shape[1:], self._fill, self._vals.dtype)
        out[found] = self._vals[pos0[found]]
        return (
            out.reshape(q.shape + self._vals.shape[1:]),
            found.reshape(q.shape),
        )

    def as_dict(self) -> dict:
        """Materialise as {(i, j, k): value} (compat for host-side stages)."""
        coords = unpack_ijk(self._keys)
        return {
            (int(c[0]), int(c[1]), int(c[2])): v
            for c, v in zip(coords, self._vals)
        }
