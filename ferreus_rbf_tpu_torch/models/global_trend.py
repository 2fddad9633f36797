"""Global anisotropy / trend transforms (maps ``ferreus_rbf/src/global_trend.rs``).

A trend is a center-pinned affine transform ``T_back * Scale(1/ratios) *
Rot * T`` applied to input space before fitting; rotation uses the
left-hand rule (positive = clockwise), the 3D sequence is Z-X-Z'
(dip_direction -> dip -> pitch), angles in degrees. Points transform as
row vectors: ``x' = [x, 1] @ A`` with ``A`` the transposed affine matrix —
the same convention as the reference (``global_trend.rs:266-272``).

The port's own copy of ``ferreus_rbf_tpu/models/global_trend.py`` (host
numpy, unchanged), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


class GlobalTrend:
    """Anisotropy specification; build with ``one``/``two``/``three``."""

    def __init__(self, kind: str, **kwargs):
        self.kind = kind
        self.params = kwargs

    @classmethod
    def one(cls, major_ratio: float) -> "GlobalTrend":
        return cls("one", major_ratio=major_ratio)

    @classmethod
    def two(cls, rotation_angle: float, major_ratio: float, minor_ratio: float) -> "GlobalTrend":
        return cls(
            "two",
            rotation_angle=rotation_angle,
            major_ratio=major_ratio,
            minor_ratio=minor_ratio,
        )

    @classmethod
    def three(
        cls,
        dip: float,
        dip_direction: float,
        pitch: float,
        major_ratio: float,
        semi_major_ratio: float,
        minor_ratio: float,
    ) -> "GlobalTrend":
        return cls(
            "three",
            dip=dip,
            dip_direction=dip_direction,
            pitch=pitch,
            major_ratio=major_ratio,
            semi_major_ratio=semi_major_ratio,
            minor_ratio=minor_ratio,
        )


def _rot_z(theta: float, n: int) -> np.ndarray:
    m = np.eye(n)
    c, s = np.cos(theta), np.sin(theta)
    m[0, 0], m[0, 1] = c, s
    m[1, 0], m[1, 1] = -s, c
    return m


def _rot_x(theta: float, n: int) -> np.ndarray:
    m = np.eye(n)
    c, s = np.cos(theta), np.sin(theta)
    m[1, 1], m[1, 2] = c, s
    m[2, 1], m[2, 2] = -s, c
    return m


class GlobalTrendTransform:
    """Concrete affine transform pinned at ``center``."""

    def __init__(self, center, global_trend: GlobalTrend):
        center = np.asarray(center, np.float64).ravel()
        p = global_trend.params
        if global_trend.kind == "one":
            n = 2
            translate = np.eye(n)
            translate[0, n - 1] = -center[0]
            translate_back = np.eye(n)
            translate_back[0, n - 1] = center[0]
            scale = np.diag([1.0 / p["major_ratio"], 1.0])
            affine = translate_back @ scale @ translate
        elif global_trend.kind == "two":
            n = 3
            translate = np.eye(n)
            translate[:2, 2] = -center[:2]
            translate_back = np.eye(n)
            translate_back[:2, 2] = center[:2]
            rotation = _rot_z(-np.deg2rad(p["rotation_angle"]), n)
            scale = np.diag([1.0 / p["major_ratio"], 1.0 / p["minor_ratio"], 1.0])
            affine = translate_back @ scale @ rotation @ translate
        elif global_trend.kind == "three":
            n = 4
            translate = np.eye(n)
            translate[:3, 3] = -center[:3]
            translate_back = np.eye(n)
            translate_back[:3, 3] = center[:3]
            rot = (
                _rot_z(-np.deg2rad(p["pitch"]), n)
                @ _rot_x(-np.deg2rad(p["dip"]), n)
                @ _rot_z(-np.deg2rad(p["dip_direction"]), n)
            )
            scale = np.diag(
                [
                    1.0 / p["major_ratio"],
                    1.0 / p["semi_major_ratio"],
                    1.0 / p["minor_ratio"],
                    1.0,
                ]
            )
            affine = translate_back @ scale @ rot @ translate
        else:
            raise ValueError(f"Unknown trend kind {global_trend.kind}")

        # Row-vector convention: x' = [x, 1] @ affine^T
        self.affine_transform = affine.T.copy()
        self.inverse_transform = np.linalg.inv(self.affine_transform)

    def transform_points(self, points) -> np.ndarray:
        pts = np.asarray(points, np.float64)
        hom = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
        return (hom @ self.affine_transform)[:, : pts.shape[1]]

    def inverse_transform_points(self, points) -> np.ndarray:
        pts = np.asarray(points, np.float64)
        hom = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
        return (hom @ self.inverse_transform)[:, : pts.shape[1]]

    def linear_part(self, dims: int) -> np.ndarray:
        """Linear part B of x' = x @ B + b."""
        return self.affine_transform[:dims, :dims].copy()

    def to_dict(self) -> dict:
        return {
            "affine_transform": self.affine_transform.tolist(),
            "inverse_transform": self.inverse_transform.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "GlobalTrendTransform":
        obj = cls.__new__(cls)
        obj.affine_transform = np.asarray(d["affine_transform"], np.float64)
        obj.inverse_transform = np.asarray(d["inverse_transform"], np.float64)
        return obj
