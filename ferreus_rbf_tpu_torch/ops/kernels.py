"""Radial kernel functions phi(r), as closures over squared distance.

Port of ``ferreus_rbf_tpu/ops/kernels.py`` (the registry of the ten
reference kernels and their analytic gradients):

* LinearRbf              phi(r) = -r
* ThinPlateSplineRbf     phi(r) = r^2 ln r            (0 at r = 0)
* CubicRbf               phi(r) = r^3
* Spheroidal{3,5,7,9}Rbf piecewise near-linear / far-decay with calibrated
                         constants (``SPHEROIDAL_CONSTANTS``)
* Laplacian              phi(r) = 1/r                 (0 at r = 0)
* OneOverR2              phi(r) = 1/r^2               (0 at r = 0)
* OneOverR4              phi(r) = 1/r^4               (0 at r = 0)

One formula source serves two backends: ``make_kernel(params)`` builds torch
closures (f64 by default, ``dtype=torch.float32`` for the solver's inner
iterations) and ``make_kernel(params, xp=numpy)`` the host twin used by the
setup-time operator builds. The card has native f64, so sqrt and reciprocal
are the plain operations. ``r2 <= eps`` counts as coincident (TPS and the
inverse powers give 0 there, and every gradient factor is 0 there: the
evaluation points may be the sources themselves). The CUDA near field
evaluates the same formulas (``csrc/near_field.cu``, ``phi`` and
``phi_gscale``) from :func:`kernel_code`.

Gradients follow the reference convention: grad phi at displacement
``d = t - s`` is ``d * grad_scale_r2(|d|^2)``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import numpy as np
import torch

_EPS = float(np.finfo(np.float64).eps)


class KernelType(enum.Enum):
    """The ten kernels of the reference registry."""

    LinearRbf = "LinearRbf"
    ThinPlateSplineRbf = "ThinPlateSplineRbf"
    CubicRbf = "CubicRbf"
    Spheroidal3Rbf = "Spheroidal3Rbf"
    Spheroidal5Rbf = "Spheroidal5Rbf"
    Spheroidal7Rbf = "Spheroidal7Rbf"
    Spheroidal9Rbf = "Spheroidal9Rbf"
    Laplacian = "Laplacian"
    OneOverR2 = "OneOverR2"
    OneOverR4 = "OneOverR4"


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Runtime kernel configuration; ``base_range`` and ``total_sill`` only
    affect spheroidal kernels."""

    kernel_type: KernelType
    base_range: float = 1.0
    total_sill: float = 1.0

    def __post_init__(self):
        if not self.base_range > 0.0:
            raise ValueError("base_range must be > 0")
        if not self.total_sill <= self.base_range:
            raise ValueError("total_sill must be <= base_range")


@dataclasses.dataclass(frozen=True)
class SpheroidalConstants:
    """Calibrated spheroidal family constants."""

    inflexion_point: float
    linear_slope: float
    range_scaling: float
    inv_y_intercept: float


SPHEROIDAL_CONSTANTS = {
    3: SpheroidalConstants(0.5000000000, 0.7500000000, 2.6798340586, 0.8734640537),
    5: SpheroidalConstants(0.4082482905, 1.0206207262, 1.5822795750, 0.8575980168),
    7: SpheroidalConstants(0.3535533906, 1.2374368671, 1.2008676644, 0.8494862533),
    9: SpheroidalConstants(0.3162277660, 1.4230249471, 1.0000000000, 0.8445585690),
}

_SPHEROIDAL_POW = {3: 1, 5: 2, 7: 3, 9: 4}

_SPHEROIDAL_ORDER = {
    KernelType.Spheroidal3Rbf: 3,
    KernelType.Spheroidal5Rbf: 5,
    KernelType.Spheroidal7Rbf: 7,
    KernelType.Spheroidal9Rbf: 9,
}

# Kernel ids shared with the CUDA near field's ``phi`` switch.
KERNEL_CODES = {kt: i for i, kt in enumerate(KernelType)}


class _NumpyOps:
    where = staticmethod(np.where)
    sqrt = staticmethod(np.sqrt)
    log = staticmethod(np.log)

    @staticmethod
    def clamp0(x):
        return np.maximum(x, 0.0)


class _TorchOps:
    where = staticmethod(torch.where)
    sqrt = staticmethod(torch.sqrt)
    log = staticmethod(torch.log)

    @staticmethod
    def clamp0(x):
        return torch.clamp(x, min=0.0)


class Kernel:
    """A concrete kernel: vectorised ``phi_r2`` and gradient factor
    ``grad_scale_r2`` over squared distances.

    ``supports_gradients`` mirrors the reference's optional gradient
    evaluation: all ten registry kernels support it; ``FmmTree`` raises
    ``KernelDoesNotSupportGradientsError`` for a kernel that does not.
    """

    supports_gradients = True

    def __init__(self, phi_r2: Callable, grad_scale_r2: Callable, xp, dtype):
        self.phi_r2 = phi_r2
        self.grad_scale_r2 = grad_scale_r2
        self.xp = xp
        self.dtype = dtype

    def _as(self, x):
        if self.xp is torch:
            return torch.as_tensor(x, dtype=self.dtype)
        return np.asarray(x, dtype=self.dtype)

    def phi(self, r):
        r = self._as(r)
        return self.phi_r2(r * r)

    def pair_r2(self, targets, sources):
        """Pairwise squared distances r2[..., i, j] = |t_i - s_j|^2."""
        t = self._as(targets)
        s = self._as(sources)
        diff = t[..., :, None, :] - s[..., None, :, :]
        return (diff * diff).sum(-1)

    def pair(self, targets, sources):
        """Dense kernel block K[..., i, j] = phi(|t_i - s_j|)."""
        return self.phi_r2(self.pair_r2(targets, sources))

    def pair_with_grad(self, targets, sources):
        """``(K, G)``: ``K[..., i, j] = phi(|t_i - s_j|)`` and
        ``G[..., i, j, k] = d/dt_k phi(t_i - s_j)``."""
        t = self._as(targets)
        s = self._as(sources)
        diff = t[..., :, None, :] - s[..., None, :, :]
        r2 = (diff * diff).sum(-1)
        return self.phi_r2(r2), diff * self.grad_scale_r2(r2)[..., None]


def _guard(ops, r2, fn):
    """fn(r2) where r2 > eps (coincident points), else 0; masked lanes
    see r2 = 1, so they never produce inf or NaN."""
    mask = r2 > _EPS
    return ops.where(mask, fn(ops.where(mask, r2, 1.0)), 0.0)


def _linear(ops):
    # phi(r) = -r; grad factor -1/r
    def phi_r2(r2):
        return -ops.sqrt(ops.clamp0(r2))

    def grad(r2):
        return _guard(ops, r2, lambda x: -1.0 / ops.sqrt(x))

    return phi_r2, grad


def _tps(ops):
    # phi(r) = r^2 ln r (0 at 0); grad factor 2 ln r + 1
    def phi_r2(r2):
        safe = ops.where(r2 > _EPS, r2, 1.0)
        return ops.where(r2 > _EPS, r2 * (0.5 * ops.log(safe)), 0.0)

    def grad(r2):
        return _guard(ops, r2, lambda x: 2.0 * (0.5 * ops.log(x)) + 1.0)

    return phi_r2, grad


def _cubic(ops):
    # phi(r) = r^3; grad factor 3 r
    def phi_r2(r2):
        return r2 * ops.sqrt(ops.clamp0(r2))

    def grad(r2):
        return _guard(ops, r2, lambda x: 3.0 * ops.sqrt(x))

    return phi_r2, grad


def _spheroidal(ops, order: int, base_range: float, total_sill: float):
    # near (s^2 r^2 <= ip^2): total_sill - total_sill*linear_slope*s * r
    # far:                    total_sill*inv_y_intercept / (t^POW sqrt(t)),
    #                         t = 1 + (s r)^2,  s = range_scaling/base_range
    # grad factor: near -near_slope / r; far far_grad / (t^(POW+1) sqrt(t)),
    #              far_grad = -2 (POW + 1/2) s^2 far_coef
    c = spheroidal_coefficients(order, base_range, total_sill)
    pw = c["pw"]

    def phi_r2(r2):
        sr2 = c["s2"] * r2
        near = total_sill - c["near_slope"] * ops.sqrt(ops.clamp0(r2))
        t = 1.0 + sr2
        far = c["far_coef"] / (t ** pw * ops.sqrt(t))
        return ops.where(sr2 <= c["ip2"], near, far)

    def grad_live(r2):
        sr2 = c["s2"] * r2
        near = -c["near_slope"] / ops.sqrt(r2)
        t = 1.0 + sr2
        far = c["far_grad"] / (t ** (pw + 1) * ops.sqrt(t))
        return ops.where(sr2 <= c["ip2"], near, far)

    return phi_r2, lambda r2: _guard(ops, r2, grad_live)


def _inverse_power(ops, p: int):
    # phi(r) = 1/r^p (0 at 0); grad factor -p / r^(p+2)
    def inv_pow(q):
        """r^-q where r2 > eps, else 0 (q may be odd: a half power of r2)."""
        return lambda r2: _guard(
            ops, r2, lambda x: x ** (-q / 2.0) if q % 2 else x ** (-(q // 2)))

    phi_r2 = inv_pow(p)
    grad_q = inv_pow(p + 2)
    return phi_r2, lambda r2: -p * grad_q(r2)


def spheroidal_coefficients(order: int, base_range: float, total_sill: float) -> dict:
    """Derived constants of one spheroidal kernel (host floats)."""
    c = SPHEROIDAL_CONSTANTS[order]
    s = c.range_scaling / base_range
    return {
        "s2": s * s,
        "ip2": c.inflexion_point * c.inflexion_point,
        "near_slope": total_sill * c.linear_slope * s,
        "far_coef": total_sill * c.inv_y_intercept,
        "far_grad": -2.0 * (_SPHEROIDAL_POW[order] + 0.5) * (s * s)
        * (total_sill * c.inv_y_intercept),
        "total_sill": float(total_sill),
        "pw": _SPHEROIDAL_POW[order],
    }


def kernel_code(params: KernelParams) -> tuple[int, dict]:
    """(kernel id, spheroidal constants) as the CUDA near field takes them;
    the constants are zeros for non-spheroidal kernels."""
    kt = params.kernel_type
    if kt in _SPHEROIDAL_ORDER:
        coef = spheroidal_coefficients(
            _SPHEROIDAL_ORDER[kt], params.base_range, params.total_sill
        )
    else:
        coef = {"s2": 0.0, "ip2": 0.0, "near_slope": 0.0, "far_coef": 0.0,
                "far_grad": 0.0, "total_sill": 0.0, "pw": 0}
    return KERNEL_CODES[kt], coef


def make_kernel(params: KernelParams, xp=torch, dtype=None) -> Kernel:
    """KernelParams -> concrete kernel.

    ``xp=torch`` (default) builds tensor closures, ``xp=numpy`` the host
    twin; ``dtype`` defaults to float64.
    """
    ops = _TorchOps if xp is torch else _NumpyOps
    if dtype is None:
        dtype = torch.float64 if xp is torch else np.float64
    kt = params.kernel_type
    if kt == KernelType.LinearRbf:
        phi, grad = _linear(ops)
    elif kt == KernelType.ThinPlateSplineRbf:
        phi, grad = _tps(ops)
    elif kt == KernelType.CubicRbf:
        phi, grad = _cubic(ops)
    elif kt in _SPHEROIDAL_ORDER:
        phi, grad = _spheroidal(ops, _SPHEROIDAL_ORDER[kt], params.base_range,
                                params.total_sill)
    elif kt == KernelType.Laplacian:
        phi, grad = _inverse_power(ops, 1)
    elif kt == KernelType.OneOverR2:
        phi, grad = _inverse_power(ops, 2)
    elif kt == KernelType.OneOverR4:
        phi, grad = _inverse_power(ops, 4)
    else:
        raise ValueError(f"Unknown kernel type {kt}")
    return Kernel(phi, grad, xp, dtype)


def kernel_phi(r, params: KernelParams, xp=torch):
    """phi(r) of the configured kernel at distances ``r`` (float64)."""
    return make_kernel(params, xp).phi(r)
