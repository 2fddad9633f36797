"""Dense kernel matrix builders: the naive path and the FMM's oracle.

Port of ``ferreus_rbf_tpu/ops/dense.py``. ``xp=numpy`` builds host
matrices (the direct fit's local systems); ``dense_matvec`` and
``dense_matvec_with_gradients`` are the chunked tensor matvecs that serve
as the correctness oracles for the FMM.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.common import get_pointarray_extents
from .kernels import Kernel, KernelParams, make_kernel

__all__ = ["dense_matvec", "dense_matvec_with_gradients", "get_a_matrix",
           "get_a_matrix_symmetric_solver", "get_pointarray_extents"]


def get_a_matrix(target_points, source_points, params: KernelParams, xp=torch):
    """A[i, j] = phi(|t_i - s_j|), shape (M, N): a float64 tensor on the
    points' device (``xp=numpy``: a host array)."""
    return make_kernel(params, xp).pair(target_points, source_points)


def get_a_matrix_symmetric_solver(points, params: KernelParams, nugget: float = 0.0, xp=torch):
    """Symmetric A + nugget * I over one point set."""
    a = make_kernel(params, xp).pair(points, points)
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device) if xp is torch else np.eye(n)
    return a + nugget * eye


def dense_matvec(kernel: Kernel, targets, sources, weights, chunk: int = 4096):
    """y = K @ w without materialising K, chunked over targets.

    ``targets`` (M, d), ``sources`` (N, d) and ``weights`` (N, nrhs) are
    tensors on one device; the result is (M, nrhs) in ``kernel.dtype``.
    """
    sources = sources.to(kernel.dtype)
    weights = weights.to(kernel.dtype)
    out = [
        kernel.pair(targets[s : s + chunk], sources) @ weights
        for s in range(0, targets.shape[0], chunk)
    ]
    return torch.cat(out)


def dense_matvec_with_gradients(kernel: Kernel, targets, sources, weights, chunk: int = 4096):
    """(y, g) with y = K @ w and g[i, rhs * d + k] = sum_j w[j, rhs] *
    d phi / d t_k (t_i - s_j), chunked over targets.

    ``targets`` (M, d), ``sources`` (N, d) and ``weights`` (N, nrhs) are
    tensors on one device; y is (M, nrhs) and g (M, nrhs * d) in
    ``kernel.dtype``, g rhs-major and dim-minor (the FMM's layout).
    """
    sources = sources.to(kernel.dtype)
    weights = weights.to(kernel.dtype)
    vals, grads = [], []
    for s in range(0, targets.shape[0], chunk):
        k, g = kernel.pair_with_grad(targets[s : s + chunk], sources)
        vals.append(k @ weights)
        grads.append(torch.einsum("mnd,nr->mrd", g, weights).flatten(1))
    return torch.cat(vals), torch.cat(grads)
