"""Chebyshev interpolation operators for the BBFMM.

Maps ``ferreus_bbfmm/src/chebyshev.rs`` (operator construction):

* first-kind Chebyshev nodes/polynomials and the S_p interpolation kernel
  S_p(x, y) = 1/p + (2/p) * sum_{k=1..p-1} T_k(x) T_k(y),
* parent<->child transfer (M2M/L2L) tensors via Kronecker products,
* batched tensor-product anterpolation weights (P2M/L2P) with optional
  physical-coordinate gradients.

Copy of ``ferreus_rbf_tpu/ops/fmm/cheb.py``: one-off host precompute in
numpy, plus :func:`anterpolation_weights_torch`, the batched tensor twin
that builds the P2M/L2P weights on the device.

References: Fong & Darve 2009 (JCP 228); Messner/Bramas/Coulaud/Darve 2012.
"""

from __future__ import annotations

import numpy as np
import torch


def chebyshev_nodes(p: int) -> np.ndarray:
    """p first-kind Chebyshev nodes in (-1, 1), ascending."""
    i = np.arange(p - 1, -1, -1, dtype=np.float64)
    return np.cos(np.pi * (i + 0.5) / p)


def chebyshev_polynomials(x, p: int, xp=np, with_derivatives: bool = False):
    """T (n, p): T_k(x_i); optionally dT (n, p) via the coupled recurrence.

    T_0 = 1, T_1 = x, T_{k+1} = 2x T_k - T_{k-1};
    T'_0 = 0, T'_1 = 1, T'_{k+1} = 2 T_k + 2x T'_k - T'_{k-1}.
    """
    x = xp.asarray(x)
    if x.dtype not in (xp.float32, xp.float64):
        x = x.astype(xp.float64)
    cols = [xp.ones_like(x)]
    dcols = [xp.zeros_like(x)] if with_derivatives else None
    if p > 1:
        cols.append(x)
        if with_derivatives:
            dcols.append(xp.ones_like(x))
    for k in range(2, p):
        cols.append(2.0 * x * cols[k - 1] - cols[k - 2])
        if with_derivatives:
            dcols.append(2.0 * cols[k - 1] + 2.0 * x * dcols[k - 1] - dcols[k - 2])
    t = xp.stack(cols, axis=-1)
    if with_derivatives:
        return t, xp.stack(dcols, axis=-1)
    return t, None


def interpolation_matrix(x, nodes_t: np.ndarray, xp=np):
    """S (n, p): S_p(x_i, node_j) = (2 T(x_i) . T(node_j) - 1) / p.

    ``nodes_t`` is the (p, p) matrix T_k(node_j) (precomputed once).
    """
    p = nodes_t.shape[0]
    t, _ = chebyshev_polynomials(x, p, xp=xp)
    return (2.0 * (t @ xp.asarray(nodes_t).T) - 1.0) / p


def interpolation_matrix_with_derivative(x, nodes_t: np.ndarray, xp=np):
    """(S, dS/dx) in the reference coordinate x in [-1, 1]."""
    p = nodes_t.shape[0]
    t, dt = chebyshev_polynomials(x, p, xp=xp, with_derivatives=True)
    s = (2.0 * (t @ xp.asarray(nodes_t).T) - 1.0) / p
    ds = (2.0 / p) * (dt @ xp.asarray(nodes_t).T)
    return s, ds


def nodes_tensor_product(nodes: np.ndarray, d: int) -> np.ndarray:
    """(p^d, d) tensor grid; first axis varies SLOWEST (row-major multi-index).

    Multi-index order matches the reference's ``cartesian_product``
    (``utils.rs:123-134``): column j cycles with period p^(d-1-j).
    """
    p = nodes.shape[0]
    grids = np.meshgrid(*([nodes] * d), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def child_offsets(d: int) -> np.ndarray:
    """(2^d, d) binary child offsets; bit j of the child index is dim j."""
    n = 1 << d
    return np.array([[(i >> j) & 1 for j in range(d)] for i in range(n)], dtype=np.int64)


def m2m_transfer_matrices(p: int, d: int) -> np.ndarray:
    """(2^d, p^d, p^d) child->parent multipole transfer operators.

    Child c's operator is the Kronecker product over dims of the 1D
    parent->child interpolation matrix halves, transposed
    (``chebyshev.rs:146-241``).
    """
    nodes = chebyshev_nodes(p)
    nodes_t, _ = chebyshev_polynomials(nodes, p)
    # child nodes in parent coords: (node -+ 1)/2
    lo = (nodes - 1.0) * 0.5
    hi = (nodes + 1.0) * 0.5
    s_lo = interpolation_matrix(lo, nodes_t)  # (p, p)
    s_hi = interpolation_matrix(hi, nodes_t)
    offsets = child_offsets(d)
    out = np.empty(((1 << d), p**d, p**d))
    for c in range(1 << d):
        m = None
        for j in range(d):
            part = s_hi if offsets[c, j] else s_lo
            m = part if m is None else np.kron(m, part)
        out[c] = m.T
    return out


def anterpolation_weights(points, center, length, nodes_t: np.ndarray, d: int, xp=np,
                          with_gradients: bool = False):
    """Tensor-product interpolation weights of points onto a cell's node grid.

    Batched version of ``get_approximation_coefficients``
    (``chebyshev.rs:831-927``): ``points`` (..., n, d) are scaled into the
    cell's [-1, 1]^d frame, 1D S rows are combined by an outer product over
    dims. Returns W (..., n, p^d) and, if requested, dW (..., n, d, p^d)
    in *physical* coordinates (chain rule factor 2/length).

    ``center``/``length`` may be scalars or broadcastable batch arrays.
    """
    p = nodes_t.shape[0]
    pts = xp.asarray(points)
    if pts.dtype not in (xp.float32, xp.float64):
        pts = pts.astype(xp.float64)
    center = xp.asarray(center, dtype=pts.dtype)
    length = xp.asarray(length, dtype=pts.dtype)
    scaled = (pts - center[..., None, :]) / (length[..., None, None] * 0.5)

    s_per_dim = []
    ds_per_dim = []
    for dim in range(d):
        if with_gradients:
            s, ds = interpolation_matrix_with_derivative(scaled[..., dim], nodes_t, xp=xp)
            ds = ds * (2.0 / length)[..., None, None]
            ds_per_dim.append(ds)
        else:
            s = interpolation_matrix(scaled[..., dim], nodes_t, xp=xp)
        s_per_dim.append(s)

    w = s_per_dim[0]
    for dim in range(1, d):
        # outer product over the node axes, flattened row-major
        w = w[..., :, None] * s_per_dim[dim][..., None, :]
        w = w.reshape(*w.shape[:-2], w.shape[-2] * w.shape[-1])

    if not with_gradients:
        return w, None

    grads = []
    for g in range(d):
        wg = None
        for dim in range(d):
            part = ds_per_dim[dim] if dim == g else s_per_dim[dim]
            if wg is None:
                wg = part
            else:
                wg = wg[..., :, None] * part[..., None, :]
                wg = wg.reshape(*wg.shape[:-2], wg.shape[-2] * wg.shape[-1])
        grads.append(wg)
    dw = xp.stack(grads, axis=-2)  # (..., n, d, p^d)
    return w, dw


def scale_nodes_to_cell(nodes_nd: np.ndarray, center, length, xp=np):
    """Map the reference node grid into a cell: center + (length/2) * node."""
    nodes_nd = xp.asarray(nodes_nd)
    center = xp.asarray(center, dtype=xp.float64)
    length = xp.asarray(length, dtype=xp.float64)
    return center[..., None, :] + (length[..., None, None] * 0.5) * nodes_nd


def anterpolation_weights_torch(points, center, length, nodes_t, d: int,
                                with_gradients: bool = False, values: bool = True):
    """Tensor twin of :func:`anterpolation_weights`.

    ``points`` (..., n, d), ``center`` (..., d), ``length`` (...,) and
    ``nodes_t`` (p, p) are tensors on one device and of one dtype. Returns
    W (..., n, p^d), node axes flattened row-major like the numpy version;
    with ``with_gradients`` the pair ``(W, dW)``, dW (..., n, d, p^d) in
    physical coordinates (chain-rule factor 2/length), and W None when
    ``values`` is False.
    """
    p = nodes_t.shape[0]
    scaled = (points - center[..., None, :]) / (length[..., None, None] * 0.5)
    s_dim, ds_dim = [], []
    for dim in range(d):
        x = scaled[..., dim]
        cols = [torch.ones_like(x)]
        dcols = [torch.zeros_like(x)]
        if p > 1:
            cols.append(x)
            dcols.append(torch.ones_like(x))
        for k in range(2, p):
            cols.append(2.0 * x * cols[k - 1] - cols[k - 2])
            if with_gradients:
                dcols.append(2.0 * cols[k - 1] + 2.0 * x * dcols[k - 1] - dcols[k - 2])
        s_dim.append((2.0 * (torch.stack(cols, dim=-1) @ nodes_t.T) - 1.0) / p)
        if with_gradients:
            ds = (2.0 / p) * (torch.stack(dcols, dim=-1) @ nodes_t.T)
            ds_dim.append(ds * (2.0 / length)[..., None, None])

    def outer(parts):
        w = parts[0]
        for part in parts[1:]:
            w = (w[..., :, None] * part[..., None, :]).flatten(-2)
        return w

    if not with_gradients:
        return outer(s_dim)
    w = outer(s_dim) if values else None
    dw = torch.stack([outer([ds_dim[i] if i == g else s_dim[i] for i in range(d)])
                      for g in range(d)], dim=-2)
    return w, dw
