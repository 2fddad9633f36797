"""A plain kernel sum in float64 torch: sum_j w_jc phi(|t - s_j|) at every
target t and for every column c of the weights, written from the published
kernel definitions (upstream ferreus_rbf's kernel registry and its
standalone ferreus_bbfmm). It imports torch and numpy only: neither JAX nor
any kernel of the package under test.

``kernel`` is a dict: ``{"type": "Linear"}`` (phi(r) = -r),
``{"type": "ThinPlateSpline"}`` (r^2 ln r, 0 at r = 0),
``{"type": "Cubic"}`` (r^3), ``{"type": "Spheroidal", "order": 3, 5, 7 or
9, "base_range": a, "total_sill": s}``, or one of the standalone FMM's
``{"type": "Laplacian"}`` (1 / r), ``{"type": "OneOverR2"}`` (1 / r^2) and
``{"type": "OneOverR4"}`` (1 / r^4), each 0 at r = 0. Points have 1, 2 or 3
columns.
"""

from __future__ import annotations

import numpy as np
import torch

# true float64 sums: no TF32 anywhere on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (inflexion point, linear slope, range scaling, inverse y-intercept) of the
# spheroidal kernels, as upstream ferreus_rbf publishes them
SPHEROIDAL = {3: (0.5000000000, 0.7500000000, 2.6798340586, 0.8734640537),
              5: (0.4082482905, 1.0206207262, 1.5822795750, 0.8575980168),
              7: (0.3535533906, 1.2374368671, 1.2008676644, 0.8494862533),
              9: (0.3162277660, 1.4230249471, 1.0000000000, 0.8445585690)}

# the singular kernels of the standalone FMM: phi(r) = r^-power, 0 at r = 0
INVERSE_POWER = {"Laplacian": 1, "OneOverR2": 2, "OneOverR4": 4}

# elements of one (target rows, sources) distance block
BLOCK_ELEMENTS = 2**27


def phi(kernel: dict, r: torch.Tensor) -> torch.Tensor:
    """phi(r) elementwise, in r's dtype."""
    kind = kernel["type"]
    if kind == "Linear":
        return -r
    if kind == "ThinPlateSpline":
        live = r > 0
        return torch.where(live, r * r * torch.log(torch.where(live, r, torch.ones_like(r))),
                           torch.zeros_like(r))
    if kind == "Cubic":
        return r * r * r
    if kind == "Spheroidal":
        ip, slope, scaling, inv_y = SPHEROIDAL[kernel["order"]]
        sill = kernel["total_sill"]
        sr = r * (scaling / kernel["base_range"])
        near = sill - sill * slope * sr
        far = (sill * inv_y) * (1.0 + sr * sr) ** (-kernel["order"] / 2.0)
        return torch.where(sr <= ip, near, far)
    if kind in INVERSE_POWER:
        live = r > 0
        return torch.where(live, torch.where(live, r, torch.ones_like(r))
                           ** -INVERSE_POWER[kind], torch.zeros_like(r))
    raise ValueError(f"the reference has no kernel {kind!r}")


def kernel_sum(kernel, sources, weights, targets, *, device="cpu") -> np.ndarray:
    """sum_j w_jc phi(|t - s_j|) for sources (n, d), weights (n, k) or (n,)
    and targets (m, d), summed in float64 on ``device`` in blocks of target
    rows; a float64 host array (m, k), or (m,) for 1-D weights."""
    src = torch.as_tensor(np.asarray(sources, np.float64), device=device)
    w = torch.as_tensor(np.asarray(weights, np.float64), device=device)
    cols = w.reshape(src.shape[0], -1)
    tgt = torch.as_tensor(np.asarray(targets, np.float64), device=device)
    rows = max(1, BLOCK_ELEMENTS // max(1, src.shape[0]))
    out = [phi(kernel, torch.cdist(tgt[i:i + rows], src,
                                   compute_mode="donot_use_mm_for_euclid_dist")) @ cols
           for i in range(0, tgt.shape[0], rows)]
    sums = torch.cat(out) if out else tgt.new_zeros((0, cols.shape[1]))
    sums = sums.cpu().numpy()
    return sums[:, 0] if w.ndim == 1 else sums
