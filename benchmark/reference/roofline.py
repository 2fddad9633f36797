"""The least time of one near-field call, from its operands.

Frozen copy of ``PEAK_FLOPS``, ``HBM_BYTES_S``, ``PHI_FLOPS``, ``G_FLOPS``
and ``near_field_bound`` in ``chip_smoke.py`` at commit 581daba: live
(target, source) pairs times flops per pair over the card's published
non-tensor peak, against each operand's bytes read once and each output
written once over the HBM rate; the larger of the two is the least time.
Only live pairs count (a row's real targets times the real sources of each
tile or cell it lists before its count; sentinel and padded slots never),
so any implementation of the same tree reads the same work.

Everything stays on the operands' device, with no host sync: a call
captured into a CUDA graph adds its work again on every replay.
"""

from __future__ import annotations

import torch

# H100 SXM published peaks (NVIDIA data sheet): non-tensor FLOP/s by type and
# HBM3 bytes/s, at the full 700 W power limit
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
HBM_BYTES_S = 3.35e12
# Flops per (target, source) pair of phi and of the gradient factor g,
# counting a sqrt, log or divide as ONE flop and an FMA as two; spheroidal
# counts its cheaper (near) branch
PHI_FLOPS = {"LinearRbf": 1, "ThinPlateSplineRbf": 3, "CubicRbf": 2, "Spheroidal3Rbf": 3,
             "Spheroidal5Rbf": 3, "Spheroidal7Rbf": 3, "Spheroidal9Rbf": 3,
             "Laplacian": 2, "OneOverR2": 1, "OneOverR4": 2}
G_FLOPS = {"LinearRbf": 1, "ThinPlateSplineRbf": 2, "CubicRbf": 1, "Spheroidal3Rbf": 1,
           "Spheroidal5Rbf": 1, "Spheroidal7Rbf": 1, "Spheroidal9Rbf": 1,
           "Laplacian": 2, "OneOverR2": 2, "OneOverR4": 3}


def _nbytes(tensors):
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def least_seconds(kernel_name, tgt, table, cnt, tcnt, slive, sentinel, nrhs, operands, grad):
    """The least time (a 0-d float64 tensor on ``tgt``'s device) of a call
    over targets ``tgt`` (R, T, d) and the (U, R) ``table`` of tiles or
    cells: entry u of row r is live where u < cnt[r] and it is not the
    ``sentinel``; it brings ``slive[entry]`` sources (a tensor) or ``slive``
    sources (an int). ``operands`` are every input tensor the call reads."""
    u, rows = table.shape
    live = table != sentinel
    if cnt is not None:
        live &= torch.arange(u, device=table.device)[:, None] < cnt[None, :].long()
    if isinstance(slive, int):
        per_row = live.sum(0, dtype=torch.float64) * slive
    else:
        per_row = (slive.double()[table.long().clamp(max=slive.shape[0] - 1)] * live).sum(0)
    tlive = tcnt.double() if tcnt is not None else torch.full_like(per_row, float(tgt.shape[1]))
    pairs = (per_row * tlive).sum()
    d = tgt.shape[2]
    per_pair = 8 + PHI_FLOPS[kernel_name] + 2 * nrhs  # 3 sub + 1 mul + 2 FMA = 8
    if grad:
        per_pair += G_FLOPS[kernel_name] + 3 + 2 * d * nrhs  # g * diff, d more FMAs per rhs
    out_elems = tgt.shape[0] * tgt.shape[1] * nrhs * (1 + (d if grad else 0))
    nbytes = _nbytes(operands) + out_elems * tgt.element_size()
    return torch.clamp(pairs * (per_pair / PEAK_FLOPS[tgt.dtype]), min=nbytes / HBM_BYTES_S)


def tiles_call(kernel_name, tgt, src, w, nbr, cnt, tcnt, scnt, grad):
    """``near_field(_grad)(tgt, src, w, nbr, cnt, tcnt=, scnt=)``: tiles of
    ``src`` (L1, d, S) with weights ``w`` (L1, nrhs, S); the last tile is
    the zero sentinel; ``scnt`` (L1,) live sources per tile."""
    l1, _, s = src.shape
    slive = scnt if scnt is not None else s
    return least_seconds(kernel_name, tgt, nbr, cnt, tcnt, slive, l1 - 1, w.shape[1],
                         (tgt, src, w, nbr, cnt, tcnt, scnt), grad)


def cells_call(kernel_name, tgt, cells, cnt, centers, lengths, nodes_nd, mult, tcnt, grad):
    """``near_field_cells(_grad)``: every listed cell brings its p^d nodes;
    the sentinel is the number of cells."""
    return least_seconds(kernel_name, tgt, cells, cnt, tcnt, nodes_nd.shape[0],
                         centers.shape[0], mult.shape[2],
                         (tgt, cells, cnt, centers, lengths, nodes_nd, mult, tcnt), grad)
