"""Overlapping Schwarz preconditioner over the DDM hierarchy.

Port of ``ferreus_rbf_tpu/solver/schwarz.py``: restricted additive Schwarz
within each fine level (all leaf domains solved on the current residual,
only internal-point coefficients scattered back), multiplicative between
levels, with the coarse level smoothing after every fine level and
contributing the polynomial tail only on the last pass; fine-level
corrections are orthogonalised against the global thin-Q polynomial basis
so the P^T lambda = 0 constraint is preserved.
"""

from __future__ import annotations

from ..interpolant_config import InterpolantSettings
from ..utils.timing import traced_stage
from .ddm import DDMTree


def schwarz_preconditioner(
    rg,
    ddm_tree: DDMTree,
    matvec_partial,
    interpolant_settings: InterpolantSettings,
    ortho_poly,
    solve_coarse=None,
):
    """Apply the multilevel Schwarz preconditioner to residual ``rg``.

    ``matvec_partial(weights, level_key)`` computes the system operator
    restricted to one level's target rows (full-size output, zeros
    elsewhere). ``ortho_poly`` is the thin-Q polynomial basis (tensor) or
    None without drift. ``solve_coarse(residual, add_poly)`` is the coarse
    solve, by default the tree's host solve (the fused solver passes its
    solve on the device). The application is the tracer stage
    ``schwarz_apply``, its restricted matvecs inside it.
    """
    with traced_stage("schwarz_apply"):
        solve_coarse = solve_coarse or ddm_tree.solve_coarse
        sl = rg.new_zeros(rg.shape)
        coarse_idx = len(ddm_tree.levels) - 1
        if coarse_idx == 0:
            return sl + solve_coarse(rg, add_poly=True)
        for i in range(coarse_idx):
            # matvec(0) == 0: skip the first restricted matvec
            res = rg if i == 0 else rg - matvec_partial(sl, i)
            s1 = ddm_tree.solve_fine_level(i, res)
            if interpolant_settings.basis_size != 0:
                n = s1.shape[0] - interpolant_settings.basis_size
                s1[:n] -= ortho_poly @ (ortho_poly.T @ s1[:n])
            sl = sl + s1
            res = rg - matvec_partial(sl, "coarse")
            sl = sl + solve_coarse(res, add_poly=(i == coarse_idx - 1))
        return sl
