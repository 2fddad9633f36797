"""Iterative solvers: FGMRES, multilevel Schwarz DDM, and the fit orchestration."""

from .domain import Domain

__all__ = ["Domain"]
