"""Compute ops: kernels, dense kernel matrices, polynomial bases, FMM."""

from .dense import get_a_matrix, get_a_matrix_symmetric_solver
from .kernels import (
    SPHEROIDAL_CONSTANTS,
    Kernel,
    KernelParams,
    KernelType,
    SpheroidalConstants,
    kernel_phi,
    make_kernel,
)

__all__ = [
    "Kernel",
    "KernelParams",
    "KernelType",
    "SPHEROIDAL_CONSTANTS",
    "SpheroidalConstants",
    "get_a_matrix",
    "get_a_matrix_symmetric_solver",
    "kernel_phi",
    "make_kernel",
]
