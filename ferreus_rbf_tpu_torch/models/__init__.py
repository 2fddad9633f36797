"""Interpolator models."""

from .global_trend import GlobalTrend, GlobalTrendTransform
from .rbf import Coefficients, RBFInterpolator
from .test_functions import RBFTestFunctions

__all__ = ["Coefficients", "GlobalTrend", "GlobalTrendTransform", "RBFInterpolator",
           "RBFTestFunctions"]
