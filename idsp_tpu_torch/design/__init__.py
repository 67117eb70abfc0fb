"""Coefficient design (the subset the DDC chain uses)."""

from .coefficients import Filter  # noqa: F401
from .errors import DesignError  # noqa: F401

__all__ = ["DesignError", "Filter"]
