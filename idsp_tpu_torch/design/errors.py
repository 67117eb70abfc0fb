"""Parameter validation errors (reference src/iir/error.rs:5-16)."""

from __future__ import annotations


class DesignError(ValueError):
    """Builder parameter validation error with the reference's taxonomy."""

    def __init__(self, kind: str, name: str):
        self.kind = kind
        self.name = name
        super().__init__(f"{kind}: parameter `{name}`")

    @staticmethod
    def non_finite(name: str) -> "DesignError":
        return DesignError("NonFinite", name)

    @staticmethod
    def non_positive(name: str) -> "DesignError":
        return DesignError("NonPositive", name)

    @staticmethod
    def out_of_range(name: str) -> "DesignError":
        return DesignError("OutOfRange", name)
