"""Numerics backend: PSD-safe linalg, blocked Cholesky and solves."""

from . import blocked, linalg  # noqa: F401
