"""Deterministic synthetic data (numpy; the port's own copy)."""
from .synthetic import TokenTask

__all__ = ["TokenTask"]
