"""Utilities: metrics and device selection."""

from . import metrics  # noqa: F401
