"""Sketch database: serialization and the device key table."""

from .store import SketchIndex, index_to_device  # noqa: F401
