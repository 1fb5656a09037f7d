"""Data model: table schemas + the Garage composition root
(reference src/model/)."""

from .garage import Garage

__all__ = ["Garage"]
