"""Common error type."""

from __future__ import annotations


class Error(Exception):
    """Base error for garage_tpu_torch internals."""
