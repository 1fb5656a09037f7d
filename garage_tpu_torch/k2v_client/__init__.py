"""K2V client library (reference src/k2v-client/lib.rs:67-341)."""

from .client import K2VClient, K2VError

__all__ = ["K2VClient", "K2VError"]
