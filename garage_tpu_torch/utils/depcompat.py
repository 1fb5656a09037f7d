"""Optional-dependency fallbacks (environment robustness).

The codebase prefers real `zstandard` (and `cryptography`, handled in
`net/crypto_compat.py`) when installed, but must keep working — daemon,
tests, chaos harness — in stripped containers that only carry the Python
standard library.  Rules:

- `zstandard` missing -> a zlib-backed shim with the same 3-symbol API
  (`compress`, `decompress`, `ZstdError`) is registered in `sys.modules`
  under the name "zstandard", so late `import zstandard` statements in
  tests and tools resolve to it too.  The shim produces ZLIB streams, not
  zstd frames: every node of a cluster must run the same implementation
  (a mixed real-zstd / shim cluster would fail to decompress each other's
  blocks — exactly like running different zstd-incompatible versions).
  Block files written by the shim are therefore only readable by shim
  nodes, and vice versa; both directions fail loudly with `ZstdError`
  because zlib and zstd reject each other's magic.

Import this module for its side effect before (or instead of) importing
`zstandard`; `garage_tpu/__init__` does so at package import.
"""

from __future__ import annotations

import sys
import types
import zlib


def _make_zstd_shim() -> types.ModuleType:
    mod = types.ModuleType("zstandard")
    mod.__doc__ = (
        "zlib-backed stand-in for the real `zstandard` package "
        "(garage_tpu.utils.depcompat); wire/disk streams are ZLIB, "
        "interoperable only with other shim nodes."
    )

    class ZstdError(Exception):
        pass

    def compress(data: bytes, level: int = 3) -> bytes:
        # zstd levels 1..22 ~ map into zlib 1..9; clamp rather than error
        return zlib.compress(data, min(max(int(level), 1), 9))

    def decompress(data: bytes, max_output_size: int = 0) -> bytes:
        try:
            return zlib.decompress(data)
        except zlib.error as e:
            raise ZstdError(f"decompression error: {e}") from e

    mod.ZstdError = ZstdError
    mod.compress = compress
    mod.decompress = decompress
    mod.COMPAT_SHIM = True  # marker for introspection/tests
    return mod


def ensure_zstandard() -> types.ModuleType:
    """Import real zstandard if present, else install + return the shim."""
    try:
        import zstandard  # noqa: F401

        return zstandard
    except ImportError:
        pass
    mod = sys.modules.get("zstandard")
    if mod is None:
        mod = _make_zstd_shim()
        sys.modules["zstandard"] = mod
    return mod


ensure_zstandard()
