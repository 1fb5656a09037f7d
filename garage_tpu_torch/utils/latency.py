"""Latency phase catalogue and `phase_span`.

The codec batcher brackets each request's queue time (`codec_batch_wait`)
and its dispatch (`encode` / `decode`) in phase spans from a CLOSED
catalogue (the reference's, cut to the phases this package records),
so the `{op,phase}` label space stays bounded.  This package
has no span tracer yet, so a span is the no-op the reference's
`phase_span` returns while tracing is off; the catalogue check still
runs, so an unknown phase name fails here as it would there.
"""

from __future__ import annotations

import contextlib

PHASES = (
    "codec_batch_wait",  # queue time in the codec batcher before dispatch
    "encode",       # EC piece encoding
    "decode",       # EC decode
)
_PHASE_SET = frozenset(PHASES)


def phase_span(name: str):
    """A `phase:<name>` span from the fixed catalogue."""
    if name not in _PHASE_SET:
        raise ValueError(f"phase {name!r} not in the catalogue")
    return contextlib.nullcontext()
