"""backend-gate: backend decisions must stay declared and observable.

A node that quietly falls back to the CPU path looks healthy: the code
compares device strings locally, decides quietly, and no metric records
which path served.  The telemetry plane (ops/telemetry.py
`resolved_platform`/`is_host_platform`/`runs_on_host`/`dispatch`, the codec layer's
`block_codec_*{path}` counters) exists so a node degraded to the CPU
path shows up as a rising `path="numpy"` share instead of staying
indistinguishable from healthy traffic.

Two sub-rules:

- **platform-compare** — a comparison against a backend string
  (``"cpu"``/``"cuda"``/``"gpu"``/…) on a platform/backend-ish value —
  a name or attribute containing "platform"/"backend"/"plat", or a
  tensor's or device's ``.device.type``/``dev.type`` — anywhere OUTSIDE
  the package's declared probe/telemetry module (``ops/telemetry.py``).
  Scattered string comparisons are how silent fallbacks breed: route
  the decision through the telemetry helpers so every gate shares one
  observable definition of "host backend", or pragma with the reason.

- **uncounted-codec-path** — a function in a ``/codec/`` module that
  dispatches to the device codec (calls a method on ``self._ec``, the
  block codec's CUDA codec) without counting ``block_codec_*{path}``
  (a ``_count``/``registry.incr("block_codec_…")`` call, directly or in
  a same-module callee one hop away).  An uncounted path is exactly the
  silent-CPU-fallback blind spot: the device-vs-host byte shares can't
  be compared if one side doesn't count.

Suppression: ``# graft-lint: allow-backend-gate(<reason>)`` on the
comparison / dispatch line (for uncounted-codec-path, the ``def`` line
also works).
"""

from __future__ import annotations

import ast

from .core import Project, Violation, call_repr, iter_nodes_with_owner
from .device_model import PLATFORM_STRINGS

RULE = "backend-gate"

# the declared probe/telemetry surface, inside the linted package:
# platform comparisons HERE are the single observable definition
# everything else should route through
ALLOWED_MODULES = {"ops/telemetry.py"}

_PLATFORMISH_MARKERS = ("platform", "backend", "plat")

# the block codec's attribute holding the CUDA codec
CODEC_RECEIVERS = ("self._ec.",)

COUNT_CALL_LASTS = {"_count"}
COUNT_INCR_LASTS = {"incr"}
CODEC_COUNTER_PREFIX = "block_codec_"


def _platform_string_of(node) -> str | None:
    """The backend string a comparator carries: a literal, or any
    literal inside a tuple/list/set comparator."""
    if isinstance(node, ast.Constant) and node.value in PLATFORM_STRINGS:
        return node.value
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for e in node.elts:
            s = _platform_string_of(e)
            if s is not None:
                return s
    return None


def _is_device_type(node) -> bool:
    """``<x>.device.type`` or ``<dev>.type``: the torch read of which
    backend a tensor or device is on."""
    if not (isinstance(node, ast.Attribute) and node.attr == "type"):
        return False
    v = node.value
    name = v.id if isinstance(v, ast.Name) else v.attr if isinstance(v, ast.Attribute) else ""
    return "dev" in name.lower()


def _mentions_platformish(node) -> bool:
    """Does the expression read something platform/backend-named — a
    name/attribute containing "platform"/"backend"/"plat", a string
    argument doing so (``os.environ.get("CUDA_PLATFORM")``), or a
    ``.device.type``?"""
    for sub in ast.walk(node):
        if _is_device_type(sub):
            return True
        ident = None
        if isinstance(sub, ast.Name):
            ident = sub.id
        elif isinstance(sub, ast.Attribute):
            ident = sub.attr
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            ident = sub.value
        if ident is not None and any(
            m in ident.lower() for m in _PLATFORMISH_MARKERS
        ):
            return True
    return False


def _check_platform_compares(project: Project) -> list[Violation]:
    out: list[Violation] = []
    allowed = {project.package_path(m) for m in ALLOWED_MODULES}
    for rel, sf in project.files.items():
        if rel in allowed:
            continue
        for node, owner in iter_nodes_with_owner(sf):
            if not isinstance(node, ast.Compare):
                continue
            comparators = [node.left] + list(node.comparators)
            plat = None
            for c in comparators:
                plat = _platform_string_of(c)
                if plat is not None:
                    break
            if plat is None:
                continue
            if not any(
                _mentions_platformish(c)
                for c in comparators
                if _platform_string_of(c) is None
            ):
                continue  # `k == "cuda"` over a config key: not a gate
            if sf.pragma_for(node, "backend-gate"):
                continue
            out.append(
                Violation(
                    RULE, rel, node.lineno, owner,
                    f"platform-compare:{plat}",
                    f"backend-string comparison against {plat!r} outside "
                    "the declared probe/telemetry module — scattered "
                    "gates are how silent CPU fallbacks breed; route "
                    "through ops.telemetry.resolved_platform/"
                    "is_host_platform/runs_on_host, or "
                    "# graft-lint: allow-backend-gate(<reason>)",
                )
            )
    return out


def _counts_codec_path(project: Project, fn) -> bool:
    """Does `fn` (or a same-resolution callee one hop down) count a
    block_codec_* family?"""

    def direct(f) -> bool:
        for node in ast.walk(f.node):
            if not isinstance(node, ast.Call):
                continue
            r = call_repr(node.func)
            if r is None:
                continue
            tail = r.rsplit(".", 1)[-1]
            if tail in COUNT_CALL_LASTS:
                return True
            if tail in COUNT_INCR_LASTS and node.args:
                a0 = node.args[0]
                if (
                    isinstance(a0, ast.Constant)
                    and isinstance(a0.value, str)
                    and a0.value.startswith(CODEC_COUNTER_PREFIX)
                ):
                    return True
        return False

    if direct(fn):
        return True
    for callee, _line in fn.calls:
        target = project.resolve_call(fn, callee)
        if target is not None and direct(target):
            return True
    return False


def _check_uncounted_codec_paths(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for (mod, _qual), fn in project.functions.items():
        if "/codec/" not in "/" + mod:
            continue
        if fn.qualname.rsplit(".", 1)[-1].startswith("__"):
            continue
        sf = project.files[mod]
        # dispatching = calling a METHOD on the device codec receiver
        dispatch_line = None
        for callee, line in fn.calls:
            if callee.startswith(CODEC_RECEIVERS):
                dispatch_line = line
                break
        if dispatch_line is None:
            continue
        if _counts_codec_path(project, fn):
            continue
        covered = sf.pragma_for(fn.node, "backend-gate")
        if not covered:
            # also accept the pragma on the dispatch line itself
            class _At:  # minimal node shim for pragma_for
                lineno = dispatch_line
                end_lineno = dispatch_line

            covered = sf.pragma_for(_At, "backend-gate")
        if covered:
            continue
        out.append(
            Violation(
                RULE, mod, dispatch_line, fn.qualname,
                f"uncounted-codec-path:{fn.qualname.rsplit('.', 1)[-1]}",
                f"{fn.qualname} dispatches to the device codec without "
                "counting block_codec_*{path} — a node degraded to the "
                "host path is invisible (the silent-fallback class); "
                "call _count(...) on every served path or "
                "# graft-lint: allow-backend-gate(<reason>)",
            )
        )
    return out


def check(project: Project) -> list[Violation]:
    out = _check_platform_compares(project)
    out.extend(_check_uncounted_codec_paths(project))
    out.sort(key=lambda v: (v.path, v.line, v.detail))
    return out
