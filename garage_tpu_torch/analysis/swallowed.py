"""swallowed-exception: `except Exception` handlers that hide errors.

A broad handler is legitimate exactly when the error still goes
SOMEWHERE a human or a metric can see.  A handler passes when its body:

  - re-raises (any ``raise``), or
  - logs (a call to .debug/.info/.warning/.error/.exception/.critical/
    .log on any receiver), or
  - counts a metric (.incr/.observe/.set_gauge/.record_failure), or
  - actually USES the bound exception (``except Exception as e`` where
    ``e`` is read — appended to an error list, formatted into a result,
    returned: the error is data, not discarded), or
  - carries ``# graft-lint: allow-swallow(<reason>)``.

Anything else — ``pass``, ``continue``, ``return None`` with the
exception unbound — is a silent swallow: each site either gains a
log/metric or an explicit reasoned pragma, and new ones fail tier-1.
"""

from __future__ import annotations

import ast

from .core import Project, Violation, iter_nodes_with_owner

LOG_ATTRS = {"debug", "info", "warning", "error", "exception", "critical", "log"}
METRIC_ATTRS = {"incr", "observe", "set_gauge", "record_failure", "note_error"}


def _catches_broad(handler: ast.ExceptHandler) -> bool:
    """True for `except Exception` (alone or in a tuple).  Narrow types
    and BaseException (deliberate, rare, usually re-raised) are out of
    scope."""

    def is_exc(node) -> bool:
        return (isinstance(node, ast.Name) and node.id == "Exception") or (
            isinstance(node, ast.Attribute) and node.attr == "Exception"
        )

    t = handler.type
    if t is None:
        return True  # bare `except:` is the broadest swallow of all
    if is_exc(t):
        return True
    if isinstance(t, ast.Tuple):
        return any(is_exc(el) for el in t.elts)
    return False


def _mitigated(handler: ast.ExceptHandler) -> bool:
    bound = handler.name
    for node in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in LOG_ATTRS or node.func.attr in METRIC_ATTRS:
                return True
        if (
            bound
            and isinstance(node, ast.Name)
            and node.id == bound
            and isinstance(node.ctx, ast.Load)
        ):
            return True  # the exception value flows onward as data
    return False


def check(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for rel, sf in project.files.items():
        for node, owner in iter_nodes_with_owner(sf):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _catches_broad(node):
                continue
            if _mitigated(node):
                continue
            if sf.pragma_for(node, "swallow"):
                continue
            out.append(
                Violation(
                    # several handlers in one function share a key; the
                    # baseline stores a count, so that stays exact
                    "swallowed-exception", rel, node.lineno, owner,
                    "swallow",
                    "except Exception body neither logs, re-raises, "
                    "counts a metric, nor uses the exception — add one "
                    "of those or "
                    "# graft-lint: allow-swallow(<reason>)",
                )
            )
    return out
