"""lock-await: slow awaits while holding an asyncio mutex.

``asyncio.Lock`` is cooperative: every coroutine queued on it is stalled
for as long as the holder keeps it.  A holder that awaits an RPC (whose
latency is another node's problem), an unbounded ``Event.wait()``, a
``sleep``, or a thread-pool hop turns the lock into a cluster-wide
convoy — and when the awaited call can (transitively) need the same
lock, a deadlock.

Detection: ``async with <lock>`` where the context expression *names* a
lock (``lock``/``mutex`` in the final attribute/name, including
subscripted shards like ``self._locks[i]``; semaphores and conditions
are excluded — a semaphore is a capacity bound, not mutual exclusion,
and ``Condition.wait()`` releases its lock).  Inside the body, an
``await`` of:

  - an RPC-ish call (``.call`` / ``try_call_many`` / ``call_many`` /
    ``try_write_many_sets`` / ``.request``, or an awaited table
    ``.get``/``.insert`` — table ops quorum over the cluster), or
  - an unbounded wait (``.wait()``), a ``sleep``, a thread hop
    (``to_thread``), or a socket dial (``open_connection``), or
  - a call that *resolves* (name-based, constructor-attribute receivers
    included) into an async helper that makes an RPC-ish call within
    two hops

is a violation.  The per-prefix disk-write lock in ``block/manager.py``
is the known-intended case (shard serialization requires holding it
across the threaded write) and carries a reasoned pragma.

Suppression: ``# graft-lint: allow-lock-await(<reason>)`` on the
``async with`` line (covers the whole body) or on the offending await.
"""

from __future__ import annotations

import ast
import re

from .core import Project, Violation, call_repr
from .core import walk_no_defs as _walk_no_defs

RULE = "lock-await"

LOCK_RE = re.compile(r"lock|mutex", re.I)
EXCLUDE_RE = re.compile(r"cond|sem", re.I)

# awaited attribute calls that reach the network / quorum
RPC_LASTS = {
    "call",
    "call_many",
    "try_call_many",
    "try_write_many_sets",
    "call_streaming",
    "request",
    "get",
    "insert",
}
# awaited calls that park the holder for unbounded / foreign time
SLOW_LASTS = {"wait", "sleep", "to_thread", "open_connection"}

MAX_DEPTH = 2  # hops when resolving an awaited helper into an RPC call


def _last(repr_: str) -> str:
    return repr_.rsplit(".", 1)[-1]


# the shared skip-defs walker (core.walk_no_defs): a nested def's
# awaits belong to its own analysis


def _lock_name(ctx) -> str | None:
    """The lock's display name when `ctx` plainly names one."""
    node = ctx
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    else:
        return None
    if LOCK_RE.search(name) and not EXCLUDE_RE.search(name):
        return name
    return None


def _resolves_to_rpc(project: Project, fn, callee: str) -> str | None:
    """Does `callee`, resolved from `fn`, reach an RPC-ish call within
    MAX_DEPTH hops?  Returns the offending call repr, else None."""
    start = project.resolve_call(fn, callee)
    if start is None:
        return None
    queue = [(start, 0)]
    seen = {(start.module, start.qualname)}
    while queue:
        cur, depth = queue.pop(0)
        for sub, _line in cur.calls:
            if _last(sub) in RPC_LASTS and "." in sub:
                return sub
            if depth + 1 >= MAX_DEPTH:
                continue
            nxt = project.resolve_call(cur, sub)
            if nxt is None:
                continue
            key = (nxt.module, nxt.qualname)
            if key not in seen:
                seen.add(key)
                queue.append((nxt, depth + 1))
    return None


def check(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for (_mod, _qual), fn in project.functions.items():
        if not fn.is_async:
            continue
        sf = project.files[fn.module]
        for node in _walk_no_defs(fn.node):
            if not isinstance(node, ast.AsyncWith):
                continue
            locks = [
                n for n in (
                    _lock_name(item.context_expr) for item in node.items
                ) if n
            ]
            if not locks:
                continue
            lock = locks[0]
            if sf.pragma_for(node, "lock-await"):
                continue
            for sub in _walk_no_defs(node):
                if not isinstance(sub, ast.Await):
                    continue
                v = sub.value
                if not isinstance(v, ast.Call):
                    continue
                r = call_repr(v.func)
                if r is None:
                    continue
                last = _last(r)
                hazard = None
                if "." in r and last in RPC_LASTS:
                    hazard = f"rpc:{last}"
                elif last in SLOW_LASTS:
                    hazard = f"slow:{last}"
                else:
                    via = _resolves_to_rpc(project, fn, r)
                    if via is not None:
                        hazard = f"rpc-via:{last}->{_last(via)}"
                if hazard is None:
                    continue
                if sf.pragma_for(sub, "lock-await"):
                    continue
                out.append(
                    Violation(
                        RULE, fn.module, sub.lineno, fn.qualname,
                        f"{lock}:{hazard}",
                        f"await {r}(...) while holding {lock}: every "
                        "coroutine queued on the lock convoys behind "
                        "this RPC/wait (and a transitive re-acquire "
                        "deadlocks) — move the slow await outside the "
                        "critical section or "
                        "# graft-lint: allow-lock-await(<reason>) on "
                        "the async-with line",
                    )
                )
    return out
