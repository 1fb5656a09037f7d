"""orphan-task: fire-and-forget create_task/ensure_future.

The event loop holds only a WEAK reference to tasks: an unanchored task
can be garbage-collected mid-flight, and when it fails nobody retrieves
the exception — it surfaces (if at all) as a useless "Task exception was
never retrieved" at interpreter exit.  A spawn is fine when its handle
is stored, awaited, passed on, or given a done-callback; the bare
statement form is the hazard:

    asyncio.create_task(self._ping(p))        # orphan
    t = asyncio.create_task(...)              # fine (stored)
    tasks.append(asyncio.create_task(...))    # fine (stored)
    await asyncio.create_task(...)            # fine (awaited)

Fix: route through ``utils.aio.spawn_supervised`` (logs the
exception with trace correlation, keeps a strong reference, unregisters
on completion), or suppress with
``# graft-lint: allow-orphan-task(<reason>)``.
"""

from __future__ import annotations

import ast

from .core import Project, Violation, call_repr, iter_nodes_with_owner

SPAWN_ATTRS = {"create_task", "ensure_future"}


def _is_spawn(call: ast.Call) -> bool:
    r = call_repr(call.func)
    if r is None:
        return False
    return r.rsplit(".", 1)[-1] in SPAWN_ATTRS


def check(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for rel, sf in project.files.items():
        for stmt, owner in iter_nodes_with_owner(sf):
            if not isinstance(stmt, ast.Expr):
                continue
            call = stmt.value
            if not isinstance(call, ast.Call) or not _is_spawn(call):
                continue
            if sf.pragma_for(call, "orphan-task"):
                continue
            spawn_name = call_repr(call.func)
            out.append(
                Violation(
                    "orphan-task", rel, call.lineno, owner,
                    spawn_name or "create_task",
                    f"{spawn_name}(...) result discarded: the task can "
                    "be GC'd mid-flight and its exception is dropped — "
                    "use utils.aio.spawn_supervised(coro, name) or "
                    "store/await the handle",
                )
            )
    return out
