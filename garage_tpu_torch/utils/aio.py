"""Supervised asyncio task helpers.

The event loop holds only WEAK references to tasks: a fire-and-forget
``asyncio.create_task(...)`` can be garbage-collected mid-flight, and if
it fails the exception is dropped (surfacing — at best — as a "Task
exception was never retrieved" at interpreter shutdown, long after the
damage).  Every background spawn in the tree goes through
:func:`spawn_supervised` instead: the handle is anchored in a
process-wide registry until completion, and a failure is logged through
the correlated logger (``utils/log_fmt.py`` stamps trace_id/span_id on
the record, so a crashed ping task still points at its trace).

:func:`reap` is the shutdown-side counterpart: cancel-and-drain a batch
of tasks, consuming their results so abandoned exceptions are logged at
debug instead of leaking warnings.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Iterable

logger = logging.getLogger("garage.aio")

# strong references: the loop's own task set is a WeakSet
_supervised: set[asyncio.Task] = set()


def _on_done(task: asyncio.Task) -> None:
    _supervised.discard(task)
    if task.cancelled():
        return
    exc = task.exception()  # also marks the exception as retrieved
    if exc is not None:
        logger.error(
            "background task %r crashed: %r", task.get_name(), exc,
            exc_info=exc,
        )


def spawn_supervised(coro, name: str | None = None) -> asyncio.Task:
    """``create_task`` with a lifecycle: strong reference until the task
    completes, unregistered on completion, exception logged (with trace
    correlation) instead of dropped.  Cancellation is a normal outcome
    and logs nothing."""
    t = asyncio.create_task(coro, name=name)
    _supervised.add(t)
    t.add_done_callback(_on_done)
    return t


def supervised_count() -> int:
    """Live supervised tasks (tests assert the registry drains)."""
    return len(_supervised)


async def reap(
    tasks: Iterable[asyncio.Task | None],
    *,
    log: logging.Logger = logger,
    what: str = "task",
) -> None:
    """Cancel and drain `tasks`, consuming every outcome: cancellation
    is the expected result; a real exception from an abandoned task is
    diagnostic, not actionable — logged at debug, never raised.  Tasks
    that already finished get their exception retrieved too (no
    'exception was never retrieved' noise from e.g. a quorum wait that
    returned before a straggler failed).

    Drains via gather so (a) stragglers are awaited CONCURRENTLY —
    teardown costs the slowest cancel path, not the sum — and (b) a
    cancel aimed at the CALLER propagates: gather re-raises when the
    enclosing task is cancelled, while each child's own CancelledError
    is just a result row (a bare `except CancelledError` around
    per-task awaits would eat the caller's cancellation and let a
    cancelled long-poll handler keep running)."""
    tasks = [t for t in tasks if t is not None]
    for t in tasks:
        if not t.done():
            t.cancel()
    cur = asyncio.current_task()
    waits = [t for t in tasks if t is not cur]
    if not waits:
        return
    results = await asyncio.gather(*waits, return_exceptions=True)
    for t, r in zip(waits, results):
        if isinstance(r, asyncio.CancelledError):
            continue
        if isinstance(r, BaseException):
            log.debug("reaped %s %r: %r", what, t.get_name(), r)
