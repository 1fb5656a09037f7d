"""loop-blocker: blocking syscalls reachable from coroutines.

A synchronous `open`/`fsync`/`sleep` inside an `async def` stalls the
ONE event loop every concurrent request shares — on the EC data plane a
single fsync serializes the whole node (this is what kept
`event_loop_lag_seconds` fat under concurrent streamed GETs before the
block-file I/O moved to `asyncio.to_thread`).

Detection is call-graph-aware: a blocking call is reported when it is
made directly in a coroutine (async generators included), or inside a
sync helper reachable from one within ``MAX_DEPTH`` name-resolved hops
(``self._helper()`` / same-module / ``from .mod import helper``).
Functions only ever *passed* to ``asyncio.to_thread(...)`` (not called)
are correctly not reachable.

Suppression: ``# graft-lint: allow-blocking(<reason>)`` on the blocking
call's line (or the line above).  The pragma belongs at the blocking
call, where the next reader needs the justification.
"""

from __future__ import annotations

from .core import Project, Violation, iter_async_reachable

MAX_DEPTH = 2  # sync hops between the coroutine and the blocking call

# bare-name builtins that hit the disk
BLOCKING_NAMES = {"open"}

# dotted calls that block: sleep, file metadata/sync ops, subprocess,
# synchronous sockets, bulk file tree ops.  (`.read()`/`.write()` on file
# objects are covered by flagging the `open()` that produced them — every
# handle that can block was opened by a flagged call.)
BLOCKING_DOTTED = {
    "time.sleep",
    "os.fsync",
    "os.fdatasync",
    "os.replace",
    "os.rename",
    "os.makedirs",
    "os.mkdir",
    "os.remove",
    "os.unlink",
    "os.rmdir",
    "os.truncate",
    "socket.create_connection",
    "shutil.rmtree",
    "shutil.copyfile",
    "shutil.copy",
    "shutil.copytree",
    "shutil.move",
}

BLOCKING_PREFIXES = ("subprocess.",)


def _is_blocking(repr_: str) -> bool:
    if repr_ in BLOCKING_NAMES or repr_ in BLOCKING_DOTTED:
        return True
    return repr_.startswith(BLOCKING_PREFIXES)


def check(project: Project) -> list[Violation]:
    out: list[Violation] = []
    reported: set[tuple[str, str, int, str]] = set()

    for (mod, _qual), fn in project.functions.items():
        if not fn.is_async:
            continue
        # the shared loop-blocker-shaped reachability walk (core):
        # blocking callees are reported at every visited hop, sync
        # helpers are followed up to MAX_DEPTH, awaited coroutines get
        # their own pass as BFS roots
        for cur, chain, depth in iter_async_reachable(project, fn, MAX_DEPTH):
            sf = project.files[cur.module]
            for callee, line in cur.calls:
                if not _is_blocking(callee):
                    continue
                node = _call_node_at(sf, cur, callee, line)
                if node is not None and sf.pragma_for(node, "blocking"):
                    continue
                via = "" if depth == 0 else " via " + " -> ".join(chain[1:])
                detail = callee + ("|" + ">".join(chain[1:]) if depth else "")
                dedup = (cur.module, fn.qualname, line, callee)
                if dedup in reported:
                    continue
                reported.add(dedup)
                out.append(
                    Violation(
                        "loop-blocker", cur.module, line, fn.qualname,
                        detail,
                        f"blocking call {callee}() reachable from "
                        f"coroutine {fn.qualname}{via} — stalls the "
                        "event loop; offload with asyncio.to_thread "
                        "or suppress with "
                        "# graft-lint: allow-blocking(<reason>)",
                    )
                )
    return out


def _call_node_at(sf, fn, callee: str, line: int):
    """Find the Call AST node for (callee, line) so pragma placement can
    be checked against the real node extent."""
    import ast

    from .core import call_repr

    for node in ast.walk(fn.node):
        if (
            isinstance(node, ast.Call)
            and node.lineno == line
            and call_repr(node.func) == callee
        ):
            return node
    return None
