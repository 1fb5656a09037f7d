"""cancel-safety: teardown paths that misbehave under task cancellation.

A cluster that loses acknowledged writes after a crash/restart, with
breakers pinned open, has the signature of a cancellation hazard: after
the restart,
acked writes go missing and breakers stay pinned open through the whole
convergence window — exactly what half-finished teardown produces.  This
family encodes the three asyncio cancellation traps that cause it:

**finally-await** — an ``await`` inside a ``finally:`` of a coroutine.
When the enclosing task is cancelled *while suspended inside the try
body*, Python delivers ``CancelledError`` again at the FIRST await the
finally block performs, so everything after it silently never runs (a
``_teardown`` that stops mid-way leaves RPC futures unresolved and
peers undialable).  Awaiting ``asyncio.shield(...)`` or
``utils.aio.reap(...)`` is exempt: shield completes the inner work
before the cancel re-raises, and reap is the sanctioned cancel-and-drain
primitive (it *propagates* an outer cancel by design, which is the
correct behavior — the hazard is plain awaits that silently vanish).

**cancelled-swallowed** — an ``except CancelledError:`` body with no
``raise``.  Swallowing the cancel makes the task complete "successfully"
(``task.cancelled()`` is False, ``await task`` returns), so a supervisor
that cancelled it for teardown believes work is still running — or
worse, the coroutine resumes a half-torn-down operation.  Re-raise after
cleanup, or carry a pragma explaining why completing-normally-on-cancel
is the contract (worker loops whose supervisor only ever awaits them).

**cancel-no-drain** — ``task.cancel()`` with no await/drain of that task
anywhere in the function.  ``cancel()`` only *requests* cancellation:
the task keeps running until the loop delivers it, so teardown returns
while the task still holds sockets/locks, and an exception raised during
its unwind is dropped.  Drain with ``await t`` / ``asyncio.gather`` /
``utils.aio.reap`` (or hand the batch to a drain helper).  Receivers
whose names look like timer handles or futures (``handle``/``timer``/
``fut``) are exempt — ``loop.call_later`` handles and futures cancel
synchronously and need no drain.

Suppression: ``# graft-lint: allow-cancel(<reason>)`` on the flagged
line (or the line above).
"""

from __future__ import annotations

import ast
import re

from .core import Project, Violation, call_repr
from .core import walk_no_defs as _walk_no_defs

RULE = "cancel-safety"

# awaits in a finally that are cancellation-correct by construction
SHIELDED_LASTS = {"shield", "reap"}

# cancel() receivers that are not tasks (no drain needed)
NO_DRAIN_RECV_RE = re.compile(r"handle|timer|fut", re.I)

# awaited helpers that drain cancelled tasks
DRAIN_LASTS = {"reap", "gather", "wait", "wait_for", "shield", "_drain", "drain"}


def _last(repr_: str) -> str:
    return repr_.rsplit(".", 1)[-1]


# nested-def walks use the shared core.walk_no_defs (imported above)


def _body_walk(fn_node):
    for stmt in fn_node.body:
        yield stmt
        yield from _walk_no_defs(stmt)


def _stmts_walk(stmts):
    """Like _body_walk over a statement list, skipping nested defs even
    when the def IS one of the seed statements."""
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield stmt
        yield from _walk_no_defs(stmt)


def _expr_repr(node) -> str | None:
    """Render a receiver expression: names, attribute chains, and
    subscripts (``st["task"]`` -> ``st[]``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _expr_repr(node.value)
        return f"{base}.{node.attr}" if base else None
    if isinstance(node, ast.Subscript):
        base = _expr_repr(node.value)
        return f"{base}[]" if base else None
    return None


def _root_name(node) -> str | None:
    """Leftmost Name of a receiver chain (``self._task`` -> ``self`` is
    useless — prefer the full dotted root for self-attrs)."""
    r = _expr_repr(node)
    if r is None:
        return None
    parts = r.replace("[]", "").split(".")
    if parts[0] in ("self", "cls") and len(parts) > 1:
        return parts[1]  # self._task -> match on "_task"
    return parts[0]


def check(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for (_mod, _qual), fn in project.functions.items():
        sf = project.files[fn.module]
        if fn.is_async:
            out.extend(_check_finally_awaits(sf, fn))
        out.extend(_check_cancelled_handlers(sf, fn))
        out.extend(_check_cancel_no_drain(sf, fn))
    return out


# --- finally-await ------------------------------------------------------------


def _check_finally_awaits(sf, fn) -> list[Violation]:
    out = []
    for node in _body_walk(fn.node):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        # note _stmts_walk: DEFINING a helper in the finally runs nothing
        for sub in _stmts_walk(node.finalbody):
            if not isinstance(sub, ast.Await):
                continue
            v = sub.value
            r = call_repr(v.func) if isinstance(v, ast.Call) else None
            if r is not None and _last(r) in SHIELDED_LASTS:
                continue
            if sf.pragma_for(sub, "cancel"):
                continue
            out.append(
                Violation(
                    RULE, fn.module, sub.lineno, fn.qualname,
                    f"finally-await:{r or '<expr>'}",
                    f"await {r or '<expr>'}(...) inside finally: a "
                    "cancel delivered in the try body re-raises at "
                    "this await and the REST of the finally never "
                    "runs — wrap in asyncio.shield(...), use "
                    "utils.aio.reap, or "
                    "# graft-lint: allow-cancel(<reason>)",
                )
            )
    return out


# --- cancelled-swallowed ------------------------------------------------------


def _mentions_cancelled(t) -> bool:
    if t is None:
        return False
    if isinstance(t, ast.Tuple):
        return any(_mentions_cancelled(e) for e in t.elts)
    return (isinstance(t, ast.Name) and t.id == "CancelledError") or (
        isinstance(t, ast.Attribute) and t.attr == "CancelledError"
    )


def _is_drain_of_other_task(try_node: ast.Try) -> bool:
    """True when the try body awaits a bare task/future expression
    (``await self._task`` — not a call): that is the CALLER draining a
    task it cancelled, where swallowing the task's CancelledError is
    the correct and standard pattern."""
    for sub in _stmts_walk(try_node.body):
        if isinstance(sub, ast.Await) and not isinstance(
            sub.value, ast.Call
        ):
            return True
    return False


def _check_cancelled_handlers(sf, fn) -> list[Violation]:
    out = []
    for try_node in _body_walk(fn.node):
        if not isinstance(try_node, ast.Try):
            continue
        for node in try_node.handlers:
            if not _mentions_cancelled(node.type):
                continue
            reraises = any(
                isinstance(sub, ast.Raise) for sub in _stmts_walk(node.body)
            )
            if reraises:
                continue
            if _is_drain_of_other_task(try_node):
                continue
            if sf.pragma_for(node, "cancel"):
                continue
            out.append(
                Violation(
                    RULE, fn.module, node.lineno, fn.qualname,
                    "cancelled-swallowed",
                    "except CancelledError body never re-raises: the "
                    "task completes 'successfully' under cancel, so "
                    "teardown believes it stopped while it may resume "
                    "half-done work — re-raise after cleanup or "
                    "# graft-lint: allow-cancel(<reason>)",
                )
            )
    return out


# --- cancel-no-drain ----------------------------------------------------------


def _check_cancel_no_drain(sf, fn) -> list[Violation]:
    # (call node, receiver repr, match-roots)
    cancels: list[tuple[ast.Call, str, set[str]]] = []
    await_names: set[str] = set()  # names appearing under any Await
    drain_arg_names: set[str] = set()  # names passed to drain helpers
    aliases: dict[str, set[str]] = {}  # assigned name -> names in its rhs

    def subtree_names(node) -> set[str]:
        return {
            n.id
            for n in ast.walk(node)
            if isinstance(n, ast.Name)
        } | {
            n.attr
            for n in ast.walk(node)
            if isinstance(n, ast.Attribute)
        }

    def visit(node, loop_roots: dict[str, str]):
        env = loop_roots
        if isinstance(node, (ast.For, ast.AsyncFor)) and isinstance(
            node.target, ast.Name
        ):
            itroot = _root_name(node.iter)
            if itroot:
                env = dict(loop_roots)
                env[node.target.id] = itroot
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(child, ast.Await):
                await_names.update(subtree_names(child))
            if isinstance(child, ast.Assign):
                # `waits = [t for t in tasks]`: a later drain of `waits`
                # covers `tasks` (one aliasing hop)
                for t in child.targets:
                    if isinstance(t, ast.Name):
                        aliases.setdefault(t.id, set()).update(
                            subtree_names(child.value)
                        )
            if (
                isinstance(child, ast.Call)
                and isinstance(child.func, ast.Attribute)
                and child.func.attr == "cancel"
                and not child.args
            ):
                recv = child.func.value
                r = _expr_repr(recv)
                root = _root_name(recv)
                if r is not None and root is not None:
                    if not NO_DRAIN_RECV_RE.search(r):
                        roots = {root}
                        if root in env:
                            roots.add(env[root])
                        cancels.append((child, r, roots))
            if isinstance(child, ast.Call):
                r = call_repr(child.func)
                if r is not None and _last(r) in DRAIN_LASTS:
                    drain_arg_names.update(subtree_names(child))
            visit(child, env)

    visit(fn.node, {})

    # expand drains/awaits through one aliasing hop
    for mentioned in (await_names, drain_arg_names):
        extra: set[str] = set()
        for name in mentioned:
            extra.update(aliases.get(name, ()))
        mentioned.update(extra)

    out = []
    for call, recv, roots in cancels:
        if roots & await_names or roots & drain_arg_names:
            continue
        if sf.pragma_for(call, "cancel"):
            continue
        out.append(
            Violation(
                RULE, fn.module, call.lineno, fn.qualname,
                f"cancel-no-drain:{recv}",
                f"{recv}.cancel() is never awaited/drained here: "
                "cancel() only REQUESTS cancellation — the task keeps "
                "running (holding sockets/locks) after this function "
                "returns and its unwind exceptions are dropped — drain "
                "via await/gather/utils.aio.reap or "
                "# graft-lint: allow-cancel(<reason>)",
            )
        )
    return out
