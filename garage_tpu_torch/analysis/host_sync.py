"""host-sync: device→host synchronization points reachable from the loop.

``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
or ``float()``/``int()``/``bool()`` on a tensor on the card, and
``torch.cuda.synchronize()`` / ``Event.synchronize()`` /
``Stream.synchronize()``, all BLOCK the calling thread until the card
has finished everything queued before them and the copy is back.
Exactly like a synchronous fsync, one such call in a coroutine stalls
the single event loop every concurrent request shares; unlike fsync it
passes the loop-blocker silently because the blocking happens inside
torch, not a catalogued syscall.

This is the loop-blocker rule for the device boundary: a host-sync
point is reported when its function is an ``async def`` or reachable
from one within two name-resolved sync hops (same BFS as loop-blocker).
Functions only ever *passed* to ``asyncio.to_thread(...)`` are —
correctly — not reachable: the worker-thread hop is the approved remedy
(the codec batcher's dispatch path, ``block/codec_batch.py``).

Device-value evidence is positive-only (no type inference, see
device_model): a value is on the card when it comes from one of the
package's kernel wrappers, from ``.to(<device>)``/``.cuda()``/
``torch.*(..., device=...)``, or through simple assignments from
either.  ``.synchronize()`` only exists on CUDA objects and always
counts.

Suppression: ``# graft-lint: allow-host-sync(<reason>)`` on the sync
point's line — for sites where host materialization IS the design.
"""

from __future__ import annotations

import ast

from .core import Project, Violation, call_repr, iter_async_reachable
from .device_model import device_names, is_devish, is_host_copy, walk_no_defs

RULE = "host-sync"
MAX_DEPTH = 2  # sync hops between the coroutine and the sync point

# always host-syncs, whatever the receiver (torch.cuda.synchronize,
# Event.synchronize, Stream.synchronize)
ALWAYS_LASTS = {"synchronize"}

# scalar extractors: host-sync when the argument is on the card
SCALAR_BUILTINS = {"float", "bool", "int"}


def _sync_points(project: Project, fn) -> list[tuple[ast.Call, str]]:
    """(call_node, label) for every host-sync point made directly by
    `fn` (nested defs excluded — they don't run at def time)."""
    dev = device_names(project, fn)
    out: list[tuple[ast.Call, str]] = []
    for node in walk_no_defs(fn.node):
        if not isinstance(node, ast.Call):
            continue
        r = call_repr(node.func)
        tail = node.func.attr if isinstance(node.func, ast.Attribute) else r
        if tail in ALWAYS_LASTS and not node.args:
            out.append((node, tail))
            continue
        if is_host_copy(node):
            if is_devish(project, fn, node.func.value, dev):
                out.append((node, "to-cpu" if tail == "to" else tail))
            continue
        if r in SCALAR_BUILTINS and len(node.args) == 1:
            if is_devish(project, fn, node.args[0], dev):
                out.append((node, r))
    return out


def check(project: Project) -> list[Violation]:
    out: list[Violation] = []
    reported: set[tuple[str, str, int, str]] = set()
    points_cache: dict[tuple[str, str], list[tuple[ast.Call, str]]] = {}

    def points_of(fn):
        key = (fn.module, fn.qualname)
        if key not in points_cache:
            points_cache[key] = _sync_points(project, fn)
        return points_cache[key]

    for (_mod, _qual), fn in project.functions.items():
        if not fn.is_async:
            continue
        # the shared loop-blocker-shaped reachability walk (core)
        for cur, chain, depth in iter_async_reachable(project, fn, MAX_DEPTH):
            sf = project.files[cur.module]
            for node, label in points_of(cur):
                if sf.pragma_for(node, "host-sync"):
                    continue
                dedup = (cur.module, fn.qualname, node.lineno, label)
                if dedup in reported:
                    continue
                reported.add(dedup)
                via = "" if depth == 0 else " via " + " -> ".join(chain[1:])
                detail = label + ("|" + ">".join(chain[1:]) if depth else "")
                out.append(
                    Violation(
                        RULE, cur.module, node.lineno, fn.qualname, detail,
                        f"device->host sync point {label} reachable from "
                        f"coroutine {fn.qualname}{via} — blocks the event "
                        "loop until the card has drained its queue; "
                        "dispatch via asyncio.to_thread (codec-batcher "
                        "pattern) or # graft-lint: allow-host-sync(<reason>)",
                    )
                )
    out.sort(key=lambda v: (v.path, v.line, v.detail))
    return out
