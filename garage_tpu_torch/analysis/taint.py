"""trust-boundary: pre-auth / peer-supplied values reaching a sink raw.

This class of bug was once closed by hand: a claimed ``Credential=`` key id
(parsed BEFORE SigV4 verification) flowed into per-tenant metric labels,
where one ``"`` would have corrupted the whole Prometheus exposition and
made the node metrics-dark.  The same trust boundary is crossed by
gossiped telemetry digests and peer status payloads — any value a peer
or an unauthenticated client controls.  This rule makes the boundary
mechanical instead of tribal knowledge.

**Source catalogue** (values under remote control):

  - ``claimed_key_id(...)`` — the pre-auth tenant identity
  - ``.telemetry`` attribute reads — a peer's gossiped digest
  - ``.hostname`` attribute reads — peer-reported, shows up in rollups
  - ``<x>.get("tm")`` / ``<x>.get("digest")`` — the gossip wire fields

**Sinks** (where an unescaped value does damage):

  - metric label positions (``register_gauge`` / ``incr`` / ``observe``
    / ``set_gauge`` / ``timer`` arguments)
  - log f-strings (newline injection forges log lines; the JSON
    formatter is safe but the plain formatter is the default)
  - filesystem paths (``open`` / ``os.path.join`` / ``Path``)

**Sanitizers** — calls are trust boundaries: the RESULT of any
non-catalogue call is clean (``_esc(v)``, ``_valid_digest(v)``,
``valid_bucket_name(v)``, ``int(v)`` all clear the taint; so does
``classify(key_id)`` — the returned tier is not the id).  The flow INTO
a callee is what's tracked instead: a tainted argument taints the
matching parameter of a name-resolvable callee for up to two hops
(this is how the claimed key id is followed through ``_token_wait``
into ``_tenant_bucket``'s gauge registration).  Tracking is otherwise
intraprocedural — assignments propagate taint through local names.

Suppression: ``# graft-lint: allow-taint(<reason>)`` on the sink line —
e.g. metric-label sinks whose escaping happens at exposition time
(``metrics._fmt`` applies ``_esc`` to every label value).
"""

from __future__ import annotations

import ast

from .core import FunctionInfo, Project, Violation, call_repr
from .core import walk_no_defs as _walk_no_defs

RULE = "trust-boundary"

SOURCE_CALL_LASTS = {"claimed_key_id"}
SOURCE_ATTRS = {"telemetry", "hostname"}
SOURCE_GET_KEYS = {"tm", "digest"}

METRIC_LASTS = {"register_gauge", "incr", "observe", "set_gauge", "timer"}
LOG_LASTS = {"debug", "info", "warning", "error", "exception", "critical", "log"}
PATH_CALLS = {"open", "Path"}
PATH_DOTTED = {"os.path.join", "path.join"}

MAX_HOPS = 2


def _last(repr_: str) -> str:
    return repr_.rsplit(".", 1)[-1]


# nested-def walks use the shared core.walk_no_defs (imported above)


def _is_source(node) -> str | None:
    """Non-None (a short label) when `node` is a catalogue source."""
    if isinstance(node, ast.Call):
        r = call_repr(node.func)
        if r is not None:
            if _last(r) in SOURCE_CALL_LASTS:
                return _last(r)
            if (
                _last(r) == "get"
                and "." in r
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value in SOURCE_GET_KEYS
            ):
                return f"get:{node.args[0].value}"
    if isinstance(node, ast.Attribute) and node.attr in SOURCE_ATTRS:
        return node.attr
    return None


def _taints(node, tainted: set[str]) -> str | None:
    """Does evaluating `node` yield a tainted value?  Returns the taint
    label.  Calls are boundaries: a sanitizer's result is clean, and a
    non-catalogue call's RESULT is not tainted by its arguments either
    (``classify(key_id)`` returns a tier, not the id — the one-hop
    interprocedural pass follows the argument INTO the callee instead)."""
    src = _is_source(node)
    if src is not None:
        return src
    if isinstance(node, ast.Call):
        return None  # sanitizer, or opaque: result considered clean
    if isinstance(node, ast.Name) and node.id in tainted:
        return node.id
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        hit = _taints(child, tainted)
        if hit is not None:
            return hit
    return None


def _tainted_names(fn_node, seed: set[str]) -> set[str]:
    tainted = set(seed)
    for _ in range(2):  # fixed-point over simple assignment chains
        for node in _walk_no_defs(fn_node):
            if not isinstance(node, ast.Assign):
                continue
            if _taints(node.value, tainted) is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    tainted.add(t.id)
                elif isinstance(t, ast.Tuple):
                    tainted.update(
                        e.id for e in t.elts if isinstance(e, ast.Name)
                    )
    return tainted


def _sink_kind(call: ast.Call) -> str | None:
    r = call_repr(call.func)
    if r is None:
        return None
    last = _last(r)
    if last in METRIC_LASTS and "." in r:
        return f"metric:{last}"
    if last in LOG_LASTS and "." in r:
        return f"log:{last}"
    if r in PATH_CALLS or r in PATH_DOTTED or last == "Path":
        return f"path:{last}"
    return None


def check(project: Project) -> list[Violation]:
    out: list[Violation] = []
    seen: set[tuple[str, str, frozenset]] = set()
    # every function starts untainted; tainted params flow in via the
    # one-hop worklist below
    work: list[tuple[FunctionInfo, frozenset, int]] = [
        (fn, frozenset(), 0) for fn in project.functions.values()
    ]
    while work:
        fn, params, hops = work.pop()
        key = (fn.module, fn.qualname, params)
        if key in seen:
            continue
        seen.add(key)
        sf = project.files[fn.module]
        tainted = _tainted_names(fn.node, set(params))
        for node in _walk_no_defs(fn.node):
            if not isinstance(node, ast.Call):
                continue
            kind = _sink_kind(node)
            if kind is not None:
                hit = None
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    if kind.startswith("log:") and not _is_fstringy(arg):
                        # log sinks: only f-string interpolation is the
                        # hazard (%-style defers formatting to the
                        # record, which the formatter escapes)
                        continue
                    hit = _taints(arg, tainted)
                    if hit is not None:
                        break
                if hit is not None and not sf.pragma_for(node, "taint"):
                    out.append(
                        Violation(
                            RULE, fn.module, node.lineno, fn.qualname,
                            f"{kind}:{hit}",
                            f"untrusted value ({hit}) reaches {kind} "
                            "without _esc/validation: a peer- or "
                            "pre-auth-controlled string can corrupt the "
                            "exposition / forge log lines / traverse "
                            "paths — sanitize it or "
                            "# graft-lint: allow-taint(<reason>)",
                        )
                    )
                continue
            # one-hop interprocedural: tainted argument -> callee param
            if hops >= MAX_HOPS:
                continue
            r = call_repr(node.func)
            if r is None:
                continue
            target = project.resolve_call(fn, r)
            if target is None:
                continue
            tainted_params = _map_tainted_params(node, r, target, tainted)
            if tainted_params:
                work.append((target, frozenset(tainted_params), hops + 1))
    # stable order for baseline diffing
    out.sort(key=lambda v: (v.path, v.line, v.detail))
    return out


def _is_fstringy(node) -> bool:
    return any(
        isinstance(n, ast.JoinedStr) for n in ast.walk(node)
    )


def _map_tainted_params(
    call: ast.Call, repr_: str, target: FunctionInfo, tainted: set[str]
) -> set[str]:
    """Names of `target` params that receive tainted arguments."""
    args = target.node.args
    names = [a.arg for a in args.posonlyargs + args.args]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    hit: set[str] = set()
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            break
        if _taints(arg, tainted) is not None and i < len(names):
            hit.add(names[i])
    for kw in call.keywords:
        if kw.arg and _taints(kw.value, tainted) is not None:
            hit.add(kw.arg)
    return hit
