"""graft-lint core: source model, pragma parsing, call graph, driver.

Everything here is stdlib-`ast` only.  The model is deliberately
approximate — it resolves calls by NAME (bare names, ``self.method`` /
``cls.method``, and names imported with ``from .mod import name``), not
by type inference.  That is enough to follow blocking I/O two levels
through the sync helpers coroutines actually use, while staying
dependency-free and fast (~the whole tree in well under a second).

Violation keys are line-number-free (``rule:path:symbol:detail``) so the
committed baseline survives unrelated edits to the same file.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Iterable

# pragma grammar:  # graft-lint: allow-<kind>(<reason>)
# The reason is REQUIRED — a suppression nobody can explain is debt, not
# triage.  Unknown kinds and empty reasons are themselves violations.
PRAGMA_RE = re.compile(r"#\s*graft-lint:\s*allow-([a-z][a-z-]*)\s*\(([^)]*)\)")

PRAGMA_KINDS = {
    "blocking",  # loop-blocker
    "orphan-task",  # orphan-task
    "swallow",  # swallowed-exception
    "unpaired-metric",  # resource-discipline (register/unregister)
    "unvalidated-knob",  # resource-discipline (config knobs)
    "cancel",  # cancel-safety (await-in-finally / swallowed cancel / no-drain)
    "lock-await",  # lock-across-await (slow await under a mutex)
    "taint",  # trust-boundary (pre-auth/peer data reaching a sink)
    "wire",  # wire-compat (CRDT mutation discipline)
    "host-sync",  # host-sync (device->host sync point on the loop)
    "recompile",  # recompile-hazard (unbucketed dispatch / traced branch)
    "donation",  # use-after-donation (donated buffer re-read / advisory)
    "backend-gate",  # backend-conditional (platform compare / uncounted path)
}


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str  # repo-relative, '/'-separated
    line: int
    symbol: str  # enclosing function qualname, or '<module>'
    detail: str  # short stable discriminator (no line numbers)
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}:{self.detail}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Pragma:
    kind: str
    reason: str
    line: int
    used: bool = False


@dataclass
class FunctionInfo:
    """One (async) function/method: where it is and what it calls."""

    module: str  # repo-relative path of the defining file
    qualname: str  # Class.method / func / outer.<locals>.inner
    node: ast.AST
    is_async: bool
    # calls made DIRECTLY by this function's body (nested defs excluded —
    # defining an inner function does not run it): (callee_repr, line)
    # where callee_repr is a bare name ("helper"), "self.method", or a
    # dotted chain ("os.fsync", "asyncio.create_task")
    calls: list[tuple[str, int]] = field(default_factory=list)


class SourceFile:
    def __init__(self, relpath: str, text: str):
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=relpath)
        # pragmas live in COMMENTS only — tokenize so pragma syntax quoted
        # in a docstring or a log-message string (this package's own docs
        # do both) can never register a live suppression
        self.pragmas: dict[int, Pragma] = {}
        import io
        import tokenize

        try:
            for tok in tokenize.generate_tokens(io.StringIO(text).readline):
                if tok.type != tokenize.COMMENT:
                    continue
                m = PRAGMA_RE.search(tok.string)
                if m:
                    line = tok.start[0]
                    self.pragmas[line] = Pragma(
                        m.group(1), m.group(2).strip(), line
                    )
        except tokenize.TokenError:
            # ast.parse accepted the file, so this is near-unreachable;
            # fall back to the line scan rather than dropping pragmas
            # (no pragmas at all would turn suppressions into findings)
            for i, line_text in enumerate(self.lines, 1):
                m = PRAGMA_RE.search(line_text)
                if m:
                    self.pragmas[i] = Pragma(m.group(1), m.group(2).strip(), i)

    def pragma_for(self, node: ast.AST, kind: str) -> Pragma | None:
        """Pragma covering `node`: on its first line, the line above, or
        its last line (multi-line calls often carry the comment on the
        closing-paren line)."""
        cands = {getattr(node, "lineno", 0)}
        cands.add(getattr(node, "lineno", 1) - 1)
        end = getattr(node, "end_lineno", None)
        if end:
            cands.add(end)
        for ln in cands:
            p = self.pragmas.get(ln)
            if p is not None and p.kind == kind:
                p.used = True
                return p
        return None


def _ann_class_repr(ann) -> str | None:
    """Class name out of a parameter annotation: `Foo`, `"Foo"`,
    `mod.Foo`, `Foo | None`, `Optional[Foo]`."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:  # string annotation: parse the expression and recurse
            return _ann_class_repr(ast.parse(ann.value, mode="eval").body)
        except SyntaxError:
            return None
    if isinstance(ann, (ast.Name, ast.Attribute)):
        parts: list[str] = []
        n = ann
        while isinstance(n, ast.Attribute):
            parts.append(n.attr)
            n = n.value
        if isinstance(n, ast.Name):
            parts.append(n.id)
            return ".".join(reversed(parts))
        return None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        for side in (ann.left, ann.right):
            if isinstance(side, ast.Constant) and side.value is None:
                continue
            r = _ann_class_repr(side)
            if r is not None:
                return r
        return None
    if isinstance(ann, ast.Subscript):  # Optional[Foo]
        base = ann.value
        if isinstance(base, ast.Name) and base.id == "Optional":
            return _ann_class_repr(ann.slice)
    return None


def _param_annotations(meth) -> dict[str, str]:
    out: dict[str, str] = {}
    a = meth.args
    for arg in a.posonlyargs + a.args + a.kwonlyargs:
        if arg.annotation is not None:
            r = _ann_class_repr(arg.annotation)
            if r is not None:
                out[arg.arg] = r
    return out


def _ctor_repr_of(value, ann: dict[str, str]) -> str | None:
    """The constructor repr a value plausibly came from: a direct call
    `Foo(...)`, the call branch of `Foo(...) if cond else None`, or a
    parameter pass-through `self.x = param` where the param carries a
    class annotation (the one type hint the analyzer honors)."""
    if isinstance(value, ast.Call):
        return call_repr(value.func)
    if isinstance(value, ast.IfExp):
        ctors = set()
        for side in (value.body, value.orelse):
            if isinstance(side, ast.Constant) and side.value is None:
                continue
            ctors.add(_ctor_repr_of(side, ann))
        ctors.discard(None)
        return ctors.pop() if len(ctors) == 1 else None
    if isinstance(value, ast.Name):
        return ann.get(value.id)
    return None


def call_repr(func: ast.AST) -> str | None:
    """Render a Call.func node to a resolvable string: 'name',
    'self.method', or a dotted chain 'a.b.c'.  None for anything
    dynamic (subscripts, calls-of-calls)."""
    parts: list[str] = []
    n = func
    while isinstance(n, ast.Attribute):
        parts.append(n.attr)
        n = n.value
    if isinstance(n, ast.Name):
        parts.append(n.id)
        return ".".join(reversed(parts))
    return None


class _FunctionCollector(ast.NodeVisitor):
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.stack: list[str] = []
        self.functions: list[FunctionInfo] = []

    def _visit_fn(self, node, is_async: bool):
        qual = ".".join(self.stack + [node.name]) if self.stack else node.name
        info = FunctionInfo(self.sf.relpath, qual, node, is_async)
        info.calls = _direct_calls(node)
        self.functions.append(info)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node):
        self._visit_fn(node, False)

    def visit_AsyncFunctionDef(self, node):
        self._visit_fn(node, True)

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()


def _direct_calls(fn_node) -> list[tuple[str, int]]:
    """Calls lexically in `fn_node`'s body, excluding nested def/lambda
    bodies (defining an inner function does not execute it)."""
    out: list[tuple[str, int]] = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Call):
                r = call_repr(child.func)
                if r is not None:
                    out.append((r, child.lineno))
            walk(child)

    for stmt in fn_node.body:
        walk(stmt)
    return out


DEFAULT_PACKAGE = "garage_tpu_torch"


class Project:
    """All analyzed sources + a name-resolved function index.  `package`
    names the package being linted: the paths the rules single out (its
    config module, its telemetry module, its wire-defining modules)
    live under it."""

    def __init__(self, root: str, package: str = DEFAULT_PACKAGE):
        self.root = root
        self.package = package
        self.files: dict[str, SourceFile] = {}
        self.functions: dict[tuple[str, str], FunctionInfo] = {}
        # per-module: bare/last name -> [FunctionInfo] (same module)
        self._by_name: dict[str, dict[str, list[FunctionInfo]]] = {}
        # per-module: imported name -> (module relpath, original name)
        self.imports: dict[str, dict[str, tuple[str, str]]] = {}
        # per-module: top-level class names (receiver-type resolution)
        self.classes: dict[str, set[str]] = {}
        # (module, class) -> {attr: ctor repr}: `self.x = Foo(...)` seen in
        # a method body.  Conflicting ctors for one attr map to None
        # (ambiguous — resolution declines rather than guessing).
        self._self_attr_ctors: dict[tuple[str, str], dict[str, str | None]] = {}

    def package_path(self, rel: str) -> str:
        """`rel` (a path inside the linted package) from the repo root."""
        return f"{self.package}/{rel}"

    # --- loading -------------------------------------------------------------

    def add_file(self, abspath: str) -> SourceFile | None:
        rel = os.path.relpath(abspath, self.root).replace(os.sep, "/")
        try:
            with open(abspath, encoding="utf-8") as f:
                text = f.read()
        except (OSError, UnicodeDecodeError):
            return None
        try:
            sf = SourceFile(rel, text)
        except SyntaxError:
            return None
        self.files[rel] = sf
        col = _FunctionCollector(sf)
        col.visit(sf.tree)
        byname = self._by_name.setdefault(rel, {})
        for fn in col.functions:
            self.functions[(rel, fn.qualname)] = fn
            byname.setdefault(fn.qualname.rsplit(".", 1)[-1], []).append(fn)
        self.imports[rel] = _collect_imports(sf.tree, rel)
        classes = self.classes.setdefault(rel, set())
        for node in sf.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            classes.add(node.name)
            attrs = self._self_attr_ctors.setdefault((rel, node.name), {})
            for meth in node.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                ann = _param_annotations(meth)
                for sub in ast.walk(meth):
                    if not isinstance(sub, ast.Assign):
                        continue
                    ctor = _ctor_repr_of(sub.value, ann)
                    if ctor is None:
                        continue
                    for tgt in sub.targets:
                        if (
                            isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                        ):
                            prev = attrs.get(tgt.attr, ctor)
                            attrs[tgt.attr] = ctor if prev == ctor else None
        return sf

    def add_tree(self, subdir: str) -> None:
        base = os.path.join(self.root, subdir) if subdir else self.root
        if os.path.isfile(base):
            self.add_file(base)
            return
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [
                d for d in dirnames if d not in ("__pycache__", ".git", ".xla_cache")
            ]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    self.add_file(os.path.join(dirpath, name))

    # --- resolution ----------------------------------------------------------

    def resolve_call(
        self, caller: FunctionInfo, callee: str
    ) -> FunctionInfo | None:
        """Name-based resolution of a call made by `caller`:
          - bare name -> function in the same module, else a same-named
            import from an analyzed module
          - self.X / cls.X -> method X in the same class, else any
            same-module function named X
          - self.X.Y -> method Y on the class CONSTRUCTED into self.X
            (`self.x = Foo()` tracked per class)
        Deeper chains (self.a.b.c) are still NOT resolved (no type
        inference) — they are matched against the blocking-call tables
        directly instead."""
        mod = caller.module
        if callee.startswith(("self.", "cls.")):
            name = callee.split(".", 1)[1]
            if "." in name:
                # self.obj.method: resolve through the ctor assignment
                # recorded for obj on the caller's class, if unambiguous
                attr, _, meth = name.partition(".")
                if "." in meth:
                    return None  # 3+ levels deep: untyped
                cls = self._enclosing_class(caller)
                if cls is None:
                    return None
                ctor = self._self_attr_ctors.get((mod, cls), {}).get(attr)
                target = self._resolve_class(mod, ctor) if ctor else None
                if target is None:
                    return None
                return self.functions.get((target[0], f"{target[1]}.{meth}"))
            cls = caller.qualname.rsplit(".", 1)[0] if "." in caller.qualname else None
            if cls:
                hit = self.functions.get((mod, f"{cls}.{name}"))
                if hit is not None:
                    return hit
            for fn in self._by_name.get(mod, {}).get(name, []):
                return fn
            return None
        if "." in callee:
            # module-qualified: "mod.func" where mod was imported
            head, _, tail = callee.partition(".")
            if "." in tail:
                return None
            imp = self.imports.get(mod, {}).get(head)
            if imp is not None:
                if imp[1] == "*module*":
                    target_mod = imp[0]
                else:
                    # `from . import mod [as m]` / `from .pkg import mod`
                    # bind a MODULE under a from-import: the target file
                    # is <package-dir>/<name>.py, not the package itself
                    target_mod = imp[0][:-3] + "/" + imp[1] + ".py"
                for fn in self._by_name.get(target_mod, {}).get(tail, []):
                    if "." not in fn.qualname:
                        return fn
            return None
        # bare name: same module first
        for fn in self._by_name.get(mod, {}).get(callee, []):
            if "." not in fn.qualname:  # plain function, not a method
                return fn
        imp = self.imports.get(mod, {}).get(callee)
        if imp is not None and imp[1] != "*module*":
            target_mod, orig = imp
            for fn in self._by_name.get(target_mod, {}).get(orig, []):
                if "." not in fn.qualname:
                    return fn
        return None

    def _enclosing_class(self, fn: FunctionInfo) -> str | None:
        """The class a method belongs to: the first qualname component,
        when it names a top-level class of the module (nested helpers
        inside methods keep working — Class.method.inner -> Class)."""
        head = fn.qualname.split(".", 1)[0]
        return head if head in self.classes.get(fn.module, set()) else None

    def _resolve_class(self, mod: str, ctor: str) -> tuple[str, str] | None:
        """Resolve a constructor repr ('Foo', 'mod.Foo', 'Foo.new') to
        (module relpath, class name) among analyzed files."""

        def local_or_imported(name: str) -> tuple[str, str] | None:
            if name in self.classes.get(mod, set()):
                return (mod, name)
            imp = self.imports.get(mod, {}).get(name)
            if imp is not None and imp[1] != "*module*":
                tmod, orig = imp
                if orig in self.classes.get(tmod, set()):
                    return (tmod, orig)
            return None

        if "." not in ctor:
            return local_or_imported(ctor)
        head, _, tail = ctor.partition(".")
        if "." in tail:
            return None
        # `Foo.new(...)` classmethod constructor: the class is the head
        hit = local_or_imported(head)
        if hit is not None:
            return hit
        # `mod.Foo(...)` through an imported module
        imp = self.imports.get(mod, {}).get(head)
        if imp is not None:
            tmod = (
                imp[0] if imp[1] == "*module*"
                else imp[0][:-3] + "/" + imp[1] + ".py"
            )
            if tail in self.classes.get(tmod, set()):
                return (tmod, tail)
        return None


def _collect_imports(
    tree: ast.Module, relpath: str
) -> dict[str, tuple[str, str]]:
    """Map local names to (module relpath, original name) for
    `from .x import y` forms; `import a.b as m` maps m -> (a/b.py,
    '*module*') so `m.func()` resolves."""
    out: dict[str, tuple[str, str]] = {}
    pkg_parts = relpath.split("/")[:-1]  # directory of this module

    def module_to_rel(level: int, module: str | None) -> str | None:
        if level == 0:
            parts = (module or "").split(".")
        else:
            base = pkg_parts[: len(pkg_parts) - (level - 1)]
            parts = base + ((module or "").split(".") if module else [])
        if not parts or parts == [""]:
            return None
        return "/".join(parts) + ".py"

    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            target = module_to_rel(node.level, node.module)
            if target is None:
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                out[alias.asname or alias.name] = (target, alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                rel = alias.name.replace(".", "/") + ".py"
                out[alias.asname or alias.name.split(".")[0]] = (rel, "*module*")
    return out


def walk_no_defs(node):
    """All descendants of `node`, excluding nested function/lambda
    bodies (defining an inner function does not execute it; a nested
    def's hazards belong to its own analysis).  THE shared skip-defs
    walker — rules must use this instead of growing private copies, so
    a change to the skip set lands everywhere at once."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield child
        yield from walk_no_defs(child)


def iter_async_reachable(project: "Project", fn: FunctionInfo, max_depth: int):
    """BFS from coroutine `fn` through name-resolved SYNC helpers:
    yields (func, chain, depth) for `fn` itself and every sync callee
    within `max_depth` hops.  Awaited coroutines are skipped (they get
    their own pass as BFS roots); functions only ever *passed* (e.g. to
    ``asyncio.to_thread``) never appear — they are not in the call
    graph.  THE shared reachability walk for the loop-blocker-shaped
    rules (loop-blocker, host-sync): a fix to hop resolution must land
    in both at once."""
    queue = [(fn, [fn.qualname], 0)]
    visited = {(fn.module, fn.qualname)}
    while queue:
        cur, chain, depth = queue.pop(0)
        yield cur, chain, depth
        if depth >= max_depth:
            continue
        for callee, _line in cur.calls:
            target = project.resolve_call(cur, callee)
            if target is None or target.is_async:
                continue
            key = (target.module, target.qualname)
            if key in visited:
                continue
            visited.add(key)
            queue.append((target, chain + [target.qualname], depth + 1))


def iter_nodes_with_owner(sf: SourceFile):
    """Yield (node, owner_qualname) for every AST node in the file,
    where owner is the NEAREST enclosing function ('<module>' outside
    any).  Rules use this instead of ast.walk so a node inside a nested
    function is attributed exactly once."""

    def walk(node, owner: str, stack: list[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join(stack + [child.name]) if stack else child.name
                yield child, owner
                yield from walk(child, qual, stack + [child.name])
            elif isinstance(child, ast.ClassDef):
                yield child, owner
                yield from walk(child, owner, stack + [child.name])
            else:
                yield child, owner
                yield from walk(child, owner, stack)

    yield from walk(sf.tree, "<module>", [])


# --- driver -------------------------------------------------------------------


def analyze(
    root: str,
    paths: Iterable[str] | None = None,
    rules: Iterable[str] | None = None,
    timings: dict[str, float] | None = None,
    package: str = DEFAULT_PACKAGE,
) -> list[Violation]:
    """Run all (or the selected) rule families over `paths` under `root`
    (default: the whole of `package`), linting them as `package`.
    Returns unsuppressed violations sorted by (path, line).  When a dict
    is passed as `timings` it is filled with per-rule wall seconds
    (served by `--json`)."""
    import time

    from . import (
        backend_gate,
        cancel_safety,
        donation,
        host_sync,
        lock_await,
        loop_blocker,
        orphan_task,
        recompile,
        resource,
        swallowed,
        taint,
        wire_compat,
    )

    project = Project(root, package)
    for p in paths or (package,):
        project.add_tree(p)

    all_rules = {
        "loop-blocker": loop_blocker.check,
        "orphan-task": orphan_task.check,
        "swallowed-exception": swallowed.check,
        "resource-discipline": resource.check,
        "cancel-safety": cancel_safety.check,
        "lock-await": lock_await.check,
        "trust-boundary": taint.check,
        "wire-compat": wire_compat.check,
        "host-sync": host_sync.check,
        "recompile-hazard": recompile.check,
        "use-after-donation": donation.check,
        "backend-gate": backend_gate.check,
    }
    selected = set(rules) if rules else set(all_rules)
    unknown = selected - set(all_rules)
    if unknown:
        raise ValueError(f"unknown rule(s): {sorted(unknown)}")

    violations: list[Violation] = []
    for name in sorted(selected):
        t0 = time.perf_counter()
        violations.extend(all_rules[name](project))
        if timings is not None:
            timings[name] = time.perf_counter() - t0
    violations.extend(_check_pragmas(project))
    violations.sort(key=lambda v: (v.path, v.line, v.rule, v.detail))
    return violations


def _check_pragmas(project: Project) -> list[Violation]:
    """A pragma with an unknown kind or an empty reason is itself a
    violation — suppressions must stay explicable."""
    out: list[Violation] = []
    for rel, sf in project.files.items():
        for p in sf.pragmas.values():
            if p.kind not in PRAGMA_KINDS:
                out.append(
                    Violation(
                        "pragma", rel, p.line, "<module>",
                        f"unknown:{p.kind}",
                        f"unknown graft-lint pragma kind {p.kind!r} "
                        f"(valid: {', '.join(sorted(PRAGMA_KINDS))})",
                    )
                )
            elif not p.reason:
                out.append(
                    Violation(
                        "pragma", rel, p.line, "<module>",
                        f"empty-reason:{p.kind}",
                        f"graft-lint pragma allow-{p.kind} needs a "
                        "non-empty reason",
                    )
                )
    return out


# --- baseline -----------------------------------------------------------------


def load_baseline(path: str) -> dict[str, int]:
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    if raw.get("version") != 1:
        raise ValueError(f"unsupported baseline version {raw.get('version')!r}")
    return {k: int(v["count"]) for k, v in raw["violations"].items()}


def write_baseline(path: str, violations: list[Violation]) -> None:
    counts: dict[str, int] = {}
    messages: dict[str, str] = {}
    for v in violations:
        counts[v.key] = counts.get(v.key, 0) + 1
        messages.setdefault(v.key, v.message)
    obj = {
        "version": 1,
        "generated_by": "python -m garage_tpu_torch.analysis --write-baseline",
        "violations": {
            k: {"count": counts[k], "message": messages[k]}
            for k in sorted(counts)
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")


def diff_baseline(
    violations: list[Violation], baseline: dict[str, int]
) -> tuple[list[Violation], list[str]]:
    """(new_violations, stale_keys): a violation is NEW when its key
    occurs more times than the baseline allows; a baseline key is STALE
    when the code no longer produces that many occurrences (debt paid —
    regenerate the baseline so it can't silently re-accrue)."""
    seen: dict[str, int] = {}
    new: list[Violation] = []
    for v in violations:
        seen[v.key] = seen.get(v.key, 0) + 1
        if seen[v.key] > baseline.get(v.key, 0):
            new.append(v)
    stale = [k for k, n in sorted(baseline.items()) if seen.get(k, 0) < n]
    return new, stale
