"""wire-compat: the gossip/RPC wire surface is schema-gated, not vibes.

Until now the telemetry digest's key set was guarded by a comment
("additive keys, DIGEST_VERSION stays 1") and the RPC frame meta keys by
convention alone.  Removing or retyping either breaks rolling upgrades
silently: an old peer reads a key that is gone and degrades (best case)
or mis-parses (worst case).  This rule snapshots the wire surface into a
committed schema file and fails drift:

**schema snapshot** — ``script/wire_schema.json``, the reference
package's committed snapshot, records (a) the ``DIGEST_VERSION`` value,
(b) every digest key (dotted for nesting, with a static type tag)
extracted from ``DigestCollector.collect``'s dict literal, (c) the RPC
frame meta keys from ``net/connection.py``'s ``meta``/``rmeta``
literals, and (d) every ``Migratable`` subclass's ``VERSION_MARKER`` and
whether it declares a ``PREVIOUS`` migration hop.  This package speaks
the reference's wire (mixed clusters of both packages run), so it READS
that snapshot and never writes it: a difference is a fault of this
package, fixed here.  The snapshot names the reference's modules; they
are matched to the same paths in the linted package.

**drift checks** (all comparisons only run when the defining file is in
the analyzed set, so subtree lints stay quiet):

  - digest/frame key REMOVED or RETYPED with ``DIGEST_VERSION``
    unchanged -> violation.  Added keys are clean (additive evolution).
  - ``DIGEST_VERSION`` differing from the snapshot -> violation.
  - a ``Migratable`` class disappearing, or changing its
    ``VERSION_MARKER`` without declaring ``PREVIOUS`` -> violation
    (persisted state written under the old marker becomes undecodable
    with no migration chain).

**crdt-mutation** — classes defining ``merge()`` under ``model/`` or
``table/`` must only mutate ``self`` inside ``__init__``/
``__post_init__``/``merge*``/``update*`` methods.  CRDT correctness
(the paper's whole consistency story) rests on merge discipline: a
mutation from any other method bypasses the idempotent/commutative
merge path and diverges replicas.  Suppress with
``# graft-lint: allow-wire(<reason>)`` on the assignment.
"""

from __future__ import annotations

import ast
import json
import os

from .core import Project, Violation, call_repr

RULE = "wire-compat"

# wire-defining modules, inside the linted package (Project.package_path)
DIGEST_PATH = "rpc/telemetry_digest.py"
FRAME_PATH = "net/connection.py"
SCHEMA_PATH = "script/wire_schema.json"  # the reference's snapshot: read, never written
REFERENCE_PACKAGE = "garage_tpu"  # the package whose module paths the snapshot names
SCHEMA_VERSION = 1

CRDT_ALLOWED_PREFIXES = ("merge", "update")
CRDT_ALLOWED_NAMES = {"__init__", "__post_init__"}


def _last(repr_: str) -> str:
    return repr_.rsplit(".", 1)[-1]


# --- static type tags ---------------------------------------------------------


def _type_tag(node) -> str:
    """A coarse, stable type tag for a dict-literal value.  'any' never
    mismatches — only confidently-known tags participate in the retype
    check."""
    if isinstance(node, ast.Constant):
        v = node.value
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, int):
            return "int"
        if isinstance(v, float):
            return "float"
        if isinstance(v, str):
            return "str"
        return "any"
    if isinstance(node, ast.Dict):
        return "object"
    if isinstance(node, ast.Call):
        r = call_repr(node.func) or ""
        last = _last(r)
        if last == "round":
            return "number"
        if last == "int":
            return "int"
        if last == "float":
            return "number"
        if last == "bool":
            return "bool"
        if last in ("str", "join", "hex", "format"):
            return "str"
    if isinstance(node, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(node, ast.JoinedStr):
        return "str"
    return "any"


def _flatten_dict(node: ast.Dict, prefix: str, into: dict[str, str]) -> None:
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            continue  # dynamic keys are out of static reach
        dotted = f"{prefix}{k.value}"
        if isinstance(v, ast.Dict):
            into[dotted] = "object"
            _flatten_dict(v, dotted + ".", into)
        else:
            into[dotted] = _type_tag(v)


# --- extraction ---------------------------------------------------------------


def extract_digest(project: Project) -> tuple[int | None, dict[str, str]] | None:
    """(DIGEST_VERSION, {dotted key: type tag}) from the digest module,
    or None when it is not in the analyzed set."""
    sf = project.files.get(project.package_path(DIGEST_PATH))
    if sf is None:
        return None
    version: int | None = None
    for node in sf.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "DIGEST_VERSION"
            and isinstance(node.value, ast.Constant)
        ):
            version = int(node.value.value)
    keys: dict[str, str] = {}
    collect = None
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.FunctionDef) and node.name == "collect":
            collect = node
            break
    if collect is not None:
        # the literal assigned to `digest`, plus digest["k"] = ... adds
        for node in ast.walk(collect):
            if isinstance(node, ast.AnnAssign):  # digest: dict = {...}
                t, value = node.target, node.value
                if (
                    isinstance(t, ast.Name)
                    and t.id == "digest"
                    and isinstance(value, ast.Dict)
                ):
                    _flatten_dict(value, "", keys)
                continue
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if (
                    isinstance(t, ast.Name)
                    and t.id == "digest"
                    and isinstance(node.value, ast.Dict)
                ):
                    _flatten_dict(node.value, "", keys)
                elif (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "digest"
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)
                ):
                    keys[t.slice.value] = _type_tag(node.value)
    return version, keys


def extract_frame_meta(project: Project) -> dict[str, str] | None:
    """{meta key: type tag} from connection.py's meta/rmeta literals,
    or None when the file is not in the analyzed set."""
    sf = project.files.get(project.package_path(FRAME_PATH))
    if sf is None:
        return None
    keys: dict[str, str] = {}
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t = node.targets[0]
        if (
            isinstance(t, ast.Name)
            and t.id in ("meta", "rmeta")
            and isinstance(node.value, ast.Dict)
        ):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.setdefault(k.value, _type_tag(v))
        elif (
            isinstance(t, ast.Subscript)
            and isinstance(t.value, ast.Name)
            and t.value.id in ("meta", "rmeta")
            and isinstance(t.slice, ast.Constant)
            and isinstance(t.slice.value, str)
        ):
            keys.setdefault(t.slice.value, _type_tag(node.value))
    return keys


def extract_migratables(project: Project) -> dict[str, dict]:
    """Every class with a bytes VERSION_MARKER: '<module>:<Class>' ->
    {marker, has_previous}."""
    out: dict[str, dict] = {}
    for rel, sf in project.files.items():
        for node in sf.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            marker = None
            has_prev = False
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    t = stmt.targets[0]
                    if isinstance(t, ast.Name) and t.id == "VERSION_MARKER":
                        if isinstance(stmt.value, ast.Constant) and isinstance(
                            stmt.value.value, bytes
                        ):
                            marker = stmt.value.value.decode("latin1")
                    elif isinstance(t, ast.Name) and t.id == "PREVIOUS":
                        has_prev = not (
                            isinstance(stmt.value, ast.Constant)
                            and stmt.value.value is None
                        )
                elif isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    if stmt.target.id == "PREVIOUS" and stmt.value is not None:
                        has_prev = not (
                            isinstance(stmt.value, ast.Constant)
                            and stmt.value.value is None
                        )
            if marker:  # the Migratable base's own b"" marker is not one
                out[f"{rel}:{node.name}"] = {
                    "marker": marker,
                    "has_previous": has_prev,
                }
    return out


def _as_reference(project: Project, name: str) -> str:
    """A '<module>:<Class>' name of the linted package under the
    reference's module path (the snapshot's naming)."""
    prefix = project.package + "/"
    return REFERENCE_PACKAGE + "/" + name[len(prefix):] if name.startswith(prefix) else name


def _in_package(project: Project, module: str) -> str:
    """A module path of the snapshot under the linted package."""
    prefix = REFERENCE_PACKAGE + "/"
    return project.package + "/" + module[len(prefix):] if module.startswith(prefix) else module


def build_schema(project: Project) -> dict:
    """The wire surface of the analyzed files, shaped and named like the
    snapshot (what `tests/test_torch_analysis.py` holds against it)."""
    dig = extract_digest(project)
    frame = extract_frame_meta(project)
    return {
        "version": SCHEMA_VERSION,
        "digest_version": dig[0] if dig else None,
        "digest_keys": dict(sorted(dig[1].items())) if dig else {},
        "frame_meta_keys": dict(sorted(frame.items())) if frame else {},
        "migratable_markers": dict(sorted(
            (_as_reference(project, k), v) for k, v in extract_migratables(project).items())),
    }


# --- checks -------------------------------------------------------------------


def check(project: Project) -> list[Violation]:
    return _check_schema(project) + _check_crdt_mutation(project)


def _load_schema(project: Project) -> dict | None:
    p = os.path.join(project.root, SCHEMA_PATH)
    try:
        with open(p, encoding="utf-8") as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if raw.get("version") != SCHEMA_VERSION:
        return None
    return raw


FIX = ("this package speaks the reference's wire: restore it here (the "
       "snapshot is the reference's and is not rewritten for this package)")


def _check_schema(project: Project) -> list[Violation]:
    dig = extract_digest(project)
    frame = extract_frame_meta(project)
    if dig is None and frame is None:
        return []  # wire-defining files outside the analyzed set
    digest_path = project.package_path(DIGEST_PATH)
    frame_path = project.package_path(FRAME_PATH)
    schema = _load_schema(project)
    if schema is None:
        path = digest_path if dig is not None else frame_path
        return [
            Violation(
                RULE, path, 1, "<module>", "wire-schema:missing",
                f"{SCHEMA_PATH} is missing or unreadable: the wire "
                "surface (digest keys, frame meta keys, Migratable "
                "markers) is held against the reference's snapshot",
            )
        ]
    out: list[Violation] = []
    if dig is not None:
        version, keys = dig
        if version != schema.get("digest_version"):
            out.append(
                Violation(
                    RULE, digest_path, 1, "<module>",
                    "wire-schema:version-drift",
                    f"DIGEST_VERSION is {version} but "
                    f"{SCHEMA_PATH} snapshots "
                    f"{schema.get('digest_version')} — {FIX}",
                )
            )
        else:
            for key, tag in sorted(schema.get("digest_keys", {}).items()):
                if key not in keys:
                    out.append(
                        Violation(
                            RULE, digest_path, 1, "DigestCollector.collect",
                            f"digest-key-removed:{key}",
                            f"digest key {key!r} was removed: peers "
                            f"still parse it — {FIX}",
                        )
                    )
                elif (
                    tag != "any"
                    and keys[key] != "any"
                    and keys[key] != tag
                ):
                    out.append(
                        Violation(
                            RULE, digest_path, 1, "DigestCollector.collect",
                            f"digest-key-retyped:{key}",
                            f"digest key {key!r} changed type "
                            f"{tag} -> {keys[key]} — {FIX}",
                        )
                    )
    if frame is not None and (
        dig is None or dig[0] == schema.get("digest_version")
    ):
        for key, tag in sorted(schema.get("frame_meta_keys", {}).items()):
            if key not in frame:
                out.append(
                    Violation(
                        RULE, frame_path, 1, "<module>",
                        f"frame-meta-removed:{key}",
                        f"RPC frame meta key {key!r} disappeared from "
                        f"connection.py: peers still read it — {FIX}",
                    )
                )
            elif tag != "any" and frame[key] != "any" and frame[key] != tag:
                out.append(
                    Violation(
                        RULE, frame_path, 1, "<module>",
                        f"frame-meta-retyped:{key}",
                        f"RPC frame meta key {key!r} changed type "
                        f"{tag} -> {frame[key]} — {FIX}",
                    )
                )
    cur_migr = extract_migratables(project)
    for ref_name, info in sorted(schema.get("migratable_markers", {}).items()):
        ref_mod, cls = ref_name.split(":", 1)
        mod = _in_package(project, ref_mod)
        if mod not in project.files:
            continue  # subtree lint: defining module not analyzed
        name = f"{mod}:{cls}"
        cur = cur_migr.get(name)
        if cur is None:
            out.append(
                Violation(
                    RULE, mod, 1, "<module>",
                    f"migratable-removed:{cls}",
                    f"Migratable {name} disappeared: state persisted "
                    f"under marker {info['marker']!r} becomes "
                    "undecodable — keep the class (it may delegate via "
                    "PREVIOUS) or migrate the on-disk format first",
                )
            )
        elif cur["marker"] != info["marker"] and not cur["has_previous"]:
            out.append(
                Violation(
                    RULE, mod, 1, "<module>",
                    f"migratable-marker-changed:{cls}",
                    f"Migratable {name} changed VERSION_MARKER "
                    f"{info['marker']!r} -> {cur['marker']!r} without "
                    "declaring PREVIOUS: old persisted state has no "
                    f"migration chain — {FIX}",
                )
            )
    return out


# --- crdt-mutation ------------------------------------------------------------


def _crdt_scope(rel: str) -> bool:
    p = "/" + rel
    return "/model/" in p or "/table/" in p


def _method_allowed(name: str) -> bool:
    return name in CRDT_ALLOWED_NAMES or name.startswith(CRDT_ALLOWED_PREFIXES)


def _check_crdt_mutation(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for rel, sf in project.files.items():
        if not _crdt_scope(rel):
            continue
        for cls in sf.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            meths = {
                n.name
                for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            if "merge" not in meths:
                continue
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if _method_allowed(meth.name):
                    continue
                for sub in ast.walk(meth):
                    if isinstance(sub, ast.Assign):
                        targets = sub.targets
                    elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                        targets = [sub.target]
                    else:
                        continue
                    for t in targets:
                        if not (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            continue
                        if sf.pragma_for(sub, "wire"):
                            continue
                        out.append(
                            Violation(
                                RULE, rel, sub.lineno,
                                f"{cls.name}.{meth.name}",
                                f"crdt-mutation:{cls.name}.{meth.name}:"
                                f"{t.attr}",
                                f"CRDT {cls.name} mutates self.{t.attr} "
                                f"in {meth.name}(): state on a "
                                "merge()-bearing class may only change "
                                "in __init__/merge*/update* — any other "
                                "mutation bypasses merge discipline and "
                                "diverges replicas — or "
                                "# graft-lint: allow-wire(<reason>)",
                            )
                        )
    return out
