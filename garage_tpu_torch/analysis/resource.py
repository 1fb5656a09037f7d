"""resource-discipline: invariants learned the hard way.

Two sub-rules:

**metric-pair** — a class that calls ``registry.register_gauge`` owns
per-instance metric families; its lifecycle MUST also call
``unregister_gauge`` somewhere (spawn registers, stop unregisters), or a
long-lived daemon accumulates dead families and pins dead objects via
the gauge closures (a transient repair worker's leak, the canary's
gauges).  Module-level / plain-function registrations are
process-lifetime by construction and exempt (the backend-platform
gauge, build-cache gauges).  Suppress with
``# graft-lint: allow-unpaired-metric(<reason>)`` on the register call.

**config-knob** — every ``<config>.<section>.<knob>`` read anywhere must
name a field DECLARED on that section's dataclass in utils/config.py:
declared fields are constructed, defaulted, and validated at load time
(config_from_dict), while a typo'd knob read silently evaluates to an
AttributeError at 3am.  Reads are anchored to receivers that are
plainly the config object (``cfg``/``config``/``conf`` or an attribute
called ``config``) so unrelated ``.admin``/``.repair`` attributes don't
false-positive.  Suppress with
``# graft-lint: allow-unvalidated-knob(<reason>)``.
"""

from __future__ import annotations

import ast

from .core import Project, Violation, iter_nodes_with_owner

# Config sections: field name on Config -> per-section dataclass name.
SECTION_CLASSES = {
    "s3_api": "S3ApiConfig",
    "k2v_api": "K2VApiConfig",
    "s3_web": "WebConfig",
    "admin": "AdminConfig",
    "tpu": "TpuConfig",
    "repair": "RepairPlanConfig",
    "consul_discovery": "ConsulDiscoveryConfig",
    "kubernetes_discovery": "KubernetesDiscoveryConfig",
}

CONFIG_PATH = "utils/config.py"  # inside the linted package (Project.package_path)

CONFIG_RECEIVERS = {"cfg", "config", "conf"}


def check(project: Project) -> list[Violation]:
    return _check_metric_pairs(project) + _check_knobs(project)


# --- metric-pair --------------------------------------------------------------


def _check_metric_pairs(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for rel, sf in project.files.items():
        # class name -> (register calls [(name_literal, node, owner)],
        #                has_unregister)
        classes: dict[str, tuple[list, list]] = {}

        def scan(node, cls: str | None):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    scan(child, child.name)
                    continue
                if isinstance(child, ast.Call) and isinstance(
                    child.func, ast.Attribute
                ):
                    if cls is not None:
                        regs, unregs = classes.setdefault(cls, ([], []))
                        if child.func.attr == "register_gauge":
                            regs.append(child)
                        elif child.func.attr == "unregister_gauge":
                            unregs.append(child)
                scan(child, cls)

        scan(sf.tree, None)
        for cls, (regs, unregs) in classes.items():
            if not regs or unregs:
                continue
            for call in regs:
                if sf.pragma_for(call, "unpaired-metric"):
                    continue
                fam = None
                if call.args and isinstance(call.args[0], ast.Constant):
                    fam = call.args[0].value
                out.append(
                    Violation(
                        "resource-discipline", rel, call.lineno, cls,
                        f"metric-pair:{fam or '<dynamic>'}",
                        f"class {cls} registers gauge "
                        f"{fam or '<dynamic>'} but never calls "
                        "unregister_gauge: per-instance families leak "
                        "(and pin the instance) after stop — pair the "
                        "registration or mark it "
                        "# graft-lint: allow-unpaired-metric(<reason>)",
                    )
                )
    return out


# --- config-knob --------------------------------------------------------------


def _section_fields(project: Project) -> dict[str, set[str]] | None:
    """Parse utils/config.py for the declared fields of each section
    dataclass.  None when config.py is outside the analyzed set (rule
    silently disabled rather than false-positive everywhere)."""
    sf = project.files.get(project.package_path(CONFIG_PATH))
    if sf is None:
        return None
    by_class: dict[str, set[str]] = {}
    for node in sf.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        fields: set[str] = set()
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                fields.add(stmt.target.id)
            elif isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        fields.add(t.id)
        by_class[node.name] = fields
    out: dict[str, set[str]] = {}
    for section, cls in SECTION_CLASSES.items():
        if cls in by_class:
            out[section] = by_class[cls]
    return out or None


def _is_config_receiver(node: ast.AST) -> bool:
    """True when `node` is plainly the Config object: a name cfg/config/
    conf, or any attribute chain ending in .config/.cfg."""
    if isinstance(node, ast.Name):
        return node.id in CONFIG_RECEIVERS
    if isinstance(node, ast.Attribute):
        return node.attr in CONFIG_RECEIVERS
    return False


def _check_knobs(project: Project) -> list[Violation]:
    sections = _section_fields(project)
    if sections is None:
        return []
    out: list[Violation] = []
    for rel, sf in project.files.items():
        if rel == project.package_path(CONFIG_PATH):
            continue  # the declaration site itself
        for node, owner in iter_nodes_with_owner(sf):
            # shape: <config>.<section>.<knob>
            if not (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr in sections
                and _is_config_receiver(node.value.value)
            ):
                continue
            knob = node.attr
            if knob in sections[node.value.attr]:
                continue
            if sf.pragma_for(node, "unvalidated-knob"):
                continue
            out.append(
                Violation(
                    "resource-discipline", rel, node.lineno, owner,
                    f"config-knob:{node.value.attr}.{knob}",
                    f"config knob [{node.value.attr}] {knob} is read here "
                    "but not declared on "
                    f"{SECTION_CLASSES[node.value.attr]} in "
                    "utils/config.py — undeclared knobs bypass load-time "
                    "construction/validation and raise AttributeError "
                    "at use time",
                )
            )
    return out
