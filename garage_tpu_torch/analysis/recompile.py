"""recompile-hazard: launches that defeat the fixed-shape discipline.

The codec batcher coalesces RAGGED batches (whatever arrived during the
linger window).  ``bucket_batch``/``pad_to_bucket`` (ops/bucketing.py)
round each batch up to one of log2(max_batch) shapes, so the shapes a
node ever launches on — the allocator's cached blocks, a captured CUDA
graph's fixed buffers — stay a small fixed set however many distinct
concurrency levels the node sees.  This rule makes routing through
them mechanical.

Two sub-rules:

- **unbucketed-dispatch** — a call to one of the package's launch
  wrappers (device_model.launch_wrappers: a function that counts its
  kernel launch) where NO argument carries pad-to-bucket provenance.
  The batch-carrying tensor must flow through a recognized pad helper
  (wrapper calls preserve provenance: ``pad_to_bucket(x.to(dev), b)``
  and what is computed from it are fine); constant companions (the
  coding matrix) ride along.  A wrapper composing other wrappers on
  its caller's batch is not a dispatch site of its own, and neither is a
  function handing its own parameter straight to a wrapper (every
  argument a bare name, one of them a parameter): its caller owns the
  batch.

- **captured-branch** — Python ``if``/``while``/``for`` on a tensor's
  value, or ``bool()`` of one, inside a def run under CUDA-graph
  capture (device_model.captured_defs): reading the value synchronises
  with the card, which is illegal while a graph captures (the capture
  fails) and bakes one branch into every replay.  Tests on
  ``.shape``/``.dtype``/``.device`` and ``is None``/``is not None`` are
  host metadata and exempt.  The tensors are the def's parameters and
  its values on the card.

Suppression: ``# graft-lint: allow-recompile(<reason>)`` on the
launch/branch line — for intentionally shape-polymorphic paths.
"""

from __future__ import annotations

import ast

from .core import Project, Violation, call_repr
from .device_model import (
    SHAPE_ATTRS,
    captured_defs,
    carries_pad,
    device_names,
    launch_wrappers,
    padded_names,
    walk_no_defs,
)

RULE = "recompile-hazard"


def _branches_on(test, names: set[str]) -> str | None:
    """Name of a tensor the test reads as a VALUE (not via host
    metadata, not an `is (not) None` check), else None."""
    if isinstance(test, ast.Attribute) and test.attr in SHAPE_ATTRS:
        return None  # host metadata — do not descend
    if isinstance(test, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
    ):
        return None  # `x is None` is decided on the host
    if isinstance(test, ast.Call) and isinstance(test.func, ast.Name) and test.func.id != "bool":
        return None  # len(x), isinstance(x, ...): host calls
    if isinstance(test, ast.Name):
        return test.id if test.id in names else None
    for child in ast.iter_child_nodes(test):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        hit = _branches_on(child, names)
        if hit is not None:
            return hit
    return None


def check(project: Project) -> list[Violation]:
    out: list[Violation] = []
    wrappers = launch_wrappers(project)
    captured = captured_defs(project)

    # iterate the per-module name index, NOT project.functions: the dict
    # is keyed by (module, qualname) and silently drops duplicates (two
    # defs of one name in one scope), and both must be checked
    for mod, byname in project._by_name.items():
        sf = project.files[mod]
        seen_fns: set[int] = set()
        for fns in byname.values():
            for fn in fns:
                if id(fn) in seen_fns:
                    continue
                seen_fns.add(id(fn))

                # --- sub-rule 1: unbucketed dispatch ---------------------------
                a = fn.node.args
                params = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
                if (fn.module, fn.qualname) not in wrappers:
                    padded = None
                    for node in walk_no_defs(fn.node):
                        if not isinstance(node, ast.Call):
                            continue
                        r = call_repr(node.func)
                        target = project.resolve_call(fn, r) if r is not None else None
                        if target is None or (target.module, target.qualname) not in wrappers:
                            continue
                        args = list(node.args) + [kw.value for kw in node.keywords]
                        if not args or (
                                all(isinstance(x, ast.Name) for x in args)
                                and any(x.id in params for x in args)):
                            continue  # hands its caller's batch on: the caller dispatches
                        if padded is None:
                            padded = padded_names(fn.node)
                        if any(carries_pad(a, padded) for a in args):
                            continue
                        if sf.pragma_for(node, "recompile"):
                            continue
                        name = r.rsplit(".", 1)[-1]
                        out.append(
                            Violation(
                                RULE, mod, node.lineno, fn.qualname,
                                f"unbucketed-dispatch:{name}",
                                f"launch wrapper {name}() called without "
                                "pad-to-bucket provenance on any argument — "
                                "every distinct batch shape is a new shape "
                                "on the card (cached blocks, graph buffers); "
                                "route the batch through bucket_batch/"
                                "pad_to_bucket (ops/bucketing.py) or "
                                "# graft-lint: allow-recompile(<reason>)",
                            )
                        )

                # --- sub-rule 2: branching on tensor values under capture -------
                if (fn.module, fn.qualname) not in captured:
                    continue
                names = (params - {"self", "cls"}) | device_names(project, fn)
                for node in walk_no_defs(fn.node):
                    if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                        hit = _branches_on(node.test, names)
                    elif isinstance(node, ast.For):
                        hit = _branches_on(node.iter, names)
                    elif (isinstance(node, ast.Call) and call_repr(node.func) == "bool"
                          and len(node.args) == 1):
                        hit = _branches_on(node.args[0], names)
                    else:
                        continue
                    if hit is None or sf.pragma_for(node, "recompile"):
                        continue
                    out.append(
                        Violation(
                            RULE, mod, node.lineno, fn.qualname,
                            f"captured-branch:{hit}",
                            f"Python control flow on the value of tensor "
                            f"{hit!r} inside {fn.qualname}, which runs under "
                            "CUDA-graph capture — reading it synchronises "
                            "with the card and breaks the capture; use "
                            "torch.where/masking or decide on the host "
                            "before capture, or "
                            "# graft-lint: allow-recompile(<reason>)",
                        )
                    )
    out.sort(key=lambda v: (v.path, v.line, v.detail))
    return out
