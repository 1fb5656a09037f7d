"""Shared device model for the accelerator rule families (torch/CUDA).

The four accelerator families (host-sync, recompile-hazard,
use-after-donation, backend-gate) need three facts about a function
that the name-resolved call graph in `core.py` does not carry by
itself:

  1. **Which local names hold a tensor on the card.**  The results of
     the package's kernel wrappers — the functions of ops/ec_cuda.py,
     ops/hash_cuda.py and models/pipeline.py annotated to return a
     tensor, and every launch wrapper (`launch_wrappers`: a function
     whose launches ``count_launch(<wrapper>)`` counts) — and tensors
     placed by ``.to(<device>)``, ``.cuda()`` or ``torch.*(...,
     device=...)``.  `device_names` follows them through
     simple assignments (a name, a subscript, tuple unpacks).

  2. **Which values carry pad-to-bucket provenance.**  The fixed-shape
     discipline pads the batch axis through a recognized helper
     (``bucket_batch`` / ``pad_to_bucket`` / ``pad_to_multiple``,
     matched on the last name segment with leading underscores
     stripped; ops/bucketing.py) so one shape serves every ragged
     batch.  `carries_pad` follows the value through wrapper calls
     (``pad_to_bucket(x.to(dev), b)`` and what is computed from it)
     and simple assignments.

  3. **Which defs are captured.**  Callables run under CUDA-graph
     capture: called inside ``with torch.cuda.graph(...)`` or between a
     ``capture_begin()`` and its ``capture_end()``, handed to a function
     that calls that parameter under capture (tools/timing.py
     `graph_ms`), or handed to ``torch.cuda.make_graphed_callables``.
     Python branching on a tensor's value in such a def synchronises
     with the card, which breaks the capture — the counterpart of a
     traced def's control flow (recompile-hazard's second sub-rule).

Everything here is approximate by design (no type inference): the model
errs toward silence — a value it cannot show to be on the card, or a
callable it cannot resolve, is not reported on.
"""

from __future__ import annotations

import ast

from .core import FunctionInfo, Project, call_repr, walk_no_defs

__all__ = [
    "PLATFORM_STRINGS", "SHAPE_ATTRS", "PAD_LASTS", "KERNEL_MODULES", "walk_no_defs",
    "launch_wrappers", "device_returning", "device_names", "is_devish", "is_host_copy",
    "carries_pad", "padded_names", "captured_defs", "last_segment",
]

# platform strings a backend-conditional compares against
PLATFORM_STRINGS = {"cpu", "tpu", "gpu", "cuda", "rocm", "metal", "mps", "xpu"}

# attribute reads that are host metadata of a tensor: no synchronisation
SHAPE_ATTRS = {
    "shape", "ndim", "dtype", "size", "nbytes", "itemsize", "device", "is_cuda",
    "layout", "dim", "numel", "stride", "is_contiguous", "data_ptr", "element_size",
}

# recognized pad-to-bucket helpers, matched on the final name segment
# with leading underscores stripped ("_pad_batch" == "pad_batch")
PAD_LASTS = {
    "pad_batch", "pad_to_bucket", "pad_to_multiple", "pad_for_mesh",
    "bucket_batch",
}

# the package's kernel modules, inside the linted package
KERNEL_MODULES = ("ops/ec_cuda.py", "ops/hash_cuda.py", "models/pipeline.py")

COUNT_LAUNCH_LAST = "count_launch"

# calls whose result is a host copy of a tensor (their receiver syncs)
HOST_COPY_LASTS = {"cpu", "numpy", "tolist", "item"}


def last_segment(repr_: str) -> str:
    return repr_.rsplit(".", 1)[-1].lstrip("_")


def _is_pad_call(call: ast.Call) -> bool:
    r = call_repr(call.func)
    return r is not None and last_segment(r) in PAD_LASTS


def _is_cpu_literal(node) -> bool:
    """"cpu", "cpu:0" or torch.device("cpu")."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and (call_repr(node.func) or "").endswith("device"):
        return bool(node.args) and _is_cpu_literal(node.args[0])
    return False


def _names_a_device(node) -> bool:
    """Does `node` plainly name a device: a "cuda…" literal, a
    ``torch.device(...)`` call, or a name/attribute whose last segment
    says dev/device?"""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cuda"
    if isinstance(node, ast.Call):
        return (call_repr(node.func) or "").endswith("device") and not _is_cpu_literal(node)
    if isinstance(node, (ast.Name, ast.Attribute)):
        name = node.id if isinstance(node, ast.Name) else node.attr
        return "dev" in name.lower()
    return False


def _to_target(call: ast.Call):
    """The device argument of ``x.to(...)``: the first positional or
    ``device=``; None for anything else."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return None
    if call.args:
        return call.args[0]
    return next((kw.value for kw in call.keywords if kw.arg == "device"), None)


def is_host_copy(call: ast.Call) -> bool:
    """``x.cpu()``, ``x.numpy()``, ``x.tolist()``, ``x.item()`` or
    ``x.to("cpu")``: a call whose result is on the host."""
    if isinstance(call.func, ast.Attribute) and call.func.attr in HOST_COPY_LASTS:
        return True
    target = _to_target(call)
    return target is not None and _is_cpu_literal(target)


# --- launch wrappers and device-returning functions ---------------------------


def launch_wrappers(project: Project) -> set[tuple[str, str]]:
    """(module, qualname) of every launch wrapper: each function named
    by a ``count_launch(<wrapper>)`` call (the wrapper counts its own
    launches, or a private helper counts them on its behalf)."""
    cache = getattr(project, "_launch_wrappers", None)
    if cache is not None:
        return cache
    out: set[tuple[str, str]] = set()
    for fn in project.functions.values():
        for node in walk_no_defs(fn.node):
            if not (isinstance(node, ast.Call) and node.args
                    and last_segment(call_repr(node.func) or "") == COUNT_LAUNCH_LAST
                    and isinstance(node.args[0], ast.Name)):
                continue
            target = project.resolve_call(fn, node.args[0].id)
            if target is not None:
                out.add((target.module, target.qualname))
    project._launch_wrappers = out
    return out


def device_returning(project: Project) -> set[tuple[str, str]]:
    """Launch wrappers, plus the functions of the kernel modules whose
    return annotation names a tensor."""
    cache = getattr(project, "_device_returning", None)
    if cache is not None:
        return cache
    kernel_mods = {project.package_path(m) for m in KERNEL_MODULES}
    out = set(launch_wrappers(project))
    for key, fn in project.functions.items():
        ret = getattr(fn.node, "returns", None)
        if fn.module in kernel_mods and ret is not None and "Tensor" in ast.unparse(ret):
            out.add(key)
    project._device_returning = out
    return out


# --- device values --------------------------------------------------------------


def _is_device_call(project: Project, fn: FunctionInfo, call: ast.Call) -> bool:
    """A call whose result is a tensor on the card: a placement
    (``.to(<device>)``, ``.cuda()``, ``torch.*(..., device=...)``) or a
    call that resolves to a device-returning function."""
    r = call_repr(call.func)
    if isinstance(call.func, ast.Attribute) and call.func.attr == "cuda" and not call.args:
        return True
    target = _to_target(call)
    if target is not None:
        return _names_a_device(target)
    if r is None:
        return False
    if r.startswith("torch.") and not r.startswith("torch.cuda."):
        for kw in call.keywords:
            if kw.arg == "device" and not _is_cpu_literal(kw.value):
                return True
    target = project.resolve_call(fn, r)
    return target is not None and (target.module, target.qualname) in device_returning(project)


def _is_device_source(project, fn, value, dev: set[str]) -> bool:
    if isinstance(value, ast.Call):
        return _is_device_call(project, fn, value)
    if isinstance(value, ast.Name):
        return value.id in dev
    if isinstance(value, ast.Subscript):
        return _is_device_source(project, fn, value.value, dev)
    return False


def device_names(project: Project, fn: FunctionInfo) -> set[str]:
    """Local names of `fn` holding (likely) tensors on the card."""
    dev: set[str] = set()
    for _ in range(2):  # fixed point over simple assignment chains
        for node in walk_no_defs(fn.node):
            if not isinstance(node, ast.Assign):
                continue
            if not _is_device_source(project, fn, node.value, dev):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    dev.add(t.id)
                elif isinstance(t, ast.Tuple):
                    dev.update(e.id for e in t.elts if isinstance(e, ast.Name))
    return dev


def is_devish(project: Project, fn: FunctionInfo, expr, dev: set[str]) -> bool:
    """Is `expr` (an argument/receiver) a tensor on the card: a tracked
    name, a device call, or an expression computed from one
    (``out[:b]``, ``x.sum()``)?  Host metadata (``x.shape[0]``), host
    copies (``x.cpu()``) and plain-function calls (``len(x)``) are
    not."""
    if isinstance(expr, ast.Name):
        return expr.id in dev
    if isinstance(expr, ast.Attribute) and expr.attr in SHAPE_ATTRS:
        return False
    if isinstance(expr, ast.Call):
        if _is_device_call(project, fn, expr):
            return True
        if is_host_copy(expr) or isinstance(expr.func, ast.Name):
            return False
    for child in ast.iter_child_nodes(expr):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if is_devish(project, fn, child, dev):
            return True
    return False


# --- pad provenance -------------------------------------------------------------


def carries_pad(expr, padded: set[str]) -> bool:
    """Does evaluating `expr` yield a value with pad-to-bucket
    provenance?  Pad-helper calls are sources; other calls PRESERVE
    provenance from their arguments and receivers; names propagate via
    `padded_names`."""
    if isinstance(expr, ast.Call):
        if _is_pad_call(expr):
            return True
        parts = list(expr.args) + [kw.value for kw in expr.keywords]
        if isinstance(expr.func, ast.Attribute):
            parts.append(expr.func.value)
        return any(carries_pad(a, padded) for a in parts)
    if isinstance(expr, ast.Name):
        return expr.id in padded
    for child in ast.iter_child_nodes(expr):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if carries_pad(child, padded):
            return True
    return False


def padded_names(fn_node) -> set[str]:
    """Names assigned (directly or through wrapper calls / simple
    chains) from a pad-to-bucket helper inside one function."""
    padded: set[str] = set()
    for _ in range(2):  # fixed point over simple assignment chains
        for node in walk_no_defs(fn_node):
            if not isinstance(node, ast.Assign):
                continue
            if not carries_pad(node.value, padded):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    padded.add(t.id)
                elif isinstance(t, ast.Tuple):
                    padded.update(e.id for e in t.elts if isinstance(e, ast.Name))
    return padded


# --- captured defs --------------------------------------------------------------


def _is_capture_ctx(expr) -> bool:
    """``torch.cuda.graph(g)`` (or ``cuda.graph(g)``) as a with item."""
    if not isinstance(expr, ast.Call):
        return False
    r = call_repr(expr.func) or ""
    return r == "cuda.graph" or r.endswith(".cuda.graph")


def _calls_in(stmts) -> list[ast.Call]:
    out = []
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(stmt, ast.Call):
            out.append(stmt)
        out += [n for n in walk_no_defs(stmt) if isinstance(n, ast.Call)]
    return out


def _captured_calls(fn: FunctionInfo) -> list[ast.Call]:
    """Calls `fn` makes while a CUDA graph captures: inside a
    ``with torch.cuda.graph(...)`` body, or after a ``capture_begin()``
    statement and before the ``capture_end()`` of the same block."""
    out: list[ast.Call] = []
    for node in [fn.node, *walk_no_defs(fn.node)]:
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
            _is_capture_ctx(item.context_expr) for item in node.items
        ):
            out += _calls_in(node.body)
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            capturing = False
            for stmt in stmts:
                call = stmt.value if isinstance(stmt, ast.Expr) else None
                tail = (call_repr(call.func) or "").rsplit(".", 1)[-1] if isinstance(
                    call, ast.Call) else ""
                if tail == "capture_begin":
                    capturing = True
                elif tail == "capture_end":
                    capturing = False
                elif capturing:
                    out += _calls_in([stmt])
    return out


def _function_named(project: Project, fn: FunctionInfo, name: str) -> FunctionInfo | None:
    """A def `name` as seen from `fn`: nested in it, or resolved by name."""
    nested = project.functions.get((fn.module, f"{fn.qualname}.{name}"))
    return nested if nested is not None else project.resolve_call(fn, name)


def captured_defs(project: Project) -> set[tuple[str, str]]:
    """(module, qualname) of every def run under CUDA-graph capture."""
    out: set[tuple[str, str]] = set()
    capturing: dict[tuple[str, str], set[int]] = {}  # fn -> positions it calls under capture

    for key, fn in project.functions.items():
        a = fn.node.args
        params = [p.arg for p in a.posonlyargs + a.args if p.arg not in ("self", "cls")]
        for call in _captured_calls(fn):
            r = call_repr(call.func)
            if r is None:
                continue
            if r in params:
                capturing.setdefault(key, set()).add(params.index(r))
                continue
            target = _function_named(project, fn, r) if "." not in r else \
                project.resolve_call(fn, r)
            if target is not None:
                out.add((target.module, target.qualname))
        for node in walk_no_defs(fn.node):
            if (isinstance(node, ast.Call)
                    and (call_repr(node.func) or "").endswith("make_graphed_callables")
                    and node.args and isinstance(node.args[0], ast.Name)):
                target = _function_named(project, fn, node.args[0].id)
                if target is not None:
                    out.add((target.module, target.qualname))

    for fn in project.functions.values():
        for node in walk_no_defs(fn.node):
            if not isinstance(node, ast.Call):
                continue
            r = call_repr(node.func)
            target = project.resolve_call(fn, r) if r is not None else None
            if target is None:
                continue
            for pos in capturing.get((target.module, target.qualname), ()):
                if pos < len(node.args) and isinstance(node.args[pos], ast.Name):
                    hit = _function_named(project, fn, node.args[pos].id)
                    if hit is not None:
                        out.add((hit.module, hit.qualname))
    return out
