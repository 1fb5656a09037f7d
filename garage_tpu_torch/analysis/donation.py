"""use-after-donation: a tensor's memory reclaimed while the card may
still read it.

Torch has no buffer donation; the hazard of the same class on CUDA is
cross-stream lifetime.  The caching allocator ties each block to the
stream it was allocated on.  A tensor allocated on one stream (the
current stream, outside the block) and used inside
``with torch.cuda.stream(s):`` is read by work queued on ``s``:

  - unless ``s`` waits for the allocating stream
    (``s.wait_stream(...)``), that work can read the tensor before the
    kernels that fill it have run;
  - unless the tensor is marked used on ``s`` (``t.record_stream(s)``),
    dropping the last Python reference hands its memory back to the
    allocating stream at once, and the next allocation there can
    overwrite it while ``s`` still reads it.

Neither shows on the CPU, where there are no streams: tier-1 stays
green while the card reads garbage.

**cross-stream-use** — a tensor on the card (device_model) bound
outside a ``with torch.cuda.stream(...)`` block, read inside it, in a
function that has neither a ``wait_stream`` on that stream nor a
``record_stream`` of that tensor.  ``parallel/mesh.py`` (`Mesh.map`,
`Mesh.join`) is the pattern: every entry's stream waits for the
current stream before its work, and every result is marked used by the
stream that reads it.

Suppression: ``# graft-lint: allow-donation(<reason>)`` on the
``with`` line or the reading line.
"""

from __future__ import annotations

import ast

from .core import Project, Violation, call_repr
from .device_model import device_names, walk_no_defs

RULE = "use-after-donation"


def _stream_of(item: ast.withitem) -> str | None:
    """The stream expression of ``torch.cuda.stream(<s>)``, rendered."""
    expr = item.context_expr
    if not isinstance(expr, ast.Call) or not expr.args:
        return None
    r = call_repr(expr.func) or ""
    if r != "cuda.stream" and not r.endswith(".cuda.stream"):
        return None
    return ast.unparse(expr.args[0])


def _ordering(fn_node) -> tuple[set[str], set[str]]:
    """(streams that wait_stream on something, tensors record_stream'd)
    anywhere in the function."""
    waits, recorded = set(), set()
    for node in walk_no_defs(fn_node):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr == "wait_stream":
                waits.add(ast.unparse(node.func.value))
            elif node.func.attr == "record_stream":
                recorded.add(ast.unparse(node.func.value))
    return waits, recorded


def check(project: Project) -> list[Violation]:
    out: list[Violation] = []
    for fn in project.functions.values():
        blocks = [
            (node, stream) for node in walk_no_defs(fn.node)
            if isinstance(node, (ast.With, ast.AsyncWith))
            for stream in map(_stream_of, node.items) if stream is not None
        ]
        if not blocks:
            continue
        dev = device_names(project, fn)
        if not dev:
            continue
        sf = project.files[fn.module]
        waits, recorded = _ordering(fn.node)
        for block, stream in blocks:
            bound_inside = {
                t.id for n in walk_no_defs(block) if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Name)
            }
            reads = sorted({
                (n.id, n.lineno) for stmt in block.body
                for n in [stmt, *walk_no_defs(stmt)]
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                and n.id in dev and n.id not in bound_inside
            }, key=lambda x: (x[1], x[0]))
            done: set[str] = set()
            for name, line in reads:
                if name in done or stream in waits or name in recorded:
                    continue
                done.add(name)
                if sf.pragma_for(block, "donation"):
                    break

                class _At:  # minimal node shim for pragma_for
                    lineno = line
                    end_lineno = line

                if sf.pragma_for(_At, "donation"):
                    continue
                out.append(
                    Violation(
                        RULE, fn.module, line, fn.qualname,
                        f"cross-stream-use:{stream}:{name}",
                        f"tensor {name!r} is read under stream {stream} but "
                        "was allocated outside it, and neither "
                        f"{stream}.wait_stream(...) orders it nor "
                        f"{name}.record_stream({stream}) keeps its memory "
                        "from the allocating stream — the card can read it "
                        "before it is written, or after it is reused; add "
                        "both (parallel/mesh.py) or "
                        "# graft-lint: allow-donation(<reason>)",
                    )
                )
    out.sort(key=lambda v: (v.path, v.line, v.detail))
    return out
