"""Opcode counts in a built kernel's SASS, read with cuobjdump (card
machines only: this needs the CUDA toolkit)."""

from __future__ import annotations

import os
import re
import shutil
import subprocess

# int32 opcodes whose counts the kernels' bounds use, and shared-memory loads
COUNTED = ("IADD3", "IMAD", "LOP3", "SHF", "PRMT", "LDS")


def _tool() -> str | None:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return tool if os.path.exists(tool) else None


def _counts(part: str) -> dict[str, int]:
    ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9.]*)", part)
    names = [op if op.startswith(("IMAD", "LDS")) else op.split(".")[0] for op in ops]
    return {op: names.count(op) for op in sorted(set(names)) if op.split(".")[0] in COUNTED}


def sass_text(so_path) -> str | None:
    """cuobjdump's SASS listing of `so_path`; None where it is missing."""
    tool = _tool()
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", str(so_path)],
                          capture_output=True, text=True, check=True).stdout


def all_functions(so_path) -> dict[str, dict[str, int]] | None:
    """{mangled kernel name: `sass_int_ops` counts} for every function in
    `so_path`; None where cuobjdump is missing."""
    sass = sass_text(so_path)
    if sass is None:
        return None
    return {part.splitlines()[0].strip(): _counts(part)
            for part in sass.split("Function : ")[1:]}


def sass_int_ops(so_path, kernel: str) -> dict[str, int] | None:
    """Counts of the int32 opcodes (IADD3, IMAD, LOP3, SHF, PRMT) and the
    shared-memory loads (LDS) in the SASS of the first function of
    `so_path` whose name contains `kernel`; IMAD and LDS by their full
    names, since IMAD.IADD is an add and IMAD.MOV a move, and LDS.64
    moves two words.  None where cuobjdump is missing; LookupError where
    no function matches."""
    funcs = all_functions(so_path)
    if funcs is None:
        return None
    for name, counts in funcs.items():
        if kernel in name:
            return counts
    raise LookupError(f"{kernel} not found in the SASS of {so_path}")


def per_compression(ops: dict[str, int]) -> dict[str, float]:
    """A BLAKE3 kernel's counts divided by the compression bodies its SASS
    holds: each body has 224 rotates (SHF or PRMT), so the bodies are
    (SHF + PRMT) / 224, rounded; the few shifts of address arithmetic
    do not move the rounding."""
    bodies = round((ops.get("SHF", 0) + ops.get("PRMT", 0)) / 224)
    if bodies == 0:
        raise ValueError(f"no compression body in {ops}")
    out = {op: n / bodies for op, n in ops.items()}
    out["bodies"] = bodies
    return out
