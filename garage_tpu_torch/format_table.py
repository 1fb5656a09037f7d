"""Aligned text tables for CLI output (reference src/format-table/lib.rs:
rows are TAB-separated strings, columns padded to the widest cell)."""

from __future__ import annotations


def format_table(rows: list[str]) -> str:
    split = [r.split("\t") for r in rows]
    if not split:
        return ""
    ncols = max(len(r) for r in split)
    widths = [0] * ncols
    for r in split:
        for i, cell in enumerate(r):
            widths[i] = max(widths[i], len(cell))
    out = []
    for r in split:
        out.append(
            "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(r)).rstrip()
        )
    return "\n".join(out)
