"""Tiny XML response builder (reference src/api/s3/xml.rs uses serde;
here a minimal escaping tree-builder keeps responses readable)."""

from __future__ import annotations

from xml.sax.saxutils import escape

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def xml_doc(root: str, children: list, xmlns: bool = True) -> str:
    attrs = f' xmlns="{XMLNS}"' if xmlns else ""
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        f"<{root}{attrs}>{_render(children)}</{root}>"
    )


def _render(children) -> str:
    out = []
    for item in children:
        if item is None:
            continue
        name, value = item
        if name == "":
            # bare text content of the parent element (e.g. the region in
            # <LocationConstraint>garage</LocationConstraint>)
            out.append(escape(str(value)))
        elif isinstance(value, list):
            out.append(f"<{name}>{_render(value)}</{name}>")
        elif isinstance(value, bool):
            out.append(f"<{name}>{'true' if value else 'false'}</{name}>")
        else:
            out.append(f"<{name}>{escape(str(value))}</{name}>")
    return "".join(out)


def http_iso(ts_ms: int) -> str:
    """ISO-8601 object timestamp used across listings/copy results."""
    from datetime import datetime, timezone

    return datetime.fromtimestamp(ts_ms / 1000, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.000Z"
    )
