"""The port's operator surface (garage_tpu_torch/cli, format_table,
utils/log_fmt, model/repair) held to the reference on the CPU.

  - the reference's admin-op scenarios (tests/test_admin_ops.py) and its
    cluster-telemetry tests (tests/test_cluster_telemetry.py) run on port
    nodes through `port_mirror`, each node asking for the CPU.  None is
    left out; `test_block_ops` runs in tests/test_torch_left_out_mirror.py
    under a time limit of its own (`torch_mirror.RUN_APART`);
  - the port's argparse tree is the reference's: every subcommand,
    argument, default, choice and help text;
  - `format_table` and the log formatters give the reference's bytes on
    seeded inputs;
  - the AdminRpc bodies a CLI reads (`status`, `layout-show`,
    `bucket-info`, `key-info`, `stats`) from a reference node and a port
    node with the same node key and the same imported key are equal once
    the random bucket id and the telemetry digest's live readings are
    masked.  The one difference
    kept on purpose: the port's `tpuProbe` is always null (it banks no
    device-probe profile).

Tolerance: zero for bytes and rendered tables.
"""

import argparse
import asyncio
import logging
import random
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from torch_mirror import (assert_mirror_whole, differences, masked, mirrored_tests, port_mirror,
                          time_limit, twin_node)

torch.set_num_threads(1)  # one thread per suite worker

_limit = time_limit(90)

admin_ops_mirror = port_mirror("test_admin_ops.py")
globals().update(mirrored_tests(admin_ops_mirror, "admin_ops"))
telemetry_mirror = port_mirror("test_cluster_telemetry.py")
globals().update(mirrored_tests(telemetry_mirror, "cluster_telemetry"))


def run(coro, limit=60):
    return asyncio.run(asyncio.wait_for(coro, limit))


def test_mirrors_hold_every_reference_scenario():
    assert_mirror_whole("test_admin_ops.py", admin_ops_mirror, (), 7)
    assert_mirror_whole("test_cluster_telemetry.py", telemetry_mirror, (), 12)


# --- the argparse tree --------------------------------------------------------------


def parser_tree(main) -> dict:
    """The parser `main` builds, as nested plain data: every action with
    its option strings, dest, nargs, default, type, choices, required flag
    and help, subparsers recursively, and the mutually exclusive groups."""

    class Built(Exception):
        pass

    grabbed = []

    def grab(self, *a, **kw):
        grabbed.append(self)
        raise Built

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(Built):
            main([])

    def describe(p: argparse.ArgumentParser) -> dict:
        acts = []
        for a in p._actions:
            d = {k: getattr(a, k) for k in ("option_strings", "dest", "nargs", "const",
                                            "default", "type", "required", "help", "metavar")}
            d["kind"] = type(a).__name__
            if isinstance(a, argparse._SubParsersAction):
                d["choices"] = {n: describe(sp) for n, sp in a.choices.items()}
            else:
                d["choices"] = a.choices
            acts.append(d)
        groups = [([a.dest for a in g._group_actions], g.required)
                  for g in p._mutually_exclusive_groups]
        return {"prog": p.prog, "description": p.description, "actions": acts, "groups": groups}

    return describe(grabbed[0])


def _walk(tree: dict, path=()):
    """Every subcommand path of a parser tree."""
    yield path
    for a in tree["actions"]:
        if a["kind"] == "_SubParsersAction":
            for name, sub in a["choices"].items():
                yield from _walk(sub, path + (name,))


def test_argparse_tree_equals_the_reference():
    from garage_tpu.cli.main import main as ref_main
    from garage_tpu_torch.cli.main import main as port_main

    ref, port = parser_tree(ref_main), parser_tree(port_main)
    assert port == ref
    paths = set(_walk(port))
    # the subcommands a daemon and its operators use, down to the leaves
    for p in [("server",), ("node",), ("layout", "assign"), ("layout", "apply"),
              ("key", "new"), ("bucket", "create"), ("bucket", "allow"),
              ("bucket", "website"), ("repair",), ("cluster", "durability"),
              ("convert-db",), ("offline-repair",)]:
        assert p in paths, p
    assert len(paths) > 50


# --- format_table and log_fmt -------------------------------------------------------


def _words(rng: random.Random, n: int) -> str:
    return "".join(rng.choice("abcdefghij XYZ-_./0123456789") for _ in range(n))


def test_format_table_is_byte_equal_to_the_reference():
    from garage_tpu.format_table import format_table as ref_table
    from garage_tpu_torch.format_table import format_table as port_table

    rng = random.Random(8)
    cases = [[], [""], ["a"], ["a\tb", "ccc"], ["x\t\ty", "\t\t"]]
    for _ in range(200):
        cases.append(["\t".join(_words(rng, rng.randrange(0, 14))
                                for _ in range(rng.randrange(1, 7)))
                      for _ in range(rng.randrange(0, 9))])
    for rows in cases:
        assert port_table(rows) == ref_table(rows), rows


def _records(rng: random.Random) -> list[logging.LogRecord]:
    out = []
    for i in range(60):
        rec = logging.LogRecord(
            f"garage.{_words(rng, 5)}", rng.choice([10, 20, 30, 40, 50]), "x.py", i,
            _words(rng, rng.randrange(0, 40)) + " %s", (rng.randrange(1000),), None)
        rec.created = 1.7e9 + rng.random() * 1e6
        rec.msecs = (rec.created % 1) * 1000
        out.append(rec)
    try:
        raise ValueError("seeded failure")
    except ValueError:
        import sys
        rec = logging.LogRecord("garage.exc", 40, "x.py", 1, "with exc", (), sys.exc_info())
        rec.created, rec.msecs = 1.7e9, 0.0
        out.append(rec)
    return out


@pytest.mark.parametrize("traced", [False, True])
def test_log_fmt_is_byte_equal_to_the_reference(traced):
    import garage_tpu.utils.log_fmt as ref_fmt
    import garage_tpu.utils.tracing as ref_tracing
    import garage_tpu_torch.utils.log_fmt as port_fmt
    import garage_tpu_torch.utils.tracing as port_tracing

    span = SimpleNamespace(trace_id=bytes(range(16)), span_id=bytes(range(8, 16))) \
        if traced else None
    lines = {}
    for name, fmt, tracing in (("ref", ref_fmt, ref_tracing), ("port", port_fmt, port_tracing)):
        with mock.patch.object(tracing.tracer, "current", lambda: span):
            got = []
            for rec in _records(random.Random(5)):
                fmt.TraceContextFilter().filter(rec)
                got.append(fmt.TextFormatter().format(rec))
                got.append(fmt.JsonLinesFormatter().format(rec))
            lines[name] = got
    assert lines["port"] == lines["ref"]
    assert any("[trace=" in ln for ln in lines["port"]) == traced


def test_setup_logging_installs_one_marked_handler():
    from garage_tpu_torch.utils.log_fmt import JsonLinesFormatter, setup_logging

    root = logging.getLogger()
    before = list(root.handlers)
    level = root.level
    try:
        setup_logging("json", "WARNING")
        setup_logging("json", "WARNING")  # idempotent
        ours = [h for h in root.handlers if getattr(h, "_garage_log_fmt", False)]
        assert len(ours) == 1 and isinstance(ours[0].formatter, JsonLinesFormatter)
        assert root.level == logging.WARNING
    finally:
        for h in list(root.handlers):
            if h not in before:
                root.removeHandler(h)
        root.setLevel(level)


# --- AdminRpc bodies from twin nodes ------------------------------------------------

KEY_ID, SECRET = "GK" + "1f" * 12, "2e" * 32
RPC_OPS = [("status", {}), ("layout-show", {}), ("bucket-info", {"name": "twin-bucket"}),
           ("key-info", {"key": KEY_ID}), ("stats", {})]


async def admin_bodies(pkg: str, root: Path, node_key: bytes) -> tuple[dict, str]:
    from importlib import import_module

    Req = import_module(f"{pkg}.net.message").Req
    garage, adm = await twin_node(pkg, root, node_key)

    async def rpc(op, args=None):
        return (await adm._handle(b"\x00" * 32, Req([op, args or {}]))).body

    try:
        out = {"key-import": await rpc("key-import", {"key_id": KEY_ID, "secret": SECRET,
                                                       "name": "twin"}),
               "bucket-create": await rpc("bucket-create", {"name": "twin-bucket"}),
               "bucket-allow": await rpc("bucket-allow", {"bucket": "twin-bucket",
                                                          "key": KEY_ID, "read": True,
                                                          "write": True, "owner": True})}
        for op, a in RPC_OPS:
            out[op] = await rpc(op, a)
        return out, out["bucket-create"]["id"]
    finally:
        await garage.stop()


def shape(doc):
    """`doc` with every reading (a number, or None before the first
    sample) replaced by "<reading>"."""
    if isinstance(doc, dict):
        return {k: shape(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [shape(v) for v in doc]
    if doc is None or isinstance(doc, (int, float)) and not isinstance(doc, bool):
        return "<reading>"
    return doc


def test_admin_rpc_bodies_equal_the_reference(tmp_path):
    node_key = random.Random(11).randbytes(32)
    # the platforms a codec has served (the digest's `tpu.plat`) are
    # process-wide: each twin starts from none, as a node's own process
    # does, whatever earlier tests in this worker dispatched
    with mock.patch("garage_tpu.ops.telemetry._platforms_seen", set()), \
            mock.patch("garage_tpu_torch.ops.telemetry._platforms_seen", set()):
        ref, ref_bucket = run(admin_bodies("garage_tpu", tmp_path, node_key))
        port, port_bucket = run(admin_bodies("garage_tpu_torch", tmp_path, node_key))
    assert port["status"]["node_id"] == ref["status"]["node_id"]
    # kept on purpose: the port banks no device-probe profile
    assert port["stats"].pop("tpuProbe") is None
    ref["stats"].pop("tpuProbe")
    # the local telemetry digest holds live readings (uptime, loop lag,
    # rates): its keys and value kinds must agree, not the readings.  The
    # tenant and traffic observatories are process-wide, so they carry
    # the traffic of earlier tests in this process: only their presence
    # is compared
    for body in (ref, port):
        tm = body["stats"]["telemetry"]
        for section in ("tn", "trf"):
            tm[section] = type(tm.pop(section)).__name__
        body["stats"]["telemetry"] = shape(tm)
    assert not differences(masked(port, {port_bucket: "<bucket>"}),
                           masked(ref, {ref_bucket: "<bucket>"}))
    assert port["key-info"]["key_id"] == KEY_ID
    assert port["key-info"]["buckets"] == [port_bucket]  # the key was allowed
    assert port["bucket-info"]["aliases"] == ["twin-bucket"]


def test_cli_renders_the_same_tables_from_the_same_bodies(tmp_path):
    """`dispatch` of both CLIs over the same AdminRpc bodies prints the same
    text, for every op a CLI call of phase 9 of chip_smoke.py makes."""
    from garage_tpu.cli.main import dispatch as ref_dispatch
    from garage_tpu_torch.cli.main import dispatch as port_dispatch

    node_key = random.Random(12).randbytes(32)
    bodies, _bucket = run(admin_bodies("garage_tpu_torch", tmp_path, node_key))

    async def call(op, args=None):
        return bodies[op]

    def ns(**kw):
        return SimpleNamespace(json=False, **kw)

    for args in (ns(cmd="status"), ns(cmd="stats")):
        ref = asyncio.run(ref_dispatch(args, call, None))
        port = asyncio.run(port_dispatch(args, call, None))
        assert port == ref and "====" in port
