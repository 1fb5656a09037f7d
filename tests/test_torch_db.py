"""The port's metadata db engines (garage_tpu_torch/db) against the
reference's: one seeded sequence of tree writes, transactions (committed,
aborted with `TxAbort`, and failed with an exception) and range reads
leaves the same contents in the reference's and the port's memory,
sqlite, log and native engines.  The files are interchangeable: the port
reopens a sqlite file the reference wrote, the log and native engines
write byte-identical write-ahead logs, and each package opens the
other's.  The reference's tests/test_db.py runs on the port through
`port_mirror`, its `db` fixture pointed at the port's engines; left out
by name: `test_native_group_commit_sigkill_durability`, whose victim
process (tests/_group_commit_child.py) imports the reference, so it is
rewritten here with a victim that imports the port."""

import random
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from garage_tpu.db import TxAbort as JTxAbort
from garage_tpu.db import open_db as j_open_db
from garage_tpu_torch.db import TxAbort as TTxAbort
from garage_tpu_torch.db import open_db as t_open_db
from garage_tpu_torch.utils import config as t_config
from torch_mirror import mirrored_tests, on_cpu, port_mirror, time_limit

ROOT = Path(__file__).resolve().parents[1]
ENGINES = ["memory", "sqlite", "log", "native"]
WAL_ENGINES = ["log", "native"]
# "native-ctypes": the native engine through its ctypes binding, the one
# an interpreter without Python.h uses, held against the reference's
# native engine.
CTYPES = "native-ctypes"

_limit = time_limit(120)

TREES = ["a", "b", "rc"]


class Boom(Exception):
    pass


def drive(db, abort_cls, seed, n=300):
    """Apply the seeded op sequence; return what each read saw."""
    rng = random.Random(seed)
    trees = {name: db.open_tree(name) for name in TREES}
    seen = []
    for _ in range(n):
        op = rng.random()
        t = trees[rng.choice(TREES)]
        k = bytes([rng.randrange(12)]) + rng.randbytes(rng.randrange(3))
        v = rng.randbytes(rng.randrange(20))
        if op < 0.35:
            t.insert(k, v)
        elif op < 0.45:
            t.remove(k)
        elif op < 0.6:
            other = trees[rng.choice(TREES)]

            def tx_body(tx, t=t, other=other, k=k, v=v):
                old = tx.get(t, k)
                tx.insert(other, k, (old or b"") + v)
                tx.remove(t, k[:1])
                return tx.len(other)

            seen.append(("tx", db.transaction(tx_body)))
        elif op < 0.7:
            def aborted(tx, t=t, k=k, v=v):
                tx.insert(t, k, v)
                tx.remove(t, k[:1])
                raise abort_cls(len(v))

            seen.append(("abort", db.transaction(aborted)))
        elif op < 0.75:
            def failing(tx, t=t, k=k):
                tx.insert(t, k, b"never")
                raise Boom()

            with pytest.raises(Boom):
                db.transaction(failing)
        elif op < 0.85:
            start = bytes([rng.randrange(12)])
            seen.append(("range", list(t.iter_range(start=start, end=bytes([12]),
                                                    reverse=rng.random() < 0.5))))
        elif op < 0.92:
            seen.append(("prefix", list(t.iter_prefix(k[:1]))))
        else:
            seen.append(("get", t.get(k), t.get_gt(k), t.first(), len(t)))
    return seen


def contents(db):
    return {name: list(db.open_tree(name).iter_range()) for name in TREES}


def t_open(path: str, engine: str, **kw):
    """The port's `open_db`, or for `CTYPES` its native engine forced
    onto the ctypes binding."""
    if engine != CTYPES:
        return t_open_db(path, engine=engine, **kw)
    from garage_tpu_torch import _native
    from garage_tpu_torch.db.native_engine import NativeDb, _CtypesBinding

    db = NativeDb(path, binding=_CtypesBinding(_native.lib()), **kw)
    assert db.binding == "ctypes"
    return db


def j_engine(engine: str) -> str:
    return "native" if engine == CTYPES else engine


@pytest.mark.parametrize("engine", ENGINES + [CTYPES])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_matches_the_reference(tmp_path, engine, seed):
    jdb = j_open_db(str(tmp_path / "ref"), engine=j_engine(engine))
    tdb = t_open(str(tmp_path / "port"), engine)
    try:
        assert drive(tdb, TTxAbort, seed) == drive(jdb, JTxAbort, seed)
        assert contents(tdb) == contents(jdb)
        assert sorted(tdb.list_trees()) == sorted(jdb.list_trees())
    finally:
        jdb.close()
        tdb.close()


def test_port_reopens_a_reference_sqlite_file(tmp_path):
    jdb = j_open_db(str(tmp_path / "db"), engine="sqlite")
    drive(jdb, JTxAbort, 7)
    want = contents(jdb)
    jdb.close()
    tdb = t_open_db(str(tmp_path / "db"), engine="sqlite")
    try:
        assert contents(tdb) == want
    finally:
        tdb.close()


def _wal(tmp_path, name) -> str:
    return str(tmp_path / name / "db.log")


@pytest.mark.parametrize("engine", WAL_ENGINES + [CTYPES])
def test_wal_is_the_reference_s_byte_for_byte(tmp_path, engine):
    """The same operations leave byte-identical logs (the live log, and
    the compacted one after close), and each package reopens the
    other's file with the same rows."""
    jdb = j_open_db(_wal(tmp_path, "ref"), engine=j_engine(engine), fsync=False)
    tdb = t_open(_wal(tmp_path, "port"), engine, fsync=False)
    drive(jdb, JTxAbort, 5)
    drive(tdb, TTxAbort, 5)
    assert Path(_wal(tmp_path, "port")).read_bytes() == Path(_wal(tmp_path, "ref")).read_bytes()
    want = contents(jdb)
    jdb.close()
    tdb.close()
    ref, port = Path(_wal(tmp_path, "ref")).read_bytes(), Path(_wal(tmp_path, "port")).read_bytes()
    assert port == ref and len(port) > 0
    crossed = [t_open(_wal(tmp_path, "ref"), engine),
               j_open_db(_wal(tmp_path, "port"), engine=j_engine(engine))]
    try:
        assert [contents(db) for db in crossed] == [want, want]
    finally:
        for db in crossed:
            db.close()


@pytest.mark.parametrize("engine", ["native", CTYPES])
def test_native_scans_and_tree_names_cross_their_buffers(tmp_path, engine):
    """Scans longer than one chunk buffer, a value larger than the buffer
    (which grows it), and more tree names than the first names buffer
    holds read back as the reference's native engine reads them, through
    either binding and after a reopen."""
    rng = random.Random(3)
    rows = [(b"k%05d" % i, rng.randbytes(rng.randrange(2000, 6000))) for i in range(120)]
    rows.append((b"k00060x", rng.randbytes(600 * 1024)))
    names = [f"tree-with-a-long-name-{i:04d}" for i in range(300)]
    dbs = [j_open_db(_wal(tmp_path, "ref"), engine="native", fsync=False),
           t_open(_wal(tmp_path, "port"), engine, fsync=False)]
    for db in dbs:
        t = db.open_tree("big")
        for k, v in rows:
            t.insert(k, v)
        for name in names:
            db.open_tree(name).insert(b"x", name.encode())
    want = sorted(rows)
    for db in dbs:
        t = db.open_tree("big")
        assert list(t.iter_range()) == want
        assert list(t.iter_range(reverse=True)) == want[::-1]
        assert list(t.iter_range(start=b"k00050", end=b"k00070")) == \
            [r for r in want if b"k00050" <= r[0] < b"k00070"]
        db.close()
    ref = j_open_db(_wal(tmp_path, "ref"), engine="native")
    port = t_open(_wal(tmp_path, "port"), engine)
    try:
        assert sorted(port.list_trees()) == sorted(ref.list_trees()) == sorted(names + ["big"])
        assert list(port.open_tree("big").iter_range()) == want
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("writer, reader", [("log", "native"), ("native", "log")])
def test_wal_crosses_engines_and_packages(tmp_path, writer, reader):
    """A log the reference's `writer` engine wrote opens in the port's
    `reader` engine, and the port's writes there open in the
    reference's `writer` engine again."""
    jdb = j_open_db(_wal(tmp_path, "db"), engine=writer, fsync=False)
    drive(jdb, JTxAbort, 11)
    want = contents(jdb)
    jdb.close()
    tdb = t_open_db(_wal(tmp_path, "db"), engine=reader)
    assert contents(tdb) == want
    tdb.open_tree("a").insert(b"from-the-port", b"\x00" * 7)
    tdb.close()
    jdb = j_open_db(_wal(tmp_path, "db"), engine=writer)
    try:
        want["a"] = sorted(want["a"] + [(b"from-the-port", b"\x00" * 7)])
        assert contents(jdb) == want
    finally:
        jdb.close()


def test_native_engine_names_its_binding(tmp_path):
    from garage_tpu_torch import _native

    db = t_open_db(_wal(tmp_path, "db"), engine="native")
    try:
        assert db.binding == _native.kv_binding() in ("extension", "ctypes")
    finally:
        db.close()


# --- the reference's tests/test_db.py on the port ------------------------------


@pytest.fixture(params=ENGINES)
def db(request, tmp_path):
    """The reference's multi-engine fixture (tests/conftest.py), on the
    port's engines."""
    d = t_open_db(str(tmp_path / "db"), engine=request.param)
    yield d
    d.close()


@pytest.fixture(autouse=True)
def _nodes_on_the_cpu(monkeypatch):
    """The mirrored daemon test builds its config inside the test body:
    its nodes ask for the CPU."""
    monkeypatch.setattr(t_config, "config_from_dict", on_cpu(t_config.config_from_dict))


db_mirror = port_mirror("test_db.py", ("test_native_group_commit_sigkill_durability",))
globals().update(mirrored_tests(db_mirror, "db"))

VICTIM = """
import sys
sys.path.insert(0, sys.argv[2])
from garage_tpu_torch.db import open_db
t = open_db(sys.argv[1], engine="native", fsync="group").open_tree("gc")
i = 0
while True:
    t.insert(b"k%08d" % i, b"v" * 64)
    print(i, flush=True)
    i += 1
"""


def test_native_group_commit_sigkill_durability(tmp_path):
    """The reference's group-commit test with a victim process of the
    port: a SIGKILLed writer loses at most the flusher's window of
    acknowledged commits, and the keys that survive are a prefix."""
    path = str(tmp_path / "db.log")
    child = subprocess.Popen([sys.executable, "-c", VICTIM, path, str(ROOT)],
                             stdout=subprocess.PIPE, text=True)
    acked = -1
    t0 = time.time()
    try:
        while time.time() - t0 < 30 and acked < 3000:
            line = child.stdout.readline()
            if not line:
                break
            acked = int(line)
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait()
    assert acked >= 1000, f"child too slow, acked only {acked}"
    db = t_open_db(path, engine="native", fsync="group")
    try:
        t = db.open_tree("gc")
        n = len(t)
        assert t.get(b"k%08d" % (n - 1)) is not None
        assert t.get(b"k%08d" % n) is None
        assert n >= acked - 2000, (n, acked)
        db.sync_barrier()
        assert db.kv.sync_failures(db.h) == 0
    finally:
        db.close()
