"""The port's metadata db engines (garage_tpu_torch/db) against the
reference's: one seeded sequence of tree writes, transactions (committed,
aborted with `TxAbort`, and failed with an exception) and range reads
leaves the same contents in the reference's and the port's memory and
sqlite engines.  The sqlite files are interchangeable: the port reopens
a file the reference wrote.  The log and native engines are not ported
yet, and `open_db` says so."""

import random

import pytest

from garage_tpu.db import TxAbort as JTxAbort
from garage_tpu.db import open_db as j_open_db
from garage_tpu_torch.db import TxAbort as TTxAbort
from garage_tpu_torch.db import open_db as t_open_db

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


@pytest.mark.parametrize("engine", ["memory", "sqlite"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_matches_the_reference(tmp_path, engine, seed):
    jdb = j_open_db(str(tmp_path / "ref"), engine=engine)
    tdb = t_open_db(str(tmp_path / "port"), engine=engine)
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


@pytest.mark.parametrize("engine", ["log", "native"])
def test_unported_engines_are_named(tmp_path, engine):
    with pytest.raises(ValueError, match="not yet ported"):
        t_open_db(str(tmp_path / "db"), engine=engine)
