"""Per-block reference counts (reference src/block/rc.rs).

The block_ref table's `updated()` hook increments/decrements these
transactionally with the metadata write.  When a count reaches zero the
block is not deleted immediately: a deletion marker with a deadline
(BLOCK_GC_DELAY, 10 min) is stored, and resync offloads/deletes after the
delay — protecting against the reordering where a concurrent PutObject
re-references the block.

Tree values: 8-byte big-endian count, or b"del" + 8-byte deadline msec.
"""

from __future__ import annotations

from ..db import Db, Tx
from ..utils.time_util import now_msec

BLOCK_GC_DELAY_MS = 10 * 60 * 1000


class BlockRc:
    def __init__(self, db: Db):
        self.db = db
        self.tree = db.open_tree("block_rc")

    # --- transactional ops (called from table updated() hooks) ---------------

    def incr(self, tx: Tx, hash32: bytes) -> bool:
        """Returns True if the block became referenced (0 -> 1)."""
        cur = self._get_tx(tx, hash32)
        newly = cur == 0
        tx.insert(self.tree, hash32, (cur + 1).to_bytes(8, "big"))
        return newly

    def decr(self, tx: Tx, hash32: bytes) -> bool:
        """Returns True if the block became unreferenced (rc -> 0)."""
        cur = self._get_tx(tx, hash32)
        if cur <= 1:
            deadline = now_msec() + BLOCK_GC_DELAY_MS
            tx.insert(self.tree, hash32, b"del" + deadline.to_bytes(8, "big"))
            return True
        tx.insert(self.tree, hash32, (cur - 1).to_bytes(8, "big"))
        return False

    def _get_tx(self, tx: Tx, hash32: bytes) -> int:
        raw = tx.get(self.tree, hash32)
        return _count(raw)

    # --- queries -------------------------------------------------------------

    def get(self, hash32: bytes) -> int:
        return _count(self.tree.get(hash32))

    def is_deletable(self, hash32: bytes) -> bool:
        """rc is zero and the deletion delay has passed."""
        raw = self.tree.get(hash32)
        if raw is None:
            return True
        if raw.startswith(b"del"):
            return int.from_bytes(raw[3:11], "big") <= now_msec()
        return False

    def is_needed(self, hash32: bytes) -> bool:
        return _count(self.tree.get(hash32)) > 0

    def clear_deleted(self, hash32: bytes) -> None:
        """Drop an EXPIRED deletion marker (housekeeping after the file is
        gone).  Markers still inside their delay window are kept — they are
        the race protection against concurrent re-uploads (reference
        src/block/rc.rs clear_deleted_block_rc)."""
        raw = self.tree.get(hash32)
        if (
            raw is not None
            and raw.startswith(b"del")
            and int.from_bytes(raw[3:11], "big") <= now_msec()
        ):
            self.tree.remove(hash32)


def _count(raw: bytes | None) -> int:
    if raw is None or raw.startswith(b"del"):
        return 0
    return int.from_bytes(raw[:8], "big")
