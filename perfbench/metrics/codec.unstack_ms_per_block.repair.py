"""Host ms a block in the copies out of the decode and rebuild arrays
during repair (the decoded blocks' joins, the rebuilt pieces' `bytes()`):
the program's stage `unstack`, per block whose content the round hashed."""

from perfbench.stages import REPAIR, STORE, ms_per_block


def read(run):
    return ms_per_block(run, "unstack", REPAIR, "verify_hash", STORE)
