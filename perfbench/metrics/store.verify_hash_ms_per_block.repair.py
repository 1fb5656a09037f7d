"""Host ms a block in the verification's content hash (`blake2sum` of each
decoded block in `BlockManager._verify_gathered`): the program's stage
`verify_hash`, per block it hashed."""

from perfbench.stages import STORE, ms_per_block


def read(run):
    return ms_per_block(run, "verify_hash", STORE, "verify_hash", STORE)
