"""Host ms a block in the codec's `np.stack` of each erasure-pattern
group during repair: the program's stage `stack` over the verify's decodes
and the rebuilds, per block whose content the round hashed (`verify_hash`)."""

from perfbench.stages import REPAIR, STORE, ms_per_block


def read(run):
    return ms_per_block(run, "stack", REPAIR, "verify_hash", STORE)
