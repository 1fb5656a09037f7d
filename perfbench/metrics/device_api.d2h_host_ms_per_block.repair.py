"""Host ms a block in the device API's copies back from the card during
repair: the program's stage `d2h` over the verify's decodes and the
rebuilds, per block whose content the round hashed."""

from perfbench.stages import REPAIR, STORE, ms_per_block


def read(run):
    return ms_per_block(run, "d2h", REPAIR, "verify_hash", STORE)
