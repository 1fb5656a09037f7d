"""Host ms a block in the device API's copies to the card during repair:
the program's stage `h2d` over the verify's decodes and the rebuilds, per
block whose content the round hashed."""

from perfbench.stages import REPAIR, STORE, ms_per_block


def read(run):
    return ms_per_block(run, "h2d", REPAIR, "verify_hash", STORE)
