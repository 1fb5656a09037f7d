"""Host ms a block from the launch of each repair dispatch's kernel to its
end, as the host waits on it: the program's stage `kernels` over the
verify's decodes and the rebuilds, per block whose content the round
hashed."""

from perfbench.stages import REPAIR, STORE, ms_per_block


def read(run):
    return ms_per_block(run, "kernels", REPAIR, "verify_hash", STORE)
