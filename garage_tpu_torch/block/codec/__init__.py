from .base import BlockCodec
from .replica import ReplicaCodec

__all__ = ["BlockCodec", "ReplicaCodec", "get_codec"]


def get_codec(ec_params=None, device="cuda") -> BlockCodec:
    """ReplicaCodec for replication modes; EcCodec(k, m) on `device` for
    `ec_params = (k, m)`."""
    if ec_params is None:
        return ReplicaCodec()
    from .ec import EcCodec

    k, m = ec_params
    return EcCodec(k, m, device=device)
