from .data import (
    FixedBytes32,
    Hash,
    Uuid,
    blake2sum,
    gen_uuid,
    hex_of,
    parse_hex,
    sha256sum,
)
from .error import Error, OkOrMessage
from .time_util import increment_logical_clock, msec_to_rfc3339, now_msec

__all__ = [
    "FixedBytes32",
    "Hash",
    "Uuid",
    "blake2sum",
    "gen_uuid",
    "hex_of",
    "parse_hex",
    "sha256sum",
    "Error",
    "OkOrMessage",
    "now_msec",
    "increment_logical_clock",
    "msec_to_rfc3339",
]
