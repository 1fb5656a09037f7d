"""Global bucket aliases: name -> bucket id (full-copy;
reference src/model/bucket_alias_table.rs)."""

from __future__ import annotations

from typing import Any

from ..table.schema import TableSchema
from ..utils.crdt import Lww


class BucketAlias:
    def __init__(self, name: str, state: Lww):
        self.name = name
        self.state = state  # Lww[bucket_id bytes | None]

    @classmethod
    def new(cls, name: str, bucket_id: bytes | None) -> "BucketAlias":
        # syntax-only sanity check; the punycode POLICY gate lives in the
        # helper/admin layers (reference BucketAlias::new doesn't validate)
        if not valid_bucket_name(name, allow_punycode=True):
            raise ValueError(f"invalid bucket name {name!r}")
        return cls(name, Lww(bucket_id))

    def merge(self, other: "BucketAlias") -> None:
        self.state.merge(other.state)

    def to_obj(self) -> Any:
        return [self.name, self.state.to_obj()]


class BucketAliasTable(TableSchema):
    table_name = "bucket_alias"

    def entry_partition_key(self, e: BucketAlias) -> bytes:
        return e.name.encode()

    def entry_sort_key(self, e: BucketAlias) -> bytes:
        return b""

    def decode_entry(self, obj: Any) -> BucketAlias:
        v = Lww.from_obj(obj[1])
        if v.value is not None:
            v.value = bytes(v.value)
        return BucketAlias(obj[0], v)


def valid_bucket_name(name: str, allow_punycode: bool = False) -> bool:
    """AWS-compatible bucket naming (reference bucket_alias_table.rs:79-96):
    3-63 chars of [a-z0-9.-], no leading/trailing separator, not an IP
    address, no punycode labels unless `allow_punycode` (config knob), and
    never the reserved "-s3alias" suffix."""
    import ipaddress

    # ASCII-only, like the reference's 'a'..='z' | '0'..='9' ranges —
    # str.islower()/isdigit() accept Unicode (e.g. 'é', '¹'), which would
    # let raw-Unicode homographs bypass the punycode gate below
    if not (
        3 <= len(name) <= 63
        and all("a" <= c <= "z" or "0" <= c <= "9" or c in ".-" for c in name)
        and name[0] not in ".-"
        and name[-1] not in ".-"
        and ".." not in name
    ):
        return False
    try:
        ipaddress.ip_address(name)
        return False  # bucket names must not be formatted as an IP address
    except ValueError:
        pass
    if (name.startswith("xn--") or ".xn--" in name) and not allow_punycode:
        return False
    return not name.endswith("-s3alias")
