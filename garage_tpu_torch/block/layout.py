"""Multi-drive data layout (reference src/block/layout.rs:13-120).

Blocks are mapped to drives by 1024 sub-partitions (top 10 bits of the
block hash) allocated to data directories proportionally to their
configured capacity.  The layout is persisted; after a drive change, a
new layout is computed that minimizes moved sub-partitions, keeping the
old location as `secondary` so reads keep working while the rebalance
worker moves files.  A marker file per drive detects unmounted drives.
"""

from __future__ import annotations

import logging
import os
from typing import Any

from ..utils.config import DataDir
from ..utils.migrate import Migratable

logger = logging.getLogger("garage.block.layout")

DRIVE_NPART = 1024  # 2^10 sub-partitions
MARKER = ".garage-marker"


class DataLayout(Migratable):
    VERSION_MARKER = b"GT0datalayout"

    def __init__(
        self,
        dirs: list[str],
        primary: list[int],
        secondary: list[list[int]],
    ):
        self.dirs = dirs  # directory paths
        self.primary = primary  # sub-partition -> dir index
        self.secondary = secondary  # sub-partition -> old dir indexes

    # --- queries -------------------------------------------------------------

    @staticmethod
    def subpart_of(hash32: bytes) -> int:
        return ((hash32[0] << 8) | hash32[1]) >> 6  # top 10 bits

    def primary_dir(self, hash32: bytes) -> str:
        return self.dirs[self.primary[self.subpart_of(hash32)]]

    def all_dirs(self, hash32: bytes) -> list[str]:
        sp = self.subpart_of(hash32)
        idxs = [self.primary[sp]] + list(self.secondary[sp])
        return [self.dirs[i] for i in idxs if 0 <= i < len(self.dirs)]

    def block_dir(self, base: str, hash32: bytes) -> str:
        """Two-level fan-out dir for a hash (reference block.rs)."""
        h = hash32.hex()
        return os.path.join(base, h[:2], h[2:4])

    # --- construction --------------------------------------------------------

    @classmethod
    def initial(cls, data_dirs: list[DataDir]) -> "DataLayout":
        usable = [d for d in data_dirs if not d.read_only]
        if not usable:
            raise ValueError("no writable data directories")
        dirs = [d.path for d in data_dirs]
        caps = [
            (d.capacity if d.capacity is not None else 1) if not d.read_only else 0
            for d in data_dirs
        ]
        primary = _allocate(caps, DRIVE_NPART)
        return cls(dirs, primary, [[] for _ in range(DRIVE_NPART)])

    def update(self, data_dirs: list[DataDir]) -> "DataLayout":
        """Recompute for a changed drive set, minimizing moves; previous
        primaries become secondaries of moved sub-partitions."""
        new_dirs = [d.path for d in data_dirs]
        caps = [
            (d.capacity if d.capacity is not None else 1) if not d.read_only else 0
            for d in data_dirs
        ]
        old_index = {p: i for i, p in enumerate(self.dirs)}
        # start from current placement translated to new dir indexes
        target_counts = _allocate_counts(caps, DRIVE_NPART)
        counts = [0] * len(new_dirs)
        primary = [-1] * DRIVE_NPART
        # keep sub-partitions where they are if the drive still exists and
        # has remaining quota
        for sp in range(DRIVE_NPART):
            old_path = self.dirs[self.primary[sp]]
            ni = new_dirs.index(old_path) if old_path in new_dirs else -1
            if ni >= 0 and counts[ni] < target_counts[ni]:
                primary[sp] = ni
                counts[ni] += 1
        for sp in range(DRIVE_NPART):
            if primary[sp] < 0:
                ni = max(
                    range(len(new_dirs)),
                    key=lambda i: target_counts[i] - counts[i],
                )
                primary[sp] = ni
                counts[ni] += 1
        secondary: list[list[int]] = []
        for sp in range(DRIVE_NPART):
            old_path = self.dirs[self.primary[sp]]
            secs = []
            if old_path in new_dirs and new_dirs.index(old_path) != primary[sp]:
                secs.append(new_dirs.index(old_path))
            # carry over still-valid old secondaries
            for osi in self.secondary[sp]:
                if 0 <= osi < len(self.dirs) and self.dirs[osi] in new_dirs:
                    nsi = new_dirs.index(self.dirs[osi])
                    if nsi != primary[sp] and nsi not in secs:
                        secs.append(nsi)
            secondary.append(secs)
        return DataLayout(new_dirs, primary, secondary)

    def ensure_markers(self) -> None:
        """Write marker files; a missing marker on an existing dir means
        the drive is not mounted -> refuse to run (reference layout.rs)."""
        for p in self.dirs:
            os.makedirs(p, exist_ok=True)
            marker = os.path.join(p, MARKER)
            if not os.path.exists(marker):
                with open(marker, "w") as f:
                    f.write("garage-tpu data dir\n")

    def check_markers(self) -> None:
        for p in self.dirs:
            if os.path.isdir(p) and not os.path.exists(os.path.join(p, MARKER)):
                raise RuntimeError(
                    f"data dir {p} exists but has no marker file; is the "
                    "drive mounted?"
                )

    # --- serde ---------------------------------------------------------------

    def to_obj(self) -> Any:
        return {
            "dirs": self.dirs,
            "primary": self.primary,
            "secondary": self.secondary,
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "DataLayout":
        return cls(list(obj["dirs"]), list(obj["primary"]), [list(s) for s in obj["secondary"]])


def _allocate_counts(caps: list[int], total: int) -> list[int]:
    capsum = sum(caps)
    if capsum == 0:
        raise ValueError("no usable drive capacity")
    counts = [c * total // capsum for c in caps]
    rem = total - sum(counts)
    order = sorted(
        range(len(caps)),
        key=lambda i: -(caps[i] * total % capsum),
    )
    for i in order[:rem]:
        counts[i] += 1
    return counts


def _allocate(caps: list[int], total: int) -> list[int]:
    counts = _allocate_counts(caps, total)
    out = []
    for i, c in enumerate(counts):
        out.extend([i] * c)
    return out
