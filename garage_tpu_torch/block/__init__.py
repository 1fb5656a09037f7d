"""Content-addressed block store.

Objects are chunked into blocks (1 MiB default) identified by the BLAKE2
hash of their plaintext.  Blocks live as files under the data directories,
optionally zstd-compressed, replicated or erasure-coded to the nodes the
layout assigns to the block hash.

  codec/          BlockCodec seam: ReplicaCodec (whole copies) and EcCodec
                  (GF(2^8) Reed-Solomon shards, batched on the card)
  codec_batch.py  CodecBatcher: cross-request coalescing of encodes and
                  degraded-read decodes
  layout          multi-drive data layout (1024 sub-partitions ∝ capacity)
  rc              transactional per-block reference counts
  read_cache      per-node hot-block cache of the EC read path
  manager         the BlockManager: local files + Get/Put/Need RPCs + quorum
  resync          persistent retry queue: fetch missing / offload unneeded
  repair          scrub (verify all blocks, piece hashes through kernel K2),
                  full repair, drive rebalance
  repair_plan     the batched-reconstruction planner
"""

from .manager import BlockManager

__all__ = ["BlockManager"]
