"""Block layer of the erasure-coded data plane.

  codec/          BlockCodec seam: ReplicaCodec (whole copies) and EcCodec
                  (GF(2^8) Reed-Solomon shards, batched on the card)
  codec_batch.py  CodecBatcher: cross-request coalescing of encodes and
                  degraded-read decodes

The block manager, resync and repair workers are not ported yet.
"""
