"""garage_tpu_torch — garage-tpu's erasure-coded data plane, and the S3
serving path, block store and cluster plane around it, on PyTorch and
CUDA (NVIDIA Hopper, sm_90a).

The `ec:k:m` block mode splits each block into k data shards, computes m
GF(2^8) Cauchy parity shards, and BLAKE3-hashes every one of the k+m
pieces; degraded reads and repair rebuild missing pieces with the same
coding math and a reconstruction matrix.  This package runs that path on
the card through two hand-written kernels:

  csrc/gf_bitplane.cu   GF(2^8) matrix x shards (encode and every repair
                        pattern; the matrix is a device argument)
  csrc/blake3.cu        batched BLAKE3-256 of equal-length rows

each with a plain PyTorch version beside it (ops/ec_cuda.py,
ops/hash_cuda.py) that runs for CPU tensors and is the yardstick the
kernels are held to.

Layer map (module paths mirror `garage_tpu/`, so each counterpart is
found under the same name):
  api/s3/, api/common/  the S3 API: S3ApiServer, SigV4, objects (the
                        pipelined PUT, the streamed GET), multipart,
                        listing, SSE-C, S3Client, the canary prober;
                        api/overload.py (admission)
  model/                Garage — the composition root (a node: tables,
                        block store, workers; `[tpu]` picks the codec's
                        device); the object, version, block_ref, mpu,
                        bucket, key and K2V tables
  table/                the replicated CRDT table engine: quorum reads and
                        writes, Merkle anti-entropy, tombstone GC,
                        coalesced inserts
  block/manager.py      BlockManager — piece placement, quorum PUT, the EC
                        read pipeline, bulk repair; block/resync.py,
                        block/repair.py (scrub: piece hashes through K2),
                        block/repair_plan.py (the batched repair planner)
  rpc/, net/, db/       cluster layout, peering, quorum RPC, discovery,
                        the shedding ladder; the encrypted
                        TCP mesh (the reference's wire protocol); the
                        metadata db (memory, sqlite, log, native — the
                        last two share one write-ahead log format)
  _native/              host BLAKE3 (single pieces) and the native
                        metadata engine (kvlog.cpp, bound by kvpy.cpp) in
                        C++, built by g++
  block/codec_batch.py  CodecBatcher — coalesces concurrent encodes and
                        degraded-read decodes into one dispatch
  block/codec/          EcCodec — bytes <-> (B, k, S) shard batches
  models/pipeline.py    ScrubRepairPipeline — encode + hash + scrub stats,
                        on one device or sharded over a mesh
  ops/ec_cuda.py        EcCuda, the K1 wrapper and its plain version, and
                        the fan-out of K1 over a mesh (K6)
  parallel/mesh.py      Mesh — device entries, one stream each, over which
                        large batches are split
  graft_entry.py        entry() / dryrun_multichip(n)
  ops/hash_cuda.py      the K2 wrapper and its plain version
  ops/_build.py         nvcc build of csrc/ at first use, ctypes binding
  ops/gf.py, ops/blake3_ref.py  numpy / pure-Python oracles
  utils/                serde, CRDTs, config, workers, tracing, metrics
  analysis/             graft-lint, the static-analysis plane: async
                        hazards, invariants, and the torch/CUDA device
                        boundary (`python -m garage_tpu_torch.analysis`)
  tools/                kernel timing on the card (CUDA events, graph
                        replay), the K1 variant comparison, and
                        in-process clusters of block-store nodes and of
                        whole S3 nodes

Import rule: this package imports `torch` and `numpy` and never `jax`,
and it imports nothing from `garage_tpu` — not even its JAX-free
modules.  What it needs from them it keeps as its own copy.  Only the
tests import both packages, to hold one against the other.

Device rule: entry points take an explicit `device` that defaults to
"cuda" and raise when CUDA is absent; the CPU runs only when a caller
asks for it (`device="cpu"`; for a node's `Garage`, `[tpu] enable =
false`), and then through the plain versions.
"""

__version__ = "0.1.0"

# The zlib-backed `zstandard` stand-in (utils/depcompat.py) must be in
# place before any submodule import pulls the real name.
from .utils import depcompat as _depcompat  # noqa: E402,F401
