"""garage_tpu_torch — the erasure-coded data plane of garage-tpu on PyTorch
and CUDA (NVIDIA Hopper, sm_90a).

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
  block/codec_batch.py  CodecBatcher — coalesces concurrent encodes and
                        degraded-read decodes into one dispatch
  block/codec/          EcCodec — bytes <-> (B, k, S) shard batches
  models/pipeline.py    ScrubRepairPipeline — encode + hash + scrub stats
  ops/ec_cuda.py        EcCuda, the K1 wrapper and its plain version
  ops/hash_cuda.py      the K2 wrapper and its plain version
  ops/_build.py         nvcc build of csrc/ at first use, ctypes binding
  ops/gf.py, ops/blake3_ref.py  numpy / pure-Python oracles
  utils/                the small host helpers the layers above call
  tools/                kernel timing on the card (CUDA events, graph
                        replay) and the K1 variant comparison

Import rule: this package imports `torch` and `numpy` and never `jax`,
and it imports nothing from `garage_tpu` — not even its JAX-free
modules.  What it needs from them it keeps as its own copy.  Only the
tests import both packages, to hold one against the other.

Device rule: entry points take an explicit `device` that defaults to
"cuda" and raise when CUDA is absent; the CPU runs only when a caller
asks for it (`device="cpu"`), and then through the plain versions.
"""

__version__ = "0.1.0"
