"""garage_tpu_torch `ScrubRepairPipeline` on the CPU against the JAX
package's `pipeline.jitted()`: parity, hashes and scrub statistics,
bit-exact, with and without `nvalid` masking."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garage_tpu.models.pipeline import ScrubRepairPipeline as JaxPipeline
from garage_tpu_torch.models.pipeline import ScrubRepairPipeline

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)


def _run_both(k, m, s, data, nvalid=None):
    jp = JaxPipeline(k, m, s)
    if nvalid is None:
        jout = jp.jitted()(data)
    else:
        jout = jax.jit(jp.encode_and_hash_fn())(data, jnp.uint32(nvalid))
    tout = ScrubRepairPipeline(k, m, s, device="cpu").encode_and_hash_fn()(
        torch.from_numpy(data), nvalid
    )
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


@pytest.mark.parametrize("k,m,s,b", [(8, 3, 1024, 4), (4, 2, 2048, 3)])
def test_pipeline_matches_reference(k, m, s, b):
    data = JaxPipeline(k, m, s).example_batch(b, seed=1)
    assert np.array_equal(data, ScrubRepairPipeline(k, m, s, device="cpu").example_batch(b, seed=1))
    (jpar, jh, jst), (tpar, th, tst) = _run_both(k, m, s, data)
    assert np.array_equal(tpar, jpar)
    assert np.array_equal(th, jh)
    assert tst.tolist() == [int(v) for v in jst]


def test_pipeline_nvalid_masks_pad_blocks():
    k, m, s = 8, 3, 1024
    data = JaxPipeline(k, m, s).example_batch(4, seed=2)
    data[3] = 0  # a zero pad block
    (jpar, jh, jst), (tpar, th, tst) = _run_both(k, m, s, data, nvalid=3)
    assert np.array_equal(tpar, jpar) and np.array_equal(th, jh)
    assert tst.tolist() == [int(v) for v in jst]
    # the masked stats are those of the three real blocks alone
    (_p, _h, only3), _ = _run_both(k, m, s, data[:3])
    assert tst.tolist() == [int(v) for v in only3]


@pytest.mark.parametrize("shard_bytes", [1000, 3 * 1024])
def test_pipeline_rejects_unsupported_shard_size(shard_bytes):
    with pytest.raises(ValueError):
        ScrubRepairPipeline(8, 3, shard_bytes, device="cpu")


def test_pipeline_rejects_wrong_batch_shape():
    fwd = ScrubRepairPipeline(4, 2, 1024, device="cpu").encode_and_hash_fn()
    with pytest.raises(ValueError):
        fwd(torch.zeros((2, 3, 1024), dtype=torch.uint8))
