"""The reference's daemon tests on the port, through `port_mirror`:

  - tests/test_daemon_smoke.py (3): real daemons, `python -m
    garage_tpu_torch.cli server` processes on localhost, configured with
    the port's CLI and driven with its S3 client.  Their TOML files ask
    for the CPU (`[tpu] enable = false`, appended by
    `torch_mirror.toml_on_cpu` to what the file's `write_config` writes):
    without it a port daemon exits where CUDA is absent, as it should;
  - tests/test_meta_acceptance.py (1): EC(8,3) metadata quorums over 3
    nodes with the block fan-out over 11.

All four keep their `slow` mark, as on the reference: run them with
`python -m pytest -m slow tests/test_torch_daemon_mirror.py`.  No test is
left out."""

import torch

from torch_mirror import (assert_mirror_whole, mirrored_tests, port_mirror, refusing_skips,
                          time_limit)

torch.set_num_threads(1)  # one thread per suite worker

_limit = time_limit(400)  # a stuck test ends its worker instead of the suite

MIRRORS = {  # reference file -> (prefix, its test count)
    "test_daemon_smoke.py": ("daemon_smoke", 3),
    "test_meta_acceptance.py": ("meta_acceptance", 1),
}
mirrors = {ref: port_mirror(ref) for ref in MIRRORS}
for ref, (prefix, _n) in MIRRORS.items():
    globals().update(refusing_skips(mirrored_tests(mirrors[ref], prefix)))


def test_mirrors_hold_every_reference_scenario():
    for ref, (_prefix, n) in MIRRORS.items():
        assert_mirror_whole(ref, mirrors[ref], (), n)
